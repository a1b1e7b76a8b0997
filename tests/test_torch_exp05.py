"""PyTorch port: exp05, the less-data ablation
(``conditional_ude_tpu_torch/ablation.py``), against the JAX experiment
script ``experiments/exp05_less_data.py``.

* The subsets: the port draws the same subjects as JAX's sequence of
  ``stratified_split`` calls, seed by seed and fraction by fraction, exactly.
* One fraction in two halves, from a shared start, against JAX's
  ``_run_fraction`` at its ``--smoke`` size (100 designs, 2 restarts, 20 Adam
  and 20 L-BFGS steps; 50 L-BFGS steps in selection, 100 in the refit) at
  fractions 0.2 (16 subjects, 66 held out) and 1.0 (all 82, none held out):
  the port's ``train_fraction`` fed JAX's designs at
  ``tests/test_torch_train.py``'s tolerances (screen rtol 1e-5, Adam's
  losses rtol 1e-4, final objectives rtol 5e-2), and its
  ``select_and_refit`` from JAX's trained candidates with the same selected
  restart and cohort size, the row's SSE statistics at the refit's SSE
  tolerance (rtol 1e-2: ``tests/test_torch_frozen.py``'s σ rtol 5e-3
  twice) and the same outlier counts.
* The aggregation reproduces the committed ``results/exp05_metrics.json``
  from the committed ``results/exp05_ablation.csv`` exactly; a fraction
  with no finite value gives ``null`` statistics and ``n_seeds`` 0.
"""

import csv
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.data import ohashi as johashi
from conditional_ude_tpu.fit import train as jtrain
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.utils.stats import stratified_split as jax_split
from conditional_ude_tpu_torch import __main__ as cli
from conditional_ude_tpu_torch import ablation
from conditional_ude_tpu_torch.data.ohashi import load_npz
from conditional_ude_tpu_torch.fit import train as ptrain

REPO = Path(__file__).resolve().parent.parent
SEED = 270523
SMOKE = dict(initial_guesses=100, selected_initials=2, adam_iters=20,
             lbfgs_iters=20)
SELECT_ITERS, REFIT_ITERS = 50, 100     # the JAX script's --smoke counts
COHORTS = [8, 16, 25, 33, 41, 49, 57, 66, 74, 82]
STATS = ("test_sse_mean", "test_sse_mean_inliers", "test_sse_median")


def test_subsets_are_jax_draws_in_fraction_order():
    train, _ = load_npz(REPO / "artifacts" / "ohashi.npz")
    for seed in range(SEED, SEED + 5):
        drawn = ablation.subsets(train.types, seed)
        assert list(drawn) == list(ablation.FRACTIONS)
        rng = np.random.default_rng(seed)
        for frac, (idx, held) in drawn.items():
            if frac < 1.0:
                want, want_held = jax_split(rng, train.types, frac)
                np.testing.assert_array_equal(idx, want)
                np.testing.assert_array_equal(held, want_held)
            else:
                np.testing.assert_array_equal(idx, np.arange(82))
                assert held.size == 0
        assert [len(idx) for idx, _ in drawn.values()] == COHORTS
    # another order draws other subjects from the second fraction on
    rng = np.random.default_rng(SEED)
    assert not np.array_equal(jax_split(rng, train.types, 0.2)[0],
                              ablation.subsets(train.types, SEED)[0.2][0])


@pytest.fixture(scope="module")
def jax_fractions():
    """JAX's ``_run_fraction`` at 0.2 (its generator past the 0.1 draw, as
    in the sweep) and at 1.0, with each trained result captured."""
    sys.path.insert(0, str(REPO / "experiments"))
    try:
        import exp05_less_data
    finally:
        sys.path.pop(0)
    train, test = johashi.load_npz(REPO / "artifacts" / "ohashi.npz")
    cohort_test = jcp.build_cohort(test.glucose, test.timepoints,
                                   test.cpeptide, test.ages, test.t2dm)
    model = jcp.CPeptideModel(kind="conditional",
                              net=jax_chain(4, 2, "tanh", input_dims=2))
    cfg = jtrain.TrainConfig(**SMOKE)
    trained = []

    def recording(*args, **kwargs):
        trained.append(train_conditional(*args, **kwargs))
        return trained[-1]

    train_conditional = jtrain.train_conditional
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "train_conditional", recording)
        for frac in (0.2, 1.0):
            rng = np.random.default_rng(SEED)
            jax_split(rng, train.types, 0.1)
            row = exp05_less_data._run_fraction(
                SimpleNamespace(smoke=True), frac, SEED, 0, rng, train, test,
                cohort_test, model, cfg)
            designs = jtrain.initial_designs(model.net, row["n_train"],
                                             jax.random.key(SEED), cfg)
            out[frac] = (row, trained[-1], designs)
    return out


@pytest.mark.parametrize("frac", [0.2, 1.0])
def test_training_half_matches_jax(jax_fractions, frac):
    _, ref, designs = jax_fractions[frac]
    train, _ = load_npz(REPO / "artifacts" / "ohashi.npz")
    idx, _ = ablation.subsets(train.types, SEED)[frac]
    port = ablation.train_fraction("cpu", train, idx, SEED,
                                   ptrain.TrainConfig(**SMOKE),
                                   designs=designs)
    assert port.betas.shape == (2, len(idx), 1)
    np.testing.assert_allclose(port.screen_losses.numpy(),
                               np.asarray(ref.screen_losses), rtol=1e-5)
    np.testing.assert_allclose(port.loss_traces.numpy(),
                               np.asarray(ref.loss_traces), rtol=1e-4)
    np.testing.assert_allclose(port.objectives.numpy(),
                               np.asarray(ref.objectives), rtol=5e-2)
    np.testing.assert_array_equal(port.orientations.numpy(),
                                  np.asarray(ref.orientations))


@pytest.mark.parametrize("frac", [0.2, 1.0])
def test_select_and_refit_half_matches_jax(jax_fractions, frac):
    want, ref, _ = jax_fractions[frac]
    train, test = load_npz(REPO / "artifacts" / "ohashi.npz")
    _, held = ablation.subsets(train.types, SEED)[frac]
    given = ptrain.TrainResult(
        **{k: torch.as_tensor(np.array(getattr(ref, k)))
           for k in ("nn_params", "betas", "objectives", "screen_losses",
                     "loss_traces", "orientations")})
    row = ablation.select_and_refit(given, train, held, test, seed_i=0,
                                    fraction=frac, select_iters=SELECT_ITERS,
                                    refit_iters=REFIT_ITERS)
    assert list(row) == [k for k in want if k != "seconds"]
    for key in ("seed", "fraction", "n_train", "selected_restart",
                "train_objective", "n_outliers", "n_nonfinite"):
        assert row[key] == want[key], key
    if frac == 1.0:
        assert row["selected_restart"] == 0
    for key in STATS:
        np.testing.assert_allclose(row[key], want[key], rtol=1e-2)


def _committed_rows():
    ints = ("seed", "n_train", "selected_restart", "n_outliers",
            "n_nonfinite")
    with (REPO / "results" / "exp05_ablation.csv").open() as f:
        return [{k: int(v) if k in ints else float(v) for k, v in r.items()}
                for r in csv.DictReader(f)]


def test_aggregate_reproduces_the_committed_metrics():
    rows = _committed_rows()
    assert len(rows) == 50
    got = ablation.aggregate_ablation(rows, ablation.FRACTIONS)
    want = json.loads((REPO / "results" / "exp05_metrics.json").read_text())
    assert got == want


def test_a_fraction_with_no_finite_value_gives_null(tmp_path):
    rows = [r for r in _committed_rows() if r["fraction"] in (0.1, 0.2)]
    for r in rows:
        if r["fraction"] == 0.1:
            r.update(test_sse_mean=float("nan"), test_sse_median=float("inf"),
                     test_sse_mean_inliers=float("nan"))
    metrics = ablation.write_ablation(tmp_path, rows, (0.1, 0.2))
    for name, _ in ablation.ACROSS:
        assert metrics[name]["0.1"] == {"median": None, "iqr_lo": None,
                                        "iqr_hi": None, "mean": None,
                                        "n_seeds": 0}
        assert metrics[name]["0.2"]["n_seeds"] == 5
    assert json.loads((tmp_path / "exp05_metrics.json").read_text()) \
        == metrics
    assert "NaN" not in (tmp_path / "exp05_metrics.json").read_text()


def test_run_ablation_draws_each_seed_in_order(monkeypatch):
    """Ablation seed i trains on ``subsets(types, seed + i)``'s subset with
    ``seed + i``; the rows come in (seed, fraction) order."""
    calls = []

    def train_fraction(device, train, idx, seed, config):
        calls.append((seed, idx))
        return SimpleNamespace(n=len(idx), timings={})

    def select_and_refit(trained, train, held, test, *, seed_i, fraction):
        return {"seed": seed_i, "fraction": fraction, "n_train": trained.n,
                "held": len(held)}

    monkeypatch.setattr(ablation, "train_fraction", train_fraction)
    monkeypatch.setattr(ablation, "select_and_refit", select_and_refit)
    rows = ablation.run_ablation("cpu", REPO / "artifacts", 7, n_seeds=2,
                                 fractions=(0.3, 1.0))
    train, _ = load_npz(REPO / "artifacts" / "ohashi.npz")
    assert [(r["seed"], r["fraction"], r["n_train"], r["held"])
            for r in rows] == [(0, 0.3, 25, 57), (0, 1.0, 82, 0),
                               (1, 0.3, 25, 57), (1, 1.0, 82, 0)]
    assert [s for s, _ in calls] == [7, 7, 8, 8]
    np.testing.assert_array_equal(calls[2][1],
                                  ablation.subsets(train.types, 8)[0.3][0])
    assert all(r["seconds"] >= 0 for r in rows)


def test_cli_writes_the_ablation_to_out(monkeypatch, tmp_path, capsys):
    rows = _committed_rows()
    seen = {}

    def run_ablation(device, artifacts, seed, n_seeds):
        seen.update(device=device, seed=seed, n_seeds=n_seeds)
        return rows

    monkeypatch.setattr(ablation, "run_ablation", run_ablation)
    cli.main(["--experiment", "exp05", "--device", "cpu", "--seed", "5",
              "--ablation-seeds", "3", "--out", str(tmp_path)])
    assert seen == {"device": "cpu", "seed": 5, "n_seeds": 3}
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(
        (REPO / "results" / "exp05_metrics.json").read_text())
    assert (tmp_path / "exp05_ablation.csv").read_text() \
        .splitlines()[0] == (REPO / "results" / "exp05_ablation.csv") \
        .read_text().splitlines()[0]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            cli.main(["--experiment", "exp05", "--out", str(tmp_path)])
