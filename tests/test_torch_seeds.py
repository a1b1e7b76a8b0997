"""PyTorch port: exp02_seeds (``conditional_ude_tpu_torch/seeds.py``) and the
replication runner (``conditional_ude_tpu_torch/replicate.py``) against the
JAX experiment scripts ``experiments/exp02_seeds.py`` and
``experiments/exp_replicate.py``.

* The merge: JAX's ``merge`` and the port's ``merge_seeds`` on copies of the
  five committed per-seed records give the same JSON and the same CSV,
  exactly.  The committed ``results/exp02_seeds_metrics.json`` is stale and
  is not compared.
* One seed at JAX's ``--smoke`` size (8 training and 8 test subjects, 200
  designs, 4 restarts, 25 Adam and 25 L-BFGS steps; 50 L-BFGS steps in
  selection, 100 in the refit): JAX's ``run_seed`` reads
  ``artifacts/ohashi.npz`` (the test replaces the CSV reader) and exp01's
  committed UDE.  The port's training, fed JAX's designs, is held at
  ``tests/test_torch_train.py``'s tolerances (screen rtol 1e-5, Adam's
  losses rtol 1e-4, final objectives rtol 5e-2); the port's pipeline,
  given JAX's trained candidates, at ``tests/test_torch_frozen.py``'s
  (objective rtol 1e-4, β atol 2e-3, σ rtol 5e-3; the SSE, which carries σ
  twice, rtol 1e-2), with the same selected candidate, and its
  ``ude_vs_cude`` at ``tests/test_torch_exp02_outputs.py``'s (the UDE's
  Tsit5 MSE rtol 1e-3).
* The replication runner: ``flatten`` equal to JAX's on every committed
  metrics file, the committed ``replicate_exp06_saem.json``'s aggregate
  reproduced exactly from its per-seed metrics, and two seeds of exp01 run
  end to end in child processes on the CPU.
"""

import csv
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.data import ohashi as johashi
from conditional_ude_tpu.fit import train as jtrain
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu_torch import __main__ as cli
from conditional_ude_tpu_torch import pipeline, replicate, seeds
from conditional_ude_tpu_torch.data.ohashi import load_npz
from conditional_ude_tpu_torch.fit import train as ptrain
from conditional_ude_tpu_torch.models.cpeptide import build_cohort
from conditional_ude_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from conditional_ude_tpu_torch.utils.stats import stratified_split

REPO = Path(__file__).resolve().parent.parent
SEED, SMOKE_N = 11, 8
SMOKE = dict(initial_guesses=200, selected_initials=4, adam_iters=25,
             lbfgs_iters=25)
SELECT_ITERS, REFIT_ITERS = 50, 100     # the JAX script's --smoke counts


def _experiments():
    """The JAX experiment scripts' modules (they import ``common``)."""
    sys.path.insert(0, str(REPO / "experiments"))
    try:
        import common
        import exp02_seeds
        import exp_replicate
    finally:
        sys.path.pop(0)
    return common, exp02_seeds, exp_replicate


def _snapshot():
    return sorted((str(p), p.stat().st_mtime_ns)
                  for d in ("artifacts", "results")
                  for p in (REPO / d).rglob("*"))


def test_merge_matches_jax(tmp_path):
    _, exp02_seeds, _ = _experiments()
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        for s in seeds.DEFAULT_SEEDS:
            shutil.copy(REPO / "results" / f"exp02_seed_{s}.json",
                        tmp_path / side)
    exp02_seeds.merge(type("Args", (), {"results": tmp_path / "jax"}))
    summary = seeds.merge_directory(tmp_path / "port")
    want = json.loads((tmp_path / "jax"
                       / "exp02_seeds_metrics.json").read_text())
    got = json.loads((tmp_path / "port"
                      / "exp02_seeds_metrics.json").read_text())
    assert got == want == json.loads(json.dumps(summary))
    assert summary["n_seeds"] == 5
    assert summary["beta_orientations"] == [1.0] * 5
    assert len(summary) == 3 + len(seeds.AGGREGATED)
    rows = [list(csv.reader((tmp_path / side / "exp02_seeds.csv").open()))
            for side in ("jax", "port")]
    assert rows[0] == rows[1] and len(rows[1]) == 6


def test_merge_of_one_seed_and_of_a_flipped_gauge():
    """One seed has sd 0.0; a record whose first-phase ρ is positive is
    flipped in ``spearman_aligned``, and a record without ``ude_vs_cude``
    leaves its CSV cell empty."""
    rec = json.loads((REPO / "results" / "exp02_seed_22.json").read_text())
    summary, table = seeds.merge_seeds([rec])
    assert summary["test_sse_mean"] == {"mean": rec["test_sse_mean"],
                                        "sd": 0.0,
                                        "min": rec["test_sse_mean"],
                                        "max": rec["test_sse_mean"]}
    flipped = dict(rec, seed=23, ude_vs_cude=None, spearman={
        k: -v for k, v in rec["spearman"].items()})
    summary, table = seeds.merge_seeds([rec, flipped])
    assert summary["beta_orientations"] == [1.0, -1.0]
    assert summary["spearman_aligned.first_phase"]["sd"] == 0.0
    assert summary["ude_vs_cude.cude_better_fraction"]["sd"] == 0.0
    assert table[1]["cude_better_fraction"] == ""


def test_cli_merge_writes_to_out_only(tmp_path, capsys):
    for s in (33, 11):
        shutil.copy(REPO / "results" / f"exp02_seed_{s}.json", tmp_path)
    before = _snapshot()
    cli.main(["--experiment", "exp02_seeds", "--merge", "--out",
              str(tmp_path)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["seeds"] == [11, 33]
    assert json.loads((tmp_path / "exp02_seeds_metrics.json").read_text()) \
        == printed
    with pytest.raises(SystemExit):
        cli.main(["--experiment", "exp02_seeds", "--merge", "--out",
                  str(tmp_path / "empty")])
    with pytest.raises(SystemExit):
        cli.main(["--experiment", "exp02_seeds", "--merge", "--out",
                  "results/port"])
    assert _snapshot() == before


@pytest.fixture(scope="module")
def smoke_seed(tmp_path_factory):
    """JAX's ``run_seed`` at ``--smoke`` size, with its trained result and
    its pipeline namespace captured."""
    common, exp02_seeds, _ = _experiments()
    art = tmp_path_factory.mktemp("artifacts")
    shutil.copy(REPO / "artifacts" / "ude_neural_parameters.npz", art)
    captured = {}

    def load_cohorts(data_dir, smoke=False, max_smoke=SMOKE_N):
        train, test = johashi.load_npz(REPO / "artifacts" / "ohashi.npz")
        if smoke:
            train = train.subset(np.arange(max_smoke))
            test = test.subset(np.arange(max_smoke))

        def cohort(s):
            return jcp.build_cohort(s.glucose, s.timepoints, s.cpeptide,
                                    s.ages, s.t2dm)
        return train, test, cohort(train), cohort(test)

    def recording(fn, name):
        def wrapper(*args, **kwargs):
            captured[name] = fn(*args, **kwargs)
            return captured[name]
        return wrapper

    args = common.make_parser("").parse_args(
        ["--smoke", "--artifacts", str(art), "--results", str(art)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "load_cohorts", load_cohorts)
        mp.setattr(jtrain, "train_conditional",
                   recording(jtrain.train_conditional, "trained"))
        mp.setattr(exp02_seeds, "run_conditional_pipeline",
                   recording(exp02_seeds.run_conditional_pipeline,
                             "pipeline"))
        record = exp02_seeds.run_seed(args, SEED)
    captured["record"] = record
    captured["checkpoint"] = (art / "seeds"
                              / f"cude_neural_parameters_{SEED}.npz")
    return captured


def _smoke_splits():
    return tuple(s.subset(np.arange(SMOKE_N))
                 for s in load_npz(REPO / "artifacts" / "ohashi.npz"))


def test_training_matches_jax_from_its_designs(smoke_seed):
    """The seed's fit split and JAX's designs (its ``initial_designs`` of
    the seed's key, the LHS from the key's bits) through the port's
    ``train_conditional``."""
    train, _ = _smoke_splits()
    idx_fit, _ = stratified_split(np.random.default_rng(SEED), train.types,
                                  0.7)
    np.testing.assert_array_equal(idx_fit,
                                  smoke_seed["pipeline"].idx_fit)
    jcfg = jtrain.TrainConfig(**SMOKE)
    designs = jtrain.initial_designs(smoke_seed["pipeline"].net, len(idx_fit),
                                     jax.random.key(SEED), jcfg)
    fit = train.subset(idx_fit)
    port = ptrain.train_conditional(
        pipeline.EXP02.model(),
        build_cohort(fit.glucose, fit.timepoints, fit.cpeptide, fit.ages,
                     fit.t2dm, "cpu"),
        ptrain.TrainConfig(**SMOKE), designs=designs)
    ref = smoke_seed["trained"]
    rs = np.asarray(ref.screen_losses)
    np.testing.assert_allclose(port.screen_losses.numpy(), rs, rtol=1e-5)
    np.testing.assert_allclose(port.loss_traces.numpy(),
                               np.asarray(ref.loss_traces), rtol=1e-4)
    np.testing.assert_allclose(port.objectives.numpy(),
                               np.asarray(ref.objectives), rtol=5e-2)
    np.testing.assert_array_equal(port.orientations.numpy(),
                                  np.asarray(ref.orientations))


@pytest.fixture(scope="module")
def port_from_jax(smoke_seed):
    """The port's retrain pipeline at the smoke size (its ``subjects`` cut
    before the split, its selection and refit step counts: what
    ``--smoke`` passes) with training replaced by JAX's trained
    candidates."""
    ref = smoke_seed["trained"]
    given = ptrain.TrainResult(
        **{k: torch.as_tensor(np.array(getattr(ref, k)))
           for k in ("nn_params", "betas", "objectives", "screen_losses",
                     "loss_traces", "orientations")},
        timings=dict(ref.timings))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "train_conditional", lambda *a, **k: given)
        res = pipeline.run_training_pipeline(
            "cpu", REPO / "artifacts", seed=SEED,
            config=ptrain.TrainConfig(**SMOKE), subjects=SMOKE_N,
            select_iters=SELECT_ITERS, lbfgs_iters=REFIT_ITERS,
            profile_steps=0, census_steps=0, band_samples=8)
    return res, seeds.seed_record(res, SEED)


def test_selection_and_refit_match_jax(smoke_seed, port_from_jax):
    res, record = port_from_jax
    p, want = smoke_seed["pipeline"], smoke_seed["record"]
    np.testing.assert_array_equal(res.idx_fit, p.idx_fit)
    np.testing.assert_allclose(res.val_objectives, p.val_objectives,
                               rtol=1e-4)
    assert res.best == p.best == record["best_model_index"] \
        == want["best_model_index"]
    assert record["objective_best"] == want["objective_best"]
    assert record["library_orientation"] == want["library_orientation"]
    np.testing.assert_allclose(record["beta_bounds"], want["beta_bounds"],
                               rtol=1e-6)
    for split in ("train", "test"):
        np.testing.assert_allclose(getattr(res, f"b_{split}"),
                                   getattr(p, f"b_{split}"), atol=2e-3)
        np.testing.assert_allclose(getattr(res, f"s_{split}"),
                                   getattr(p, f"s_{split}"), rtol=5e-3)
        np.testing.assert_allclose(getattr(res, f"sse_{split}"),
                                   getattr(p, f"sse_{split}"), rtol=1e-2)
    for key in ("train_sse_mean", "test_sse_mean", "test_sse_median"):
        np.testing.assert_allclose(record[key], want[key], rtol=1e-2)
    for key in ("train_sse_per_type", "test_sse_per_type"):
        assert set(record[key]) == set(want[key])
        for t, v in want[key].items():
            np.testing.assert_allclose(record[key][t], v, rtol=1e-2)
    assert set(record["spearman"]) == set(want["spearman"])
    for k, v in want["spearman"].items():
        assert abs(record["spearman"][k] - v) < 0.05, k


def test_record_has_the_jax_keys_and_ude_vs_cude(smoke_seed, port_from_jax):
    _, record = port_from_jax
    want = smoke_seed["record"]
    assert list(record) == list(want)
    json.dumps(record)
    got, ref = record["ude_vs_cude"], want["ude_vs_cude"]
    assert set(got) == set(ref)
    assert abs(got["test_mse_ude_mean"] / ref["test_mse_ude_mean"] - 1.0) \
        < 1e-3
    np.testing.assert_allclose(got["test_mse_cude_mean"],
                               ref["test_mse_cude_mean"], rtol=1e-2)
    assert got["cude_better_fraction"] == ref["cude_better_fraction"]


def test_checkpoint_in_the_jax_format(smoke_seed, port_from_jax, tmp_path):
    """The seed's candidates as the JAX experiment script's ``cached``
    writes them: the same arrays, shapes and dtypes, and the same
    metadata."""
    res, _ = port_from_jax
    arrays, meta = seeds.training_checkpoint(res)
    save_checkpoint(tmp_path / "port.npz", arrays, metadata=meta)
    got, got_meta = load_checkpoint(tmp_path / "port.npz")
    want, want_meta = load_checkpoint(smoke_seed["checkpoint"])
    assert got_meta == want_meta
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].shape == value.shape and \
            got[key].dtype.kind == value.dtype.kind, key
    for key in ("nn_params", "betas", "objectives", "idx_fit",
                "orientations"):
        np.testing.assert_array_equal(got[key], want[key])


def test_flatten_matches_jax_on_every_committed_metrics_file():
    _, _, exp_replicate = _experiments()
    files = sorted((REPO / "results").glob("*_metrics*.json"))
    assert len(files) >= 20
    for path in files:
        metrics = json.loads(path.read_text())
        assert replicate.flatten(metrics) == exp_replicate.flatten(metrics), \
            path.name


def test_aggregate_reproduces_the_committed_replicate():
    committed = json.loads((REPO / "results"
                            / "replicate_exp06_saem.json").read_text())
    agg = replicate.aggregate(committed["per_seed"])
    assert len(agg) == 23 and agg == committed["aggregate"]


def test_replicate_runner_end_to_end(tmp_path, monkeypatch, capsys):
    """exp01 (frozen, on the CPU) at two seeds in child processes; the
    second call runs no child; a failing child fails the run; nothing
    is written into the artifacts or the results."""
    before = _snapshot()
    argv = ["--experiment", "exp01", "--seeds", "1", "2", "--out",
            str(tmp_path), "--", "--device", "cpu"]
    replicate.main(argv)
    out = json.loads((tmp_path / "replicate_exp01.json").read_text())
    assert out["script"] == "exp01" and out["seeds"] == [1, 2]
    assert set(out["per_seed"]) == {"1", "2"}
    for s in (1, 2):
        assert (tmp_path / "seeds" / f"exp01_seed{s}"
                / "exp01_metrics.json").exists()
    assert out["aggregate"]["test_mse_mean"]["sd"] == 0.0
    assert set(out["aggregate"]["train_mse_mean"]) == {"mean", "sd", "min",
                                                       "max"}
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {"script": "exp01", "n_seeds": 2,
                       "aggregated_keys": len(out["aggregate"])}

    def no_child(*a, **k):
        raise AssertionError("a cached seed started a child")

    with monkeypatch.context() as mp:
        mp.setattr(subprocess, "run", no_child)
        replicate.main(argv)
    assert json.loads((tmp_path / "replicate_exp01.json").read_text()) == out
    with pytest.raises(SystemExit) as failed:
        replicate.main(["--experiment", "exp03", "--seeds", "3", "--out",
                        str(tmp_path), "--", "--retrain"])
    assert failed.value.code not in (0, None)
    with pytest.raises(SystemExit):
        replicate.main(["--experiment", "exp01", "--seeds", "1", "--out",
                        "artifacts/replicate"])
    assert _snapshot() == before
