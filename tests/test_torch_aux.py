"""PyTorch port: the auxiliary modules and the fit exports.

* ``cli``: experiment names resolve as the JAX front door resolves them
  (``tests/test_cli.py``'s cases, against the JAX package's own
  ``_resolve_experiment`` on ``experiments/``), ``list`` names every
  script, ``exp 02_c --help`` reaches the port's entry point, and the two
  scripts that read the reference's raw CSVs are refused without
  ``--data-dir``;
* ``utils.profiling``: ``scope`` prints its seconds; ``checked`` names the
  aten op that made a NaN (``log(-1)``) or divided by zero and passes clean
  input and the port's population loss; ``device_trace`` writes a Chrome
  trace on the CPU;
* the exports of exp02 and exp07 (``cude_fit.npz``,
  ``cude_covariate_fit.npz``) through the entry point on a reduced frozen
  path: the committed files' keys, each array's shape at the run's subject
  and grid counts, the arrays of the run itself, and the metadata.
"""

import functools
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu import cli as jax_cli
from conditional_ude_tpu.utils import checkpoint as jckpt
from conditional_ude_tpu_torch import __main__ as entry
from conditional_ude_tpu_torch import cli, pipeline
from conditional_ude_tpu_torch.data.ohashi import load_npz
from conditional_ude_tpu_torch.fit.losses import population_sse
from conditional_ude_tpu_torch.models.cpeptide import (
    CPeptideModel,
    build_cohort,
)
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.utils import profiling
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parent.parent
EXPERIMENTS = REPO / "experiments"


def test_stems_are_the_jax_scripts():
    stems = sorted(p.stem for p in EXPERIMENTS.glob("exp*.py")
                   if p.name != "common.py")
    assert sorted(cli.EXPERIMENTS) == stems


@pytest.mark.parametrize("name", ["01", "02_c", "exp06a_saem_symreg",
                                  "exp_supp", "06", "exp_fig", "07",
                                  "exp02_xl", "_symreg_p"])
def test_resolve_as_the_jax_front_door(name):
    assert cli.resolve(name) == jax_cli._resolve_experiment(EXPERIMENTS,
                                                            name).stem


@pytest.mark.parametrize("name", ["02", "exp0", "no_such_thing"])
def test_resolve_refuses_as_the_jax_front_door(name):
    with pytest.raises(SystemExit) as jax_err:
        jax_cli._resolve_experiment(EXPERIMENTS, name)
    with pytest.raises(SystemExit) as err:
        cli.resolve(name)
    word = str(jax_err.value).split()[0]       # ambiguous / unknown
    assert str(err.value).startswith(word)
    if word == "ambiguous":
        assert "exp02_conditional" in str(err.value)
        assert "exp02_xl" in str(err.value)


def test_list_names_every_experiment(capsys):
    assert cli.main(["list"]) == 0
    out = capsys.readouterr().out
    for stem in cli.EXPERIMENTS:
        assert stem in out


def test_exp_help_reaches_the_entry_point():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["exp", "02_c", "--help"])
    assert rc == 0
    text = buf.getvalue()
    assert "usage" in text.lower() and "--covariate" in text


@pytest.mark.parametrize("name", ["00", "exp_parity"])
def test_exp_refuses_what_reads_the_raw_csvs(name, capsys):
    assert cli.main(["exp", name]) != 0
    assert "--data-dir" in capsys.readouterr().err


def test_info_names_torch(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert torch.__version__ in out and "cards visible: 0" in out


def test_scope_prints_its_seconds():
    buf = io.StringIO()
    with profiling.scope("stage", out=buf):
        pass
    assert buf.getvalue().startswith("[stage] ") and \
        buf.getvalue().strip().endswith("s")


def test_checked_names_the_op_of_log_minus_one():
    err, out = profiling.checked(lambda x: torch.log(x) + 1.0)(
        torch.tensor([1.0, -1.0]))
    assert torch.isnan(out[1])
    with pytest.raises(FloatingPointError, match="aten.log"):
        err.throw()


def test_checked_names_a_division_by_zero():
    err, out = profiling.checked(lambda x, y: x / y)(
        torch.tensor([1.0, 2.0]), torch.tensor([2.0, 0.0]))
    assert torch.isinf(out[1])
    with pytest.raises(FloatingPointError, match="division by zero in "
                                                 "aten.div"):
        err.throw()


def test_checked_passes_a_nan_its_inputs_held():
    err, _ = profiling.checked(lambda x: x * 2.0)(
        torch.tensor([1.0, float("nan")]))
    assert err.get() is None


def test_checked_passes_the_population_loss():
    train, _ = load_npz(REPO / "artifacts" / "ohashi.npz")
    s = train.subset(np.arange(6))
    cohort = build_cohort(s.glucose, s.timepoints, s.cpeptide, s.ages,
                          s.t2dm, "cpu")
    model = CPeptideModel(chain(4, 2))
    nn = torch.as_tensor(np.load(REPO / "artifacts" /
                                 "cude_neural_parameters.npz")[
        "nn_params"][:2], dtype=torch.float32)
    betas = torch.full((2, 6), -1.0)
    err, loss = profiling.checked(
        lambda b: population_sse(model, nn[:, None, :], b, cohort,
                                 substeps=8))(betas)
    err.throw()
    assert loss.shape == (2,) and bool(torch.isfinite(loss).all())
    np.testing.assert_array_equal(
        loss.numpy(), population_sse(model, nn[:, None, :], betas, cohort,
                                     substeps=8).numpy())


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(tmp_path / "trace") as path:
        torch.tanh(torch.linspace(-1.0, 1.0, 64)).sum()
    events = json.loads(path.read_text())["traceEvents"]
    assert path.parent == tmp_path / "trace"
    assert any("tanh" in e.get("name", "") for e in events)


# a reduced frozen path: two candidates, the first 8 subjects of each split,
# 5 L-BFGS steps, 40 profile and 20 census points
REDUCED = dict(candidates=2, subjects=8, profile_steps=40, census_steps=20,
               band_samples=20)


@pytest.mark.parametrize("covariate", [False, True])
def test_fit_export_through_the_entry_point(tmp_path, monkeypatch,
                                            covariate):
    runs = []

    def reduced(*args, **kwargs):
        kwargs.update(REDUCED)
        runs.append(pipeline.run_frozen_pipeline(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(entry, "run_frozen_pipeline", reduced)
    buf = io.StringIO()
    with redirect_stdout(buf):
        entry.main(["--device", "cpu", "--lbfgs-iters", "5", "--out",
                    str(tmp_path), *(["--covariate"] if covariate else [])])
    res = runs[0]
    name = "cude_covariate_fit.npz" if covariate else "cude_fit.npz"
    got, meta = load_checkpoint(tmp_path / name)
    committed = np.load(REPO / "artifacts" / name)
    assert set(got) == set(committed.files)
    n = REDUCED["subjects"]
    sizes = {117: 2 * n, 82: n, 35: n, 10_000: REDUCED["profile_steps"],
             1000: REDUCED["census_steps"]}
    for key in committed.files:
        assert got[key].shape == tuple(sizes[d] for d in
                                       committed[key].shape), key
        assert got[key].dtype == np.float32, key
    for key, value in (("beta_train", res.b_train), ("sigma_test",
                                                     res.s_test),
                       ("sse_test", res.sse_test)):
        np.testing.assert_array_equal(got[key], value)
    if not covariate:
        np.testing.assert_array_equal(got["profile_values"],
                                      res.profile.values.numpy())
        np.testing.assert_array_equal(got["delta_grid"],
                                      res.delta_profile.grid.numpy())
    want_meta = json.loads((REPO / "artifacts" / name).with_suffix(".json")
                           .read_text())
    assert set(meta) == set(want_meta)
    assert meta["script"] == want_meta["script"]
    assert meta["best_model_index"] == res.best
    assert meta["bounds"] == list(res.bounds)
    # the JAX package reads the port's file
    arrays, jax_meta = jckpt.load_checkpoint(tmp_path / name)
    assert jax_meta == meta and set(arrays) == set(got)
    if not covariate:
        assert (tmp_path / "ohashi_production.csv").exists()
        assert (tmp_path / "figures" / "sampled_simulations.png").stat() \
            .st_size > 1000


def test_band_curves_summarise_to_the_metric():
    """``sampled_band_curves`` and the ``sampled_simulation_bands`` metric
    come from one set of trajectories: each summary is its curves' value."""
    train, test = load_npz(REPO / "artifacts" / "ohashi.npz")
    both = pipeline.OhashiSplit.concatenate(train, test)
    fit = np.load(REPO / "artifacts" / "cude_fit.npz")
    betas = np.concatenate([fit["beta_train"], fit["beta_test"]])
    nn = torch.as_tensor(np.load(REPO / "artifacts" /
                                 "cude_neural_parameters.npz")[
        "nn_params"][19], dtype=torch.float32)
    model = CPeptideModel(chain(4, 2))
    run = functools.partial(pipeline.sampled_band_curves, model, nn, betas,
                            both, pipeline.SEED, 30)
    curves = run()
    assert curves["dense_t"].shape == (61,)
    summary = pipeline.band_summary(curves)
    assert summary == pipeline.sampled_bands(model, nn, betas, both,
                                             pipeline.SEED, 30)
    for t, c in curves["bands"].items():
        assert summary[t]["mean_final"] == float(c["mean"][-1])
        assert np.all(c["p05"] <= c["p95"])
        np.testing.assert_array_equal(c["obs_mean"],
                                      both.cpeptide[both.types == t]
                                      .mean(axis=0))
