"""PyTorch port: exp02's remaining outputs (``experiments/exp02_conditional.py
:117-222``) against the JAX experiment script's code on the same β's and weights —
the dose-response table, the sampled simulation bands and the UDE-against-
cUDE comparison — and the checkpoint format both packages read and write.

Inputs: the selected candidate of ``artifacts/cude_neural_parameters.npz``
(19), the committed refit ``artifacts/cude_fit.npz`` and exp01's network
``artifacts/ude_neural_parameters.npz``.  Tolerances: rtol 1e-4 for the
dose-response table and the bands (50 samples a type); the UDE's Tsit5 MSE
within what trajectories at the JAX suite's Tsit5 tolerance (rtol 2e-2,
atol 1e-3) can change, and rtol 1e-3; the fraction of subjects the cUDE
fits better, exactly.  The committed table
``artifacts/ohashi_production.csv`` came from a TPU, whose productions the
JAX experiment script's own code on the CPU misses by up to 7.8e-5 (0.54 %): the port
is held to twice that.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.utils import checkpoint as jckpt
from conditional_ude_tpu_torch import __main__ as cli
from conditional_ude_tpu_torch import pipeline
from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
from conditional_ude_tpu_torch.models.cpeptide import CPeptideModel
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.utils import checkpoint as ckpt

BEST = 19                  # artifacts/cude_fit.json: best_model_index
# largest |production − committed| of the JAX experiment script's own table on the CPU
JAX_CSV_MISS = 8e-5
SAMPLES = 50
MODEL = CPeptideModel(chain(4, 2))
JNET = jax_chain(4, 2, "tanh", input_dims=2)
JMODEL = jcp.CPeptideModel(kind="conditional", net=JNET)


@pytest.fixture(scope="module")
def inputs():
    train, test = load_npz("artifacts/ohashi.npz")
    nn = np.load("artifacts/cude_neural_parameters.npz")["nn_params"][BEST]
    fit = np.load("artifacts/cude_fit.npz")
    ude = np.load("artifacts/ude_neural_parameters.npz")["nn_params"][0]
    return train, test, nn, fit, ude


def _jax_dose_response(nn, b_train, glucose):
    """``experiments/exp02_conditional.py:117-138``."""
    beta_grid = np.quantile(b_train, np.linspace(0.05, 0.95, 30))
    dg_grid = np.linspace(0.0, np.ptp(glucose, axis=1).max(), 30)
    bb, gg = np.meshgrid(beta_grid, dg_grid, indexing="ij")

    def production(dg, beta):
        x1 = jnp.stack([dg, jnp.exp(beta)])
        x0 = jnp.stack([jnp.zeros_like(dg), jnp.exp(beta)])
        return JNET.scalar(nn, x1) - JNET.scalar(nn, x0)

    prod = np.asarray(jax.vmap(production)(
        jnp.asarray(gg.ravel(), jnp.float32),
        jnp.asarray(bb.ravel(), jnp.float32)))
    return np.stack([np.exp(bb.ravel()), gg.ravel(), prod], axis=1)


def test_dose_response_matches_jax_and_the_committed_table(inputs):
    train, _, nn, fit, _ = inputs
    out = pipeline.dose_response(MODEL, torch.as_tensor(nn),
                                 fit["beta_train"], train.glucose)
    ref = _jax_dose_response(jnp.asarray(nn), fit["beta_train"],
                             train.glucose)
    assert out.shape == (900, 3)
    np.testing.assert_array_equal(out[:, :2], ref[:, :2])
    np.testing.assert_allclose(out[:, 2], ref[:, 2], rtol=1e-4, atol=1e-7)
    # the committed table came from a TPU: its columns of β and ΔG are the
    # port's, its productions are JAX-on-the-CPU's within JAX_CSV_MISS, and
    # the port's within twice that
    committed = np.genfromtxt("artifacts/ohashi_production.csv",
                              delimiter=",", skip_header=1)
    np.testing.assert_allclose(out[:, :2], committed[:, :2], rtol=1e-12)
    jax_miss = np.abs(ref[:, 2] - committed[:, 2]).max()
    assert 0.5 * JAX_CSV_MISS < jax_miss <= JAX_CSV_MISS
    np.testing.assert_allclose(out[:, 2], committed[:, 2], rtol=1e-4,
                               atol=2 * JAX_CSV_MISS)


def _jax_bands(nn, betas, split, seed, n_samples):
    """``experiments/exp02_conditional.py:140-198`` without the figure."""
    rng = np.random.default_rng(seed)
    dense_t = np.arange(split.timepoints[0], split.timepoints[-1] + 0.1, 2.0)
    out = {}
    for t in ("NGT", "IGT", "T2DM"):
        sel = split.types == t
        ind = jcp.build_individual(split.glucose[sel].mean(axis=0),
                                   split.timepoints,
                                   float(split.ages[sel].mean()),
                                   float(split.cpeptide[sel, 0].mean()),
                                   t == "T2DM")
        sampled = rng.choice(betas[sel], size=n_samples, replace=True)
        sols = np.asarray(jax.vmap(lambda b: jcp.simulate(
            JMODEL, {"neural": nn, "conditional": b}, ind,
            jnp.asarray(dense_t, jnp.float32), solver="rk4",
            substeps=4).ys[:, 0])(jnp.asarray(sampled, jnp.float32)))
        out[t] = {"mean_final": float(sols.mean(axis=0)[-1]),
                  "p05_final": float(np.quantile(sols[:, -1], 0.05)),
                  "p95_final": float(np.quantile(sols[:, -1], 0.95))}
    return out


def test_sampled_bands_match_jax(inputs):
    train, test, nn, fit, _ = inputs
    both = OhashiSplit.concatenate(train, test)
    betas = np.concatenate([fit["beta_train"], fit["beta_test"]])
    out = pipeline.sampled_bands(MODEL, torch.as_tensor(nn), betas, both,
                                 pipeline.SEED, SAMPLES)
    ref = _jax_bands(jnp.asarray(nn), betas, both, pipeline.SEED, SAMPLES)
    assert set(out) == set(ref) == {"NGT", "IGT", "T2DM"}
    for t in ref:
        for key in ("mean_final", "p05_final", "p95_final"):
            np.testing.assert_allclose(out[t][key], ref[t][key], rtol=1e-4)
        assert out[t]["p05_final"] < out[t]["mean_final"] \
            < out[t]["p95_final"]


def test_ude_vs_cude_matches_jax(inputs):
    """The test subjects' MSE with exp01's network (Tsit5 at the JAX
    defaults) against the cUDE's, from the committed refit's SSEs."""
    _, test, _, fit, ude = inputs
    out = pipeline.ude_vs_cude(torch.as_tensor(ude), test, fit["sse_test"])
    cohort = jcp.build_cohort(test.glucose, test.timepoints, test.cpeptide,
                              test.ages, test.t2dm)
    res = jcp.simulate_cohort(
        jcp.CPeptideModel(kind="ude", net=jax_chain(4, 2, "tanh",
                                                    input_dims=1)),
        jnp.asarray(ude), jnp.zeros((cohort.n, 0), jnp.float32), cohort)
    mse_ude = np.mean((np.asarray(res.ys[:, :, 0]) - test.cpeptide) ** 2,
                      axis=1)
    mse_cude = fit["sse_test"] / test.timepoints.shape[0]
    # two Tsit5 solves at rtol 1e-3 agree to the JAX suite's Tsit5
    # tolerance (rtol 2e-2, atol 1e-3), not to 1e-4 (2.6e-4 apart here):
    # the MSE is held to what trajectories within that tolerance can change
    ys = np.asarray(res.ys[:, :, 0])
    tol = 1e-3 + 2e-2 * np.abs(ys)
    bound = ((2.0 * np.abs(ys - test.cpeptide) + tol) * tol).mean()
    assert abs(out["test_mse_ude_mean"] - mse_ude.mean()) <= bound
    assert abs(out["test_mse_ude_mean"] / mse_ude.mean() - 1.0) < 1e-3
    np.testing.assert_allclose(out["test_mse_cude_mean"], mse_cude.mean(),
                               rtol=1e-6)
    assert out["cude_better_fraction"] == float((mse_cude < mse_ude).mean())
    committed = json.load(open("results/exp02_metrics.json"))["ude_vs_cude"]
    for key, want in committed.items():
        assert abs(out[key] / want - 1.0) < 0.03, key


def test_frozen_pipeline_emits_the_outputs():
    """exp02's frozen path at a reduced depth carries the three outputs
    into its metrics; exp07 and exp02_xl make none (as their JAX
    experiment scripts)."""
    res = pipeline.run_frozen_pipeline("cpu", "artifacts", lbfgs_iters=5,
                                       candidates=2, subjects=6,
                                       profile_steps=0, census_steps=0,
                                       band_samples=8)
    metrics = res.metrics()
    assert res.dose_response.shape == (900, 3)
    assert set(metrics["sampled_simulation_bands"]) <= {"NGT", "IGT", "T2DM"}
    assert set(metrics["ude_vs_cude"]) == {
        "test_mse_ude_mean", "test_mse_cude_mean", "cude_better_fraction"}
    committed = json.load(open("results/exp02_metrics.json"))
    assert set(committed) <= set(metrics)
    assert "outputs" in res.seconds
    cov = pipeline.run_frozen_pipeline("cpu", "artifacts", lbfgs_iters=2,
                                       candidates=2, subjects=3,
                                       profile_steps=0, census_steps=0,
                                       covariate=True)
    assert cov.bands is None and "sampled_simulation_bands" not in \
        cov.metrics()


def test_checkpoints_cross_both_packages(tmp_path):
    """Each package reads the other's ``.npz`` and its JSON sidecar, and
    ``cached`` computes once, then loads."""
    arrays = {"nn_params": np.arange(66, dtype=np.float32).reshape(2, 33),
              "objectives": np.array([0.5, 0.25], np.float32)}
    ckpt.save_checkpoint(tmp_path / "port", {
        "nn_params": torch.as_tensor(arrays["nn_params"]),
        "objectives": arrays["objectives"]}, metadata={"script": "exp01"})
    got, meta = jckpt.load_checkpoint(tmp_path / "port.npz")
    assert meta == {"script": "exp01"}
    for key, want in arrays.items():
        np.testing.assert_array_equal(got[key], want)
        assert got[key].dtype == want.dtype
    jckpt.save_checkpoint(tmp_path / "jax.npz", arrays, {"n": 2})
    got, meta = ckpt.load_checkpoint(tmp_path / "jax")
    assert meta == {"n": 2}
    for key, want in arrays.items():
        np.testing.assert_array_equal(got[key], want)
    calls = []

    def compute():
        calls.append(1)
        return arrays

    first = ckpt.cached(tmp_path / "c", compute)
    again = ckpt.cached(tmp_path / "c.npz", compute)
    assert len(calls) == 1
    np.testing.assert_array_equal(again["objectives"], first["objectives"])
    ckpt.cached(tmp_path / "c", compute, retrain=True)
    assert len(calls) == 2
    np.testing.assert_array_equal(
        jckpt.cached(tmp_path / "c", compute)["nn_params"],
        arrays["nn_params"])
    assert len(calls) == 2


def test_cli_writes_outputs_to_out_only(tmp_path, capsys):
    """``--out`` gets the metrics and the fit checkpoint in the JAX
    package's format; the reference's artifacts and results are refused."""
    cli.main(["--device", "cpu", "--experiment", "exp04", "--lbfgs-iters",
              "3", "--out", str(tmp_path)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads((tmp_path / "exp04_metrics.json").read_text()) \
        == printed
    arrays, meta = jckpt.load_checkpoint(tmp_path
                                         / "symreg_external_fit.npz")
    assert meta == {"script": "exp04"} and arrays["ks"].shape == (20,)
    for reference in ("artifacts", "results"):
        with pytest.raises(SystemExit):
            cli.main(["--device", "cpu", "--experiment", "exp04",
                      "--out", reference])
