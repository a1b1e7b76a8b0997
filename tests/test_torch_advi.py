"""PyTorch port: ADVI (``fit/advi.py``, ``advi_pipeline.py``) against the JAX
package on the CPU, on the same inputs and the JAX package's own draws.

The JAX functions take a key; the port takes the normals that key gives,
split as ``conditional_ude_tpu/fit/advi.py`` splits it: ``split(key,
steps)`` in ``advi``, after ``split(key, N)`` over the subjects in
``advi_betas`` and ``split(key, R)`` over the restarts in the experiment
script.  On the CPU the ELBO gradients of the canonical cUDE run K2's plain
version (``plain_k2``); a 3-wide network runs autograd.

Tolerances: the Gaussian case (a), where both sides do the same float32
arithmetic but the cosine schedule (XLA folds its constants and its float32
cosine is not correctly rounded, so a step size may differ by up to four
float32 roundings of lr), rtol 1e-5 and atol
1e-6 (atol 1e-4 on the ELBO, a sum of 16 terms near 0); the cUDE cases
(b, c, d) rtol 1e-4, atol 1e-5 (K2's sums take another order than JAX's
autograd, see ``ops/lane_grad.py``); the pipeline (e) the same on its
arrays and 1e-4 on its correlations, the identifiable fraction equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.analysis import (
    cohort_beta_profiles as jax_profiles,
    find_confidence_intervals as jax_cis,
)
from conditional_ude_tpu.data.ohashi import load_npz as jax_load
from conditional_ude_tpu.fit import advi as jadvi
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.utils.stats import spearman as jax_spearman
from conditional_ude_tpu_torch import advi_pipeline
from conditional_ude_tpu_torch.fit import advi
from conditional_ude_tpu_torch.fit.optim import cosine_decay
from conditional_ude_tpu_torch.models import cpeptide as cp
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import lane_grad

RTOL, ATOL = 1e-4, 1e-5
ART = "artifacts"
BEST = 19               # results/exp02_metrics.json's best_model_index


def jax_model(width=4):
    return jcp.CPeptideModel(kind="conditional",
                             net=jax_chain(width, 2, "tanh", input_dims=2))


def advi_normals(key, steps, shape):
    """``advi``'s ε at ``key``: ``[steps, *shape]``."""
    return jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(
        jax.random.split(key, steps))


def batch_normals(key, rows, steps, shape):
    """The ε of ``rows`` problems whose keys are ``split(key, rows)``, in the
    port's layout ``[steps, rows, *shape]``."""
    eps = jax.vmap(lambda k: advi_normals(k, steps, shape))(
        jax.random.split(key, rows))
    return np.array(eps).transpose(1, 0, 2, 3)


def assert_close(got, want, rtol=RTOL, atol=ATOL, **kw):
    for name in got._fields:
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=rtol, atol=atol, err_msg=name, **kw)


@pytest.fixture(scope="module")
def ohashi():
    train, test = jax_load(f"{ART}/ohashi.npz")
    cand = np.load(f"{ART}/cude_neural_parameters.npz")
    return train, test, cand


def cohorts(split):
    args = (split.glucose, split.timepoints, split.cpeptide, split.ages,
            split.t2dm)
    return cp.build_cohort(*args, device="cpu"), jcp.build_cohort(*args)


# -- (a) the schedule and the Gaussian log-joint -------------------------------

@pytest.mark.parametrize("steps,lr", [(2000, 1e-2), (1500, 1e-2), (50, 5e-2)])
def test_cosine_decay_is_optax_schedule(steps, lr):
    """Every step's size, counts 0..steps + 2, against optax's
    ``cosine_decay_schedule(lr, steps, 0.02)`` as the ADVI scan reads it
    (jitted, an int32 count): within 4 float32 roundings of lr (4·2⁻²⁴·lr;
    3.1 measured at 2,000 steps), the error of XLA's float32 evaluation of
    ``c·(π/T)``, its cosine and ``(1 + cos)·0.49``, where the port rounds
    once from float64.  The first and the last steps are equal."""
    counts = np.arange(steps + 3)
    want = np.asarray(jax.jit(jax.vmap(optax.cosine_decay_schedule(
        lr, steps, alpha=0.02)))(jnp.asarray(counts, jnp.int32)))
    got = np.asarray([cosine_decay(lr, steps, 0.02)(int(c)) for c in counts],
                     np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0**-24 * lr)
    assert got[0] == want[0] and (got[steps:] == want[steps:]).all()


def test_advi_matches_jax_on_the_gaussian_log_joint():
    """``tests/test_advi.py``'s conjugate Gaussian: mean, log-std and every
    step's ELBO as JAX's ``advi`` on its own draws."""
    m = np.array([1.5, -0.7, 3.0], np.float32)
    s = np.array([0.5, 1.2, 0.3], np.float32)
    steps, n_samples, key = 2000, 16, jax.random.key(0)
    ref = jadvi.advi(lambda z: -0.5 * jnp.sum(((z - m) / s) ** 2),
                     jnp.zeros(3), key, steps=steps, n_samples=n_samples,
                     lr=5e-2)
    tm, ts = torch.as_tensor(m), torch.as_tensor(s)
    vg = advi.autograd_value_and_grad(
        lambda z: -0.5 * (((z - tm) / ts) ** 2).sum(-1))
    eps = np.asarray(advi_normals(key, steps, (n_samples, 3)))[:, None]
    res = advi.advi(vg, torch.zeros(1, 3), steps=steps, n_samples=n_samples,
                    lr=5e-2, normals=eps)               # one row
    np.testing.assert_allclose(res.mean[0].numpy(), np.asarray(ref.mean),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.log_std[0].numpy(),
                               np.asarray(ref.log_std), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.elbo_trace[0].numpy(),
                               np.asarray(ref.elbo_trace), rtol=1e-5,
                               atol=1e-4)
    # the analytic posterior, as tests/test_advi.py holds JAX's
    np.testing.assert_allclose(res.mean[0].numpy(), m, atol=0.1)


def test_advi_takes_a_generator_or_normals():
    vg = advi.autograd_value_and_grad(lambda z: -0.5 * (z**2).sum(-1))
    with pytest.raises(ValueError, match="Generator or the normals"):
        advi.advi(vg, torch.zeros(2, 3), steps=3)
    with pytest.raises(ValueError, match="shape"):
        advi.advi(vg, torch.zeros(2, 3), steps=3, n_samples=4,
                  normals=np.zeros((3, 2, 5, 3)))
    a, b = (advi.advi(vg, torch.zeros(2, 3), steps=5, n_samples=4,
                      generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a.mean, b.mean) and a.elbo_trace.shape == (2, 5)


# -- (b) advi_betas on Ohashi test subjects --------------------------------------

@pytest.mark.parametrize("route", ["plain_k2", "autograd"])
def test_advi_betas_matches_jax(ohashi, route):
    """6 test subjects, 100 steps (autograd: a 3-wide network, which K2 does
    not compute, 30 steps), 8 samples, RK4 at 4 substeps, from β = −1."""
    _, test, cand = ohashi
    c, jc = cohorts(test.subset(np.arange(6)))
    if route == "plain_k2":
        width, nn, steps = 4, cand["nn_params"][BEST], 100
    else:
        width, steps = 3, 30
        net = jax_chain(3, 2, "tanh", input_dims=2)
        nn = np.asarray(net.init(jax.random.key(5))) * 1.5
    model = cp.CPeptideModel(chain(width, 2))
    assert advi.kernel_route(model, 4) == (route == "plain_k2")
    key = jax.random.key(7)
    ref = jadvi.advi_betas(jax_model(width), jnp.asarray(nn), jc, key,
                           initial_beta=-1.0, steps=steps, solver="rk4",
                           substeps=4)
    res = advi.advi_betas(model, torch.as_tensor(nn), c, initial_beta=-1.0,
                          steps=steps, substeps=4,
                          normals=batch_normals(key, c.n, steps, (8, 2)))
    assert_close(res, ref)


# -- (c) advi_joint ------------------------------------------------------------

@pytest.mark.parametrize("route", ["plain_k2", "autograd"])
def test_advi_joint_matches_jax(ohashi, route):
    """2 restarts from the committed candidates and their training β's on 8
    of their fit subjects, 50 steps (autograd: a 3-wide network, 10 steps),
    4 samples, RK4 at 4 substeps; the restarts vmapped as the experiment
    script vmaps them."""
    train, _, cand = ohashi
    c, jc = cohorts(train.subset(cand["idx_fit"][:8]))
    r = 2
    b0 = cand["betas"][:r, :8, 0]
    if route == "plain_k2":
        width, nn0, steps = 4, cand["nn_params"][:r], 50
    else:
        width, steps = 3, 10
        net = jax_chain(3, 2, "tanh", input_dims=2)
        nn0 = np.array(net.init_batch(jax.random.key(6), r))
    model = cp.CPeptideModel(chain(width, 2))
    assert advi.kernel_route(model, 4) == (route == "plain_k2")
    keys = jax.random.split(jax.random.key(3), r)
    ref = jax.vmap(lambda n_, b_, k: jadvi.advi_joint(
        jax_model(width), jc, n_, k, init_betas=b_, steps=steps, n_samples=4,
        solver="rk4", substeps=4))(jnp.asarray(nn0), jnp.asarray(b0), keys)
    d = nn0.shape[1] + 8 + 1
    normals = np.stack([np.asarray(advi_normals(k, steps, (4, d)))
                        for k in keys], 1)
    res = advi.advi_joint(model, c, torch.as_tensor(nn0),
                          torch.as_tensor(b0), steps=steps, normals=normals)
    assert_close(res, ref)


# -- (d) the drop rule ----------------------------------------------------------

def test_a_non_finite_lane_drops_its_sample_as_jax_does(ohashi, monkeypatch):
    """The network's e^β weight of unit 0 set to 0 and sample 0's β draw to
    1000 every step: β ≈ 134, e^β = inf, 0·inf = NaN, so that lane's SSE is
    not finite (K2's plain version says so) and the sample is dropped; JAX,
    fed the same draws, drops it too.  A step where every sample fails
    moves μ not at all and ρ by the entropy term alone (∂/∂ρ = −1)."""
    _, test, cand = ohashi
    c, jc = cohorts(test.subset(np.arange(3)))
    nn = cand["nn_params"][BEST].copy()
    nn[1] = 0.0                      # w1[0][1]: unit 0's e^β weight
    model = cp.CPeptideModel(chain(4, 2))
    lanes = lane_grad.lane_sse_and_grad(
        model.net, torch.as_tensor(nn)[None], torch.full((1, 3), 134.0),
        c.glucose, c.cpeptide, c.kinetics(), tuple(c.timepoints), 4)
    assert not bool(torch.isfinite(lanes[0]).any())

    normal = jax.random.normal
    steps, key = 20, jax.random.key(7)
    monkeypatch.setattr(jax.random, "normal", lambda k, shape, dtype:
                        normal(k, shape, dtype).at[0, 0].set(1000.0))
    ref = jadvi.advi_betas(jax_model(), jnp.asarray(nn), jc, key,
                           initial_beta=-1.0, steps=steps, solver="rk4",
                           substeps=4)
    eps = batch_normals(key, c.n, steps, (8, 2))
    eps[:, :, 0, 0] = 1000.0
    res = advi.advi_betas(model, torch.as_tensor(nn), c, initial_beta=-1.0,
                          steps=steps, substeps=4, normals=eps)
    assert_close(res, ref)
    assert np.isfinite(res.elbo_trace.numpy()).all()

    # every sample fails: one step from (−1, 0) with ρ = −2
    monkeypatch.setattr(jax.random, "normal", lambda k, shape, dtype:
                        jnp.full(shape, 1000.0, dtype))
    ref = jadvi.advi_betas(jax_model(), jnp.asarray(nn), jc, key,
                           initial_beta=-1.0, steps=1, solver="rk4",
                           substeps=4)
    res = advi.advi_betas(model, torch.as_tensor(nn), c, initial_beta=-1.0,
                          steps=1, substeps=4,
                          normals=np.full((1, 3, 8, 2), 1000.0))
    assert_close(res, ref, rtol=1e-6, atol=0)
    assert (res.beta_mean == -1.0).all() and (res.log_sigma_mean == 0).all()
    # Adam's first step on ∂/∂ρ = −1 moves ρ by lr (up to the bias
    # correction's rounding); the ELBO is the entropy alone
    rho = -2.0 + 1e-2
    np.testing.assert_allclose(res.beta_std.numpy(), np.exp(rho), rtol=1e-6)
    np.testing.assert_allclose(res.log_sigma_std.numpy(), np.exp(rho),
                               rtol=1e-6)
    np.testing.assert_allclose(
        res.elbo_trace[:, 0].numpy(),
        2 * (rho + 0.5 * (np.log(2 * np.pi) + 1.0)), rtol=1e-6)


# -- (e) the experiment at a reduced size -----------------------------------------

def test_run_exp_advi_matches_the_jax_body(ohashi):
    """``experiments/exp_advi.py``'s sections 1-2 with the JAX package's
    functions, reduced: 2 restarts on the first 8 fit subjects and 35 test
    subjects, 50 steps each, the profile at 200 points; the port's
    ``run_exp_advi`` at the same sizes on JAX's draws."""
    train, test, cand = ohashi
    r, n_fit, steps, seed = 2, 8, 50, 270523
    _, jfit = cohorts(train.subset(cand["idx_fit"][:n_fit]))
    _, jtest = cohorts(test)
    model = jax_model()
    nn0 = jnp.asarray(cand["nn_params"][:r])
    b0 = cand["betas"][:r, :n_fit, 0]
    keys = jax.random.split(jax.random.key(seed), r)
    joint = jax.vmap(lambda n_, b_, k: jadvi.advi_joint(
        model, jfit, n_, k, init_betas=b_, steps=steps, n_samples=4,
        solver="rk4", substeps=4))(nn0, jnp.asarray(b0), keys)
    nn_best = jnp.asarray(cand["nn_params"][BEST])
    post = jadvi.advi_betas(model, nn_best, jtest, jax.random.key(7),
                            initial_beta=-1.0, steps=steps, solver="rk4",
                            substeps=4)
    b_std = np.asarray(post.beta_std)
    ci = jax_cis(jax_profiles(model, nn_best, jtest,
                              sigmas=jnp.exp(post.log_sigma_mean),
                              lower=-6.0, upper=2.0, steps=200),
                 "cantelli95")
    half = 0.5 * (np.asarray(ci.upper) - np.asarray(ci.lower))
    ok = np.isfinite(half)
    want = {
        "joint_elbo_final_best": float(np.max(joint.elbo_trace[:, -1])),
        "joint_beta_pointfit_corr_mean": float(np.mean(
            [np.corrcoef(np.asarray(joint.beta_mean[i]), b0[i])[0, 1]
             for i in range(r)])),
        "test_spearman_first_phase": jax_spearman(
            np.asarray(post.beta_mean), test.first_phase),
        "test_beta_std_median": float(np.median(b_std)),
        "advi_sd_vs_profile_ci_corr": float(np.corrcoef(b_std[ok],
                                                        half[ok])[0, 1])}

    d = nn0.shape[1] + n_fit + 1
    draws = (np.stack([np.asarray(advi_normals(k, steps, (4, d)))
                       for k in keys], 1),
             batch_normals(jax.random.key(7), 35, steps, (8, 2)))
    run = advi_pipeline.run_exp_advi(
        "cpu", ART, seed=seed, restarts=r, fit_subjects=n_fit,
        joint_steps=steps, test_steps=steps, profile_steps=200, draws=draws)
    assert run.metrics["n_restarts"] == r
    assert run.metrics["identifiable_fraction"] == float(ok.mean())
    for k, v in want.items():
        np.testing.assert_allclose(run.metrics[k], v, rtol=1e-4, err_msg=k)
    assert set(run.metrics["stage_seconds"]) == {"joint", "test_beta",
                                                 "profile"}
    for got, ref in ((run.joint, joint), (run.test, post)):
        for k, v in got.items():
            want_v = (np.asarray(ref.elbo_trace)[..., -1]
                      if k == "elbo_final" else np.asarray(getattr(ref, k)))
            np.testing.assert_allclose(v, want_v, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    assert run.test_meta == {"script": "exp_advi", "model_index": BEST}
    assert run.joint_meta == {"script": "exp_advi", "restarts": r,
                              "steps": steps}


def test_cli_writes_the_jax_outputs(tmp_path, monkeypatch, capsys):
    """``--experiment exp_advi --out DIR`` (at cut step counts) writes the
    metrics and both npz files with the JAX script's keys and metadata,
    prints the metrics, and refuses ``--retrain`` and the reference's
    directories."""
    from conditional_ude_tpu_torch import __main__ as cli
    from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint

    run = advi_pipeline.run_exp_advi
    monkeypatch.setattr(advi_pipeline, "run_exp_advi", lambda *a, **kw: run(
        *a, **kw, fit_subjects=4, joint_steps=3, test_steps=3,
        profile_steps=100))
    cli.main(["--experiment", "exp_advi", "--device", "cpu", "--restarts",
              "2", "--out", str(tmp_path)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    written = json.loads((tmp_path / "exp_advi_metrics.json").read_text())
    assert printed == written and written["n_restarts"] == 2
    assert set(written) == {
        "n_restarts", "joint_elbo_final_best",
        "joint_beta_pointfit_corr_mean", "test_spearman_first_phase",
        "test_beta_std_median", "advi_sd_vs_profile_ci_corr",
        "identifiable_fraction", "stage_seconds"}
    joint, meta = load_checkpoint(tmp_path / "advi_cude_results.npz")
    assert {k: v.shape for k, v in joint.items()} == {
        "nn_mean": (2, 37), "nn_std": (2, 37), "beta_mean": (2, 4),
        "beta_std": (2, 4), "log_sigma_mean": (2,), "elbo_final": (2,)}
    assert meta == {"script": "exp_advi", "restarts": 2, "steps": 3}
    test, meta = load_checkpoint(tmp_path / "advi_test_posteriors.npz")
    assert {k: v.shape for k, v in test.items()} == {
        k: (35,) for k in ("beta_mean", "beta_std", "log_sigma_mean",
                           "elbo_final")}
    assert meta == {"script": "exp_advi", "model_index": BEST}
    for argv in (["--retrain"], ["--out", "artifacts"], ["--out", "results"]):
        with pytest.raises(SystemExit):
            cli.main(["--experiment", "exp_advi", "--device", "cpu", *argv])


@pytest.mark.parametrize("argv,restarts", [([], 96), (["--restarts", "0"], 0),
                                           (["--restarts", "5"], 5)])
def test_xl_retrain_takes_restarts_as_given(monkeypatch, argv, restarts):
    """``--restarts`` is shared with exp_advi and defaults to None:
    ``--xl --retrain`` refines 96 restarts unless it says how many, 0
    included."""
    from conditional_ude_tpu_torch import __main__ as cli

    class Stop(Exception):
        pass

    def capture(*a, config, **kw):
        raise Stop(config.selected_initials)

    monkeypatch.setattr(cli, "run_training_pipeline", capture)
    with pytest.raises(Stop) as stop:
        cli.main(["--xl", "--retrain", "--device", "cpu", *argv])
    assert stop.value.args == (restarts,)
