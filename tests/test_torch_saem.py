"""PyTorch port: SAEM (``fit/saem.py``) against the JAX package on the CPU,
on the same inputs and the JAX package's own random draws.

The JAX functions take a key; the port takes the normals and uniforms that
key gives, split as ``conditional_ude_tpu/fit/saem.py:187,194,209`` (and
``:430,452`` for the posterior chains) split it.  Tolerances: the
acceptance traces equal (the same accept and reject decisions); the random
effects, θ, σ, Ω, η and the NLL trace rtol 1e-4 (atol 1e-6 for entries
near 0); the first population gradient rtol 1e-4 and atol 2e-4 of its
largest entry (``tests/test_pallas_grad.py``'s value+grad tolerance); the
posterior chains rtol 1e-4; the MAP and MLE fits at the fit tolerances of
``tests/test_torch_symbolic.py`` (objective rtol 1e-4, parameter 2e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from conditional_ude_tpu.fit import saem as jsaem
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu_torch.data.ohashi import load_npz
from conditional_ude_tpu_torch.fit import saem
from conditional_ude_tpu_torch.models import cpeptide as cp
from conditional_ude_tpu_torch.nn import chain

RTOL, ATOL = 1e-4, 1e-6
SMALL = saem.SAEMConfig(iterations=3, burnin=1, n_mcmc_steps=3,
                        initial_mcmc_steps=2, pop_update_iters=2)
MODEL = cp.CPeptideModel(chain(4, 2))
JMODEL = jcp.CPeptideModel(kind="conditional",
                           net=jax_chain(4, 2, "tanh", input_dims=2))


def jax_config(cfg: saem.SAEMConfig) -> jsaem.SAEMConfig:
    return jsaem.SAEMConfig(**dataclasses.asdict(cfg))


def saem_draws(seed: int, cfg: saem.SAEMConfig, n: int):
    """The normals and uniforms ``[iterations, mcmc_steps_max, n]`` that
    ``run_saem`` draws from ``jax.random.key(seed)``."""
    def step(k):
        k_prop, k_u = jax.random.split(k)
        return (jax.random.normal(k_prop, (n,), jnp.float32),
                jax.random.uniform(k_u, (n,), jnp.float32))

    def iteration(key, _):
        key, k_iter = jax.random.split(key)
        return key, jax.vmap(step)(jax.random.split(k_iter,
                                                    cfg.mcmc_steps_max))

    _, draws = lax.scan(iteration, jax.random.key(seed), None,
                        length=cfg.iterations)
    return tuple(np.asarray(d) for d in draws)


def chain_draws(seed: int, n_steps: int, n: int):
    """The normals and uniforms ``[n_steps, n]`` of ``posterior_chains``
    at ``jax.random.key(seed)``."""
    def step(k):
        k_prop, k_u = jax.random.split(k)
        return (jax.random.normal(k_prop, (n,), jnp.float32),
                jax.random.uniform(k_u, (n,)))

    return tuple(np.asarray(d) for d in jax.vmap(step)(
        jax.random.split(jax.random.key(seed), n_steps)))


def assert_saem_close(res, ref):
    np.testing.assert_allclose(res.acceptance_trace.numpy(),
                               np.asarray(ref.acceptance_trace), rtol=1e-6)
    for name in ("random_effects", "theta", "sigma", "omega", "eta",
                 "nll_trace", "proposal_std_trace"):
        np.testing.assert_allclose(
            getattr(res, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=RTOL, atol=ATOL, err_msg=name)


# -- the linear-Gaussian toy of tests/test_saem.py ----------------------------

def toy_data(rng, n=24, t=6, theta_true=1.5, omega_true=0.6, sigma_true=0.3):
    r_true = omega_true * rng.standard_normal(n)
    return (theta_true + r_true[:, None]
            + sigma_true * rng.standard_normal((n, t))).astype(np.float32)


def jax_toy_loglik(theta, sigma, r_i, ind, d):
    resid = d - (theta + r_i)
    return (-(d.shape[0] / 2.0) * jnp.log(sigma**2)
            - jnp.sum(resid**2) / (2.0 * sigma**2))


class ToyLogLik(saem.LogLik):
    """y_ij ~ N(θ + r_i, σ)."""

    def __init__(self, data):
        self.data = torch.as_tensor(data)
        self.n, self.device = self.data.shape[0], self.data.device

    def __call__(self, theta, sigma, rand):
        resid = self.data - (theta + rand[..., None])
        return (-(self.data.shape[1] / 2.0) * torch.log(sigma**2)
                - torch.sum(resid**2, -1) / (2.0 * sigma**2))


def run_jax_toy(data, seed, cfg):
    return jsaem.run_saem(jax_toy_loglik, jnp.asarray(0.0),
                          jnp.zeros(data.shape[0]), jnp.asarray(data),
                          jax.random.key(seed), jax_config(cfg))


@pytest.mark.parametrize("omega_as_variance", [False, True])
def test_run_saem_matches_jax_on_the_linear_gaussian_model(rng,
                                                           omega_as_variance):
    data = toy_data(rng)
    cfg = dataclasses.replace(SMALL, pop_adam_lr=5e-2,
                              omega_as_variance=omega_as_variance)
    ref = run_jax_toy(data, 0, cfg)
    res = saem.run_saem(ToyLogLik(data), 0.0, cfg,
                        draws=saem_draws(0, cfg, data.shape[0]))
    assert res.route == "plain"
    assert_saem_close(res, ref)


def test_quirk_omega_collapse_pins_proposal_std_at_floor(rng):
    """``tests/test_saem.py::test_quirk_omega_collapse_pins_proposal_std_at
    _floor`` on the port with the same draws: in the reference's Ω mode Ω
    collapses, the acceptance stalls below its target and the proposal std
    sits at its floor; the consistent mode on the same data does none of
    these."""
    data = toy_data(rng, omega_true=0.6)
    floor = 0.05
    cfg = saem.SAEMConfig(iterations=400, burnin=80, n_mcmc_steps=3,
                          pop_update_iters=5, pop_adam_lr=5e-2, alpha=0.5,
                          proposal_bounds=(floor, 1.0))
    draws = saem_draws(0, cfg, data.shape[0])
    quirk, consistent = (
        saem.run_saem(ToyLogLik(data), 0.0,
                      dataclasses.replace(cfg, omega_as_variance=mode),
                      draws=draws) for mode in (False, True))
    assert float(quirk.omega) < 0.01, float(quirk.omega)
    assert float(quirk.acceptance_trace[-1]) < 0.25
    assert abs(float(quirk.proposal_std_trace[-1]) - floor) < 1e-6
    assert 0.3 < float(consistent.omega) < 1.0
    assert float(consistent.acceptance_trace[-1]) > 0.2
    assert float(consistent.proposal_std_trace[-1]) > 2 * floor


def test_run_saem_takes_a_generator_or_draws():
    ll = ToyLogLik(np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="Generator or the draws"):
        saem.run_saem(ll, 0.0, SMALL)
    bad = np.zeros((SMALL.iterations, SMALL.mcmc_steps_max, 5), np.float32)
    with pytest.raises(ValueError, match="shape"):
        saem.run_saem(ll, 0.0, SMALL, draws=(bad, bad))
    a, b = (saem.run_saem(ll, 0.0, SMALL,
                          generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    torch.testing.assert_close(a.random_effects, b.random_effects, rtol=0,
                               atol=0)


# -- the cUDE on Ohashi subjects -----------------------------------------------

@pytest.fixture(scope="module")
def ohashi():
    train, _ = load_npz("artifacts/ohashi.npz")
    s = train.subset(np.arange(6))
    args = (s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm)
    nn0 = np.load("artifacts/saem_pretrain.npz")["nn_params"][0]
    return cp.build_cohort(*args, device="cpu"), jcp.build_cohort(*args), nn0


@pytest.mark.parametrize("omega_as_variance", [False, True])
def test_saem_cude_matches_jax(ohashi, omega_as_variance):
    c, jc, nn0 = ohashi
    cfg = dataclasses.replace(SMALL, omega_as_variance=omega_as_variance)
    ref = jsaem.saem_cude(JMODEL, jc, jnp.asarray(nn0), jax.random.key(7),
                          jax_config(cfg))
    res = saem.saem_cude(MODEL, c, torch.as_tensor(nn0), config=cfg,
                         draws=saem_draws(7, cfg, c.n))
    # on the CPU the kernels' plain versions
    assert res.route == "plain_k4_k2"
    assert_saem_close(res, ref)


def jax_total_nll_grad(jc, theta, sigma, rand):
    """``jax.grad`` of −Σ ll over the network and σ, as ``pop_update``
    takes it (``saem.py:153-154``), before the non-finite mask."""
    ll = jax.vmap(jsaem.cude_loglik(JMODEL, jc.timepoints),
                  in_axes=(None, None, 0, 0, 0))

    def total(p):
        return -jnp.sum(ll(p["theta"], p["sigma"], rand, jc.individuals,
                           jc.cpeptide))

    g = jax.grad(total)({"theta": jnp.asarray(theta),
                         "sigma": jnp.asarray(sigma)})
    return np.asarray(g["theta"]), np.asarray(g["sigma"])


def test_first_population_gradient_matches_jax(ohashi, rng):
    """K2's route (its plain version here) and autograd through the plain
    RK4 against JAX's gradient of the total NLL, at the pre-train and
    random β's."""
    c, jc, nn0 = ohashi
    rand = rng.uniform(-2.0, 1.0, c.n).astype(np.float32)
    sigma = np.float32(0.8)
    jg_th, jg_s = jax_total_nll_grad(jc, nn0, sigma, rand)
    ll = saem.cude_loglik(MODEL, c)
    args = (torch.as_tensor(nn0), torch.tensor(sigma), torch.as_tensor(rand))
    for name, (_, g_th, g_s) in (
            ("K2", ll.nll_and_grad(*args)),
            ("autograd", saem.LogLik.nll_and_grad(ll, *args))):
        scale = np.abs(jg_th).max()
        np.testing.assert_allclose(g_th.numpy() / scale, jg_th / scale,
                                   rtol=1e-4, atol=2e-4, err_msg=name)
        np.testing.assert_allclose(float(g_s), float(jg_s), rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("failure", ["sse_overflow", "nan_trajectory"])
def test_a_failing_subject_leaves_what_jax_leaves(ohashi, failure):
    """One subject of six fails.  ``sse_overflow``: its last c-peptide
    sample is 1e20, so its residuals are finite and its SSE overflows; JAX
    gives it cotangent 0, so the gradient is the other five's.
    ``nan_trajectory``: a NaN glucose sample makes its trajectory NaN, and
    0 × NaN poisons every entry, which the mask then zeroes.  Both routes of
    the port (K2's and autograd through the plain RK4) leave, after the
    non-finite mask, what JAX's leaves; the subject's likelihood is −inf."""
    c, jc, nn0 = ohashi
    glucose, cpeptide = c.glucose.numpy().copy(), c.cpeptide.numpy().copy()
    if failure == "sse_overflow":
        cpeptide[-1, -1] = 1e20
    else:
        glucose[-1, 2] = np.nan
    args = (glucose, c.timepoints, cpeptide, c.age.numpy(),
            np.zeros(c.n, bool))
    cf, jcf = cp.build_cohort(*args, device="cpu"), jcp.build_cohort(*args)
    rand = np.linspace(-1.0, 0.5, c.n).astype(np.float32)
    sigma = np.float32(0.7)
    jg_th, jg_s = jax_total_nll_grad(jcf, nn0, sigma, rand)
    assert np.isfinite(jg_th).all() == (failure == "sse_overflow")
    ll = saem.cude_loglik(MODEL, cf)
    targs = (torch.as_tensor(nn0), torch.tensor(sigma), torch.as_tensor(rand))
    values = ll.values(*targs)
    assert bool(torch.isneginf(values[-1]))
    assert bool(torch.isfinite(values[:-1]).all())

    def masked(g):
        g = np.asarray(g, np.float32)
        return np.where(np.isfinite(g), g, 0.0)

    scale = max(np.abs(masked(jg_th)).max(), 1e-30)
    for name, (_, g_th, g_s) in (
            ("K2", ll.nll_and_grad(*targs)),
            ("autograd", saem.LogLik.nll_and_grad(ll, *targs))):
        np.testing.assert_array_equal(np.isfinite(g_th.numpy()),
                                      np.isfinite(jg_th), err_msg=name)
        np.testing.assert_allclose(masked(g_th.numpy()) / scale,
                                   masked(jg_th) / scale, rtol=1e-4,
                                   atol=2e-4, err_msg=name)
        assert not np.isfinite(float(g_s)) and not np.isfinite(float(jg_s))


def test_posterior_chains_match_jax(ohashi):
    c, jc, nn0 = ohashi
    n_steps, theta, sigma, eta, omega = 40, nn0, 0.8, 0.3, 0.5
    jll = jsaem.cude_loglik(JMODEL, jc.timepoints)
    init = np.linspace(-0.5, 0.8, c.n).astype(np.float32)
    ref_chains, ref_acc = jsaem.posterior_chains(
        jll, jnp.asarray(theta), jnp.asarray(sigma), jc.individuals,
        jc.cpeptide, jax.random.key(5), jnp.asarray(init),
        eta=jnp.asarray(eta), omega=jnp.asarray(omega), n_steps=n_steps)
    chains, acc = saem.posterior_chains(
        saem.cude_loglik(MODEL, c), torch.as_tensor(theta), sigma,
        torch.as_tensor(init), eta, omega, n_steps=n_steps,
        draws=chain_draws(5, n_steps, c.n))
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref_acc), rtol=1e-6)
    np.testing.assert_allclose(chains.numpy(), np.asarray(ref_chains),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("estimator", ["map", "mle"])
def test_individual_fits_match_jax(ohashi, estimator):
    """From the committed fit's fixed effects (``artifacts/saem_fit.npz``),
    100 L-BFGS steps a subject, as exp06 runs them."""
    c, jc, _ = ohashi
    fit = np.load("artifacts/saem_fit.npz")
    theta, sigma, eta, omega = (fit[k] for k in ("nn_params", "sigma", "eta",
                                                 "omega"))
    init = np.full(c.n, eta, np.float32)
    jll = jsaem.cude_loglik(JMODEL, jc.timepoints)
    ll = saem.cude_loglik(MODEL, c)
    jargs = (jll, jnp.asarray(theta), jnp.asarray(sigma), jc.individuals,
             jc.cpeptide, jnp.asarray(init))
    args = (ll, torch.as_tensor(theta), sigma, torch.as_tensor(init))
    if estimator == "map":
        ref = jsaem.individual_maps(*jargs, eta=jnp.asarray(eta),
                                    omega=jnp.asarray(omega))
        got = saem.individual_maps(*args, eta, omega)
    else:
        ref = jsaem.individual_mles(*jargs)
        got = saem.individual_mles(*args)
    ref = np.asarray(ref)

    def objective(x):
        val = -ll(torch.as_tensor(theta), torch.tensor(sigma),
                  torch.as_tensor(x, dtype=torch.float32))
        if estimator == "map":
            val = val - saem._normal_logpdf(
                torch.as_tensor(x, dtype=torch.float32), torch.tensor(eta),
                torch.tensor(omega))
        return val.detach().numpy()

    np.testing.assert_allclose(objective(got.numpy()), objective(ref),
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)


def test_loglik_routes():
    """The kernels' route for the canonical cUDE with RK4; the plain
    solvers for Tsit5 and for another network."""
    train, _ = load_npz("artifacts/ohashi.npz")
    s = train.subset(np.arange(3))
    c = cp.build_cohort(s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm,
                        "cpu")
    assert saem.cude_loglik(MODEL, c).route == "plain_k4_k2"
    assert saem.cude_loglik(MODEL, c, solver="tsit5").route == "plain"
    relu = cp.CPeptideModel(chain(4, 2, "relu"))
    assert saem.cude_loglik(relu, c).route == "plain"
    # the two value routes agree
    nn = torch.as_tensor(np.load("artifacts/saem_pretrain.npz")
                         ["nn_params"][0])
    ll = saem.cude_loglik(MODEL, c)
    rand = torch.tensor([[-1.0, 0.0, 0.5], [0.2, -0.3, 1.0]])
    torch.testing.assert_close(ll.values(nn, torch.tensor(0.8), rand),
                               saem.LogLik.values(ll, nn, torch.tensor(0.8),
                                                  rand),
                               rtol=1e-5, atol=1e-5)
