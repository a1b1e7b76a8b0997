"""PyTorch port: SAEM on the analytic heads (``saem_symbolic``,
``saem_discovered``: the log-normal individual map θ_i = θ_pop·e^{η_i}
and the L-BFGS population update over [θ_pop, σ]) against the JAX package
on the CPU, on six Ohashi subjects and JAX's own draws.

Tolerances: as ``tests/test_torch_saem.py`` (the acceptance traces equal;
the random effects, θ_pop, σ, Ω and the NLL trace rtol 1e-4); the MAP and
MLE fits objective rtol 1e-4 and parameter 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditional_ude_tpu.fit import saem as jsaem
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
from conditional_ude_tpu_torch.fit import saem
from conditional_ude_tpu_torch.models import cpeptide as cp
from test_torch_saem import (
    assert_saem_close,
    chain_draws,
    jax_config,
    saem_draws,
)

SMALL = saem.SAEMConfig(iterations=3, burnin=1, n_mcmc_steps=3,
                        initial_mcmc_steps=2, pop_update_iters=2,
                        pop_update_lbfgs=True, update_prior_mean=False)
HEADS = {"symbolic": (saem.saem_symbolic, jsaem.saem_symbolic, 75.0,
                      saem.symbolic_loglik, jsaem.symbolic_loglik),
         "discovered": (saem.saem_discovered, jsaem.saem_discovered, 0.43,
                        saem.discovered_loglik, jsaem.discovered_loglik)}


@pytest.fixture(scope="module")
def cohorts():
    """Three training and three test subjects, as exp06a and exp06b fit
    both splits at once."""
    train, test = load_npz("artifacts/ohashi.npz")
    s = OhashiSplit.concatenate(train.subset(np.arange(3)),
                                test.subset(np.arange(3)))
    args = (s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm)
    return cp.build_cohort(*args, device="cpu"), jcp.build_cohort(*args)


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("omega_as_variance", [False, True])
def test_saem_matches_jax(cohorts, head, omega_as_variance):
    c, jc = cohorts
    run, jrun, start, _, _ = HEADS[head]
    cfg = dataclasses.replace(SMALL, omega_as_variance=omega_as_variance)
    ref = jrun(jc, start, jax.random.key(11), jax_config(cfg))
    res = run(c, start, config=cfg, draws=saem_draws(11, cfg, c.n))
    assert res.route == "plain"
    assert_saem_close(res, ref)


@pytest.mark.parametrize("head", sorted(HEADS))
def test_post_hoc_estimators_match_jax(cohorts, head):
    """The chains with injected draws, the MAPs and the MLEs, at exp06a's
    and exp06b's prior (η = 0) and a population parameter near their
    committed fits."""
    c, jc = cohorts
    _, _, start, loglik, jloglik = HEADS[head]
    ll, jll = loglik(c), jloglik(jc.timepoints)
    theta, sigma, omega, eta = start, 0.3, 0.5, 0.0
    init = np.zeros(c.n, np.float32)
    jargs = (jll, jnp.asarray(theta), jnp.asarray(sigma), jc.individuals,
             jc.cpeptide)
    chains, acc = saem.posterior_chains(ll, theta, sigma, torch.as_tensor(init),
                                        eta, omega, n_steps=30,
                                        draws=chain_draws(3, 30, c.n))
    ref_chains, ref_acc = jsaem.posterior_chains(
        *jargs, jax.random.key(3), jnp.asarray(init), eta=jnp.asarray(eta),
        omega=jnp.asarray(omega), n_steps=30)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref_acc), rtol=1e-6)
    np.testing.assert_allclose(chains.numpy(), np.asarray(ref_chains),
                               rtol=1e-4, atol=1e-6)

    maps = saem.individual_maps(ll, theta, sigma, torch.as_tensor(init), eta,
                                omega)
    ref_maps = np.asarray(jsaem.individual_maps(
        *jargs, jnp.asarray(init), eta=jnp.asarray(eta),
        omega=jnp.asarray(omega)))
    mles = saem.individual_mles(ll, theta, sigma, torch.as_tensor(init))
    ref_mles = np.asarray(jsaem.individual_mles(*jargs, jnp.asarray(init)))

    def nll(x, prior):
        x = torch.as_tensor(x, dtype=torch.float32)
        val = -ll(torch.tensor(theta), torch.tensor(sigma), x)
        if prior:
            val = val - saem._normal_logpdf(x, torch.tensor(eta),
                                            torch.tensor(omega))
        return val.detach().numpy()

    for got, ref, prior in ((maps, ref_maps, True), (mles, ref_mles, False)):
        np.testing.assert_allclose(nll(got.numpy(), prior), nll(ref, prior),
                                   rtol=1e-4)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)


def test_lognormal_map_needs_an_analytic_head(cohorts):
    from conditional_ude_tpu_torch.nn import chain
    with pytest.raises(ValueError, match="analytic head"):
        saem._lognormal_scalar_loglik(cp.CPeptideModel(chain(4, 2)),
                                      cohorts[0], "rk4", 8, 256)
