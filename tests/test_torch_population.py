"""PyTorch port: the population screen kernel K1 (``ops/rk4_population.py``).

On the CPU its wrapper runs the plain PyTorch version, held here against the
JAX package's Pallas kernel in interpret mode and against its XLA RK4
population loss.  The CUDA kernel is held against the plain version by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.fit.losses import population_sse as jax_population_sse
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.ops.pallas_rk4 import (
    cohort_kinetics,
    population_sse_pallas,
)
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import rk4_population

RTOL, ATOL = 1e-5, 1e-6     # the JAX suite's RK4 kernel tolerance
G, N = 37, 8                # ragged restart count
TP = (0.0, 30.0, 60.0, 90.0, 120.0)


def _huge():
    w1 = np.zeros((4, 2))
    w1[:, 0] = 1e20
    return np.concatenate([w1.ravel(), np.zeros(4), np.eye(4).ravel(),
                           np.zeros(4), np.full(4, 1e20), [0.0]])


@pytest.fixture(scope="module")
def case():
    """G restarts on an N-subject cohort; the last subject's glucose rises
    and the last restart's weights are huge, so that restart's mean is inf."""
    rng = np.random.default_rng(11)
    glucose = 5.0 + rng.uniform(0, 5, (N, 5))
    glucose[-1] = [5.0, 6.0, 7.0, 8.0, 9.0]
    jc = jcp.build_cohort(glucose, np.asarray(TP),
                          0.5 + rng.uniform(0, 1.5, (N, 5)),
                          rng.uniform(30, 70, N), rng.uniform(size=N) > 0.5)
    jnet = jax_chain(4, 2, "tanh", input_dims=2)
    nn = np.array(jnet.init_batch(jax.random.key(4), G))
    nn[-1] = _huge()
    betas = rng.uniform(-2.0, 0.0, (G, N)).astype(np.float32)
    kin = np.asarray(cohort_kinetics(jc, with_age=False))
    t = lambda a: torch.as_tensor(np.array(a, np.float32))  # noqa: E731
    port_args = (t(nn), t(betas), t(jc.individuals.glucose), t(jc.cpeptide),
                 t(kin))
    return jnet, jc, nn, betas, port_args


def test_plain_matches_pallas_interpret(case):
    jnet, jc, nn, betas, args = case
    before = rk4_population.launches
    out = rk4_population.population_sse(chain(4, 2), *args, TP, 8).numpy()
    assert rk4_population.launches == before     # the CPU path launches nothing
    ref = np.asarray(population_sse_pallas(jnet, jnp.asarray(nn),
                                           jnp.asarray(betas), jc, 8,
                                           interpret=True))
    assert np.isinf(out[-1]) and np.isinf(ref[-1])
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_allclose(out[:-1], ref[:-1], rtol=RTOL, atol=ATOL)


def test_plain_matches_xla_population_loss(case):
    jnet, jc, nn, betas, args = case
    model = jcp.CPeptideModel(kind="conditional", net=jnet)
    out = rk4_population.population_sse(chain(4, 2), *args, TP, 8).numpy()
    ref = np.asarray(jax.vmap(lambda n, b: jax_population_sse(
        model, n, b[:, None], jc, solver="rk4", substeps=8))(
            jnp.asarray(nn), jnp.asarray(betas)))
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_allclose(out[:-1], ref[:-1], rtol=RTOL, atol=ATOL)


def test_mean_of_the_cohort_kernel_lanes(case):
    """K1 is K4 over (restart × individual) lanes reduced by the mean: the
    two evaluate the network at the same points in the same order, so K1
    equals K4's lanes summed over the individuals in order, times 1/N, bit
    for bit."""
    from conditional_ude_tpu_torch.ops import population_grad, rk4_cohort

    _, _, _, _, (nn, betas, glucose, data, kin) = case
    out = rk4_population.population_sse(chain(4, 2), nn, betas, glucose,
                                        data, kin, TP, 8)
    lanes = rk4_cohort.cohort_sse(
        chain(4, 2), nn[:, None].expand(G, N, 37).reshape(-1, 37),
        betas.reshape(-1), glucose.repeat(G, 1), data.repeat(G, 1),
        kin.repeat(G, 1), TP, 8).reshape(G, N)
    mean = population_grad.sum_in_order(lanes) * np.float32(1.0 / N)
    torch.testing.assert_close(out[:-1], mean[:-1], rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    _, _, _, _, (nn, betas, glucose, data, kin) = case
    net = chain(4, 2)

    def call(net_=net, **kw):
        a = {**dict(nn_params=nn, betas=betas, glucose=glucose, data=data,
                    kinetics=kin), **kw}
        return rk4_population.population_sse(net_, a["nn_params"], a["betas"],
                                             a["glucose"], a["data"],
                                             a["kinetics"], TP, 8)

    assert call().shape == (G,)
    with pytest.raises(ValueError):
        call(betas=betas[:, :-1])
    with pytest.raises(ValueError):
        call(kinetics=torch.ones(N, 5))
    with pytest.raises(TypeError):
        call(betas=betas.double())
    # the covariate net needs the age column, and then runs
    cov = dict(net_=chain(4, 2, input_dims=3), nn_params=torch.zeros(G, 41))
    with pytest.raises(ValueError):
        call(**cov)
    assert call(**cov, kinetics=torch.ones(N, 5)).shape == (G,)
