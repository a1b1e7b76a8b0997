"""PyTorch port: c-peptide model, interpolation, RK4 and losses against the
JAX package on a 6-subject cohort made from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.fit.losses import population_sse as jax_population_sse
from conditional_ude_tpu.fit.losses import sse as jax_sse
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.ops.interp import LinearInterp as JaxInterp
from conditional_ude_tpu_torch.fit.losses import population_sse, sse
from conditional_ude_tpu_torch.models import cpeptide as cp
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops.interp import LinearInterp, linspace

RTOL, ATOL = 1e-5, 1e-6
N = 6
GRIDS = {"ohashi": np.array([0.0, 30.0, 60.0, 90.0, 120.0]),
         "starts_before_0": np.array([-10.0, 0.0, 30.0, 60.0, 90.0, 120.0])}


def _cohorts(tp, seed=11):
    rng = np.random.default_rng(seed)
    k = tp.shape[0]
    raw = (5.0 + rng.uniform(0, 5, (N, k)), tp,
           0.5 + rng.uniform(0, 1.5, (N, k)), rng.uniform(30, 70, N),
           rng.uniform(size=N) > 0.5)
    return cp.build_cohort(*raw, device="cpu"), jcp.build_cohort(*raw)


def _nets(seed=1):
    rng = np.random.default_rng(seed)
    nn = np.array(jax_chain(4, 2, "tanh", input_dims=2).init(
        jax.random.key(seed)))
    betas = rng.uniform(-2.0, 0.0, N).astype(np.float32)
    return nn, betas


@pytest.fixture(scope="module")
def models():
    return (cp.CPeptideModel(chain(4, 2)),
            jcp.CPeptideModel(kind="conditional",
                              net=jax_chain(4, 2, "tanh", input_dims=2)))


def test_van_cauter_parameters():
    age = np.linspace(20.0, 80.0, 13, dtype=np.float32)
    t2dm = np.arange(13) % 2 == 0
    out = cp.van_cauter_parameters(torch.as_tensor(age), torch.as_tensor(t2dm))
    ref = jcp.van_cauter_parameters(jnp.asarray(age), jnp.asarray(t2dm))
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_build_cohort(grid):
    c, jc = _cohorts(GRIDS[grid])
    ind = jc.individuals
    for name in ("k0", "k1", "k2", "c0"):
        np.testing.assert_allclose(getattr(c, name).numpy(),
                                   np.asarray(getattr(ind, name)),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(c.u0.numpy(), np.asarray(ind.u0), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(c.timepoints, np.asarray(jc.timepoints))
    np.testing.assert_allclose(c.kinetics(with_age=True).numpy()[:, 4],
                               np.asarray(ind.age))


def test_linear_interp_matches_jax():
    rng = np.random.default_rng(5)
    ts = np.array([-10.0, 0.0, 30.0, 60.0, 90.0, 120.0], np.float32)
    ys = rng.uniform(4, 12, (3, 6)).astype(np.float32)
    queries = np.array([-30.0, -10.0, -2.5, 0.0, 1.875, 30.0, 59.999, 60.0,
                        119.0, 120.0, 200.0], np.float32)
    out = LinearInterp(ts, torch.as_tensor(ys))(queries).numpy()
    for i in range(3):
        f = JaxInterp(jnp.asarray(ts), jnp.asarray(ys[i]))
        ref = np.asarray(jax.vmap(f)(jnp.asarray(queries)))
        np.testing.assert_allclose(out[i], ref, rtol=RTOL, atol=ATOL)
    scalar = LinearInterp(ts, torch.as_tensor(ys))(12.0)
    assert scalar.shape == (3,)


@pytest.mark.parametrize("args", [(-4.0, 1.0, 10_000), (-10.0, 10.0, 1000),
                                  (-5.7429385, 1.6972165, 10_000),
                                  (0.5, 10.0, 8), (2.0, 3.0, 1)])
def test_linspace_is_jnp_linspace(args):
    # XLA's CPU code rounds some points differently: equal within two ulp
    # of the grid's largest magnitude
    out, ref = linspace(*args), np.asarray(jnp.linspace(*args))
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert out[0] == ref[0] and out[-1] == ref[-1]
    ulp = np.spacing(np.float32(max(abs(args[0]), abs(args[1]))))
    assert np.abs(out - ref).max() <= 2 * ulp


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_rhs(models, grid):
    model, jmodel = models
    c, jc = _cohorts(GRIDS[grid])
    nn, betas = _nets()
    rng = np.random.default_rng(4)
    y = rng.uniform(0.2, 3.0, (N, 2)).astype(np.float32)
    for t in (-10.0, 0.0, 1.875, 45.0, 120.0):
        if t < GRIDS[grid][0]:
            continue
        out = model.rhs(t, torch.as_tensor(y), torch.as_tensor(nn),
                        torch.as_tensor(betas), c)
        ref = jax.vmap(lambda yy, b, ind: jmodel.rhs(
            jnp.float32(t), yy, ({"neural": jnp.asarray(nn),
                                  "conditional": b}, ind)))(
            jnp.asarray(y), jnp.asarray(betas), jc.individuals)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("substeps", [8, 16])
def test_simulate_cohort_rk4(models, grid, substeps):
    model, jmodel = models
    c, jc = _cohorts(GRIDS[grid])
    nn, betas = _nets()
    res = cp.simulate_cohort(model, torch.as_tensor(nn),
                             torch.as_tensor(betas), c, substeps=substeps)
    ref = jcp.simulate_cohort(jmodel, jnp.asarray(nn), jnp.asarray(betas), jc,
                              solver="rk4", substeps=substeps)
    assert res.ys.shape == (N, GRIDS[grid].shape[0], 2)
    # a state that crosses zero keeps the absolute error of its own scale
    ys = np.asarray(ref.ys)
    np.testing.assert_allclose(res.ys.numpy(), ys, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(ys).max()))
    np.testing.assert_array_equal(res.success.numpy(), np.asarray(ref.success))


def test_losses(models):
    model, jmodel = models
    c, jc = _cohorts(GRIDS["ohashi"])
    nn, betas = _nets(3)
    rows = np.stack([betas, betas - 1.0, np.full(N, np.nan, np.float32)])
    out = sse(model, torch.as_tensor(nn), torch.as_tensor(rows), c,
              substeps=8).numpy()
    for r in range(rows.shape[0]):
        ref = jax.vmap(lambda b, ind, d: jax_sse(
            jmodel, {"neural": jnp.asarray(nn), "conditional": b}, ind,
            jc.timepoints, d, solver="rk4", substeps=8))(
            jnp.asarray(rows[r]), jc.individuals, jc.cpeptide)
        np.testing.assert_allclose(out[r], np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
    # a non-finite trajectory is a failed solve: inf
    assert np.isinf(out[2]).all()
    pop = population_sse(model, torch.as_tensor(nn), torch.as_tensor(rows[0]),
                         c, substeps=8)
    ref = jax_population_sse(jmodel, jnp.asarray(nn), jnp.asarray(rows[0]), jc,
                             solver="rk4", substeps=8)
    np.testing.assert_allclose(float(pop), float(ref), rtol=RTOL)


def test_production_orientation(models):
    model, jmodel = models
    nets = np.load("artifacts/cude_neural_parameters.npz")["nn_params"]
    for nn in nets[[0, 7, 19]]:
        out = cp.production_orientation(model, torch.as_tensor(nn))
        ref = float(jcp.production_orientation(jmodel, jnp.asarray(nn)))
        assert out == ref
