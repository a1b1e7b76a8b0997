"""PyTorch port: the plain versions of K1-K5 at networks other than the
canonical ``chain(4, 2)``, against the JAX package's Pallas kernels in
interpret mode.

The JAX kernels take any ``chain(widths, "tanh")`` with a softplus head on
2 or 3 inputs (``conditional_ude_tpu/ops/pallas_rk4.py:70-96`` build their
bodies from ``net.layer_dims``), and so do the port's.  Held here on the
CPU, at 3 restarts x 4 individuals on the OGTT grid at 2 substeps (JAX's
interpret mode unrolls every substep; at 1 substep RK4's step polynomial
cancels and amplifies rounding), for W = ``chain(8, 2)``, D =
``chain(4, 3)``, V = ``chain([6, 3], input_dims=3)`` (the covariate model)
and the one-layer ``chain(5, 1)``:

* K1 (``population_sse``) and K4 (``cohort_sse``) at rtol 1e-5 / atol 1e-6,
  the JAX suite's RK4 kernel tolerance;
* K2 (``packed_sse_and_grad``) at rtol 1e-4 on the value and 2e-4 of a
  row's largest entry on each gradient (``tests/test_pallas_grad.py:61-64``);
  K5, whose JAX kernel takes ~10-45 s a network in interpret mode, is held
  alike in ``tests/test_torch_widths_restart_grad.py``;
* K3 (``cohort_sse_tsit5``) at rtol 2e-2 + atol 1e-3 with the same ``ok``
  mask (``tests/test_pallas_tsit5.py``).  A lane's adaptive steps can move
  with one ulp of its inputs (F7 in ``ROADMAP.md``: V's lane (1, 1) takes
  28 to 30 steps and its SSE moves 2 % in JAX when its β moves one ulp,
  while a float64 solve at rtol 1e-8 lies between), so a lane outside that
  tolerance must lie within twice JAX's own move under β ± one ulp.

The 3-input network reads the age scaled by 1/100, as the JAX suite's
covariate tests scale it, so that its first layer is not saturated.  The
weights are JAX's own Glorot designs (``init_batch``), carried across by
value; the cohort comes from a numpy generator seeded per network.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

import conditional_ude_tpu.ops.pallas_grad as jpg
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.ops.pallas_rk4 import (
    cohort_kinetics,
    cohort_sse_pallas,
    population_sse_pallas,
)
from conditional_ude_tpu.ops.pallas_tsit5 import cohort_sse_tsit5_pallas
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import (
    lane_grad,
    population_grad,
    rk4_cohort,
    rk4_population,
    tsit5_cohort,
)

TP = (0.0, 30.0, 60.0, 90.0, 120.0)
SUBSTEPS = 2
R, N = 3, 4
RK4_RTOL, RK4_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-4
TSIT5_RTOL, TSIT5_ATOL = 2e-2, 1e-3
# name -> (hidden widths, inputs, seed)
NETS = {"W": ((8, 8), 2, 11), "D": ((4, 4, 4), 2, 12),
        "V": ((6, 3), 3, 13), "chain(5, 1)": ((5,), 2, 14)}


def case(name):
    """The networks of both packages, JAX's cohort (the age scaled for a
    3-input network) and the port's arguments ``(nn, betas, glucose,
    cpeptide, kinetics, tp)`` as float32 tensors."""
    widths, d, seed = NETS[name]
    rng = np.random.default_rng(seed)
    glucose = 5.0 + rng.uniform(0, 5, (N, 5))
    raw = (glucose, np.asarray(TP), 0.5 + rng.uniform(0, 1.5, (N, 5)),
           rng.uniform(30, 70, N), rng.uniform(size=N) > 0.5)
    jc = jcp.build_cohort(*raw)
    if d == 3:
        jc = jc._replace(individuals=jc.individuals._replace(
            age=jnp.asarray(np.float32(raw[3] / 100.0))))
    jnet = jax_chain(list(widths), activation="tanh", input_dims=d)
    net = chain(list(widths), activation="tanh", input_dims=d)
    assert net.num_params == jnet.num_params and net.widths == widths
    nn = np.array(jnet.init_batch(jax.random.key(seed), R), np.float32)
    betas = rng.uniform(-2.0, 0.0, (R, N)).astype(np.float32)
    kin = np.asarray(cohort_kinetics(jc, with_age=d == 3), np.float32)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32))

    port = (t(nn), t(betas), t(jc.individuals.glucose), t(jc.cpeptide),
            t(kin), TP)
    return net, jnet, jc, nn, betas, kin, port


def _lanes(nn, betas, glucose, cpeptide, kin):
    """The (restart, individual) lanes of a [R, N] grid, restart-major."""
    return (np.repeat(nn, N, 0), betas.reshape(-1),
            np.tile(np.asarray(glucose), (R, 1)),
            np.tile(np.asarray(cpeptide), (R, 1)), np.tile(kin, (R, 1)))


def assert_grads_close(got, ref):
    """Each gradient row within GRAD_ATOL of its largest |entry|
    (``tests/test_pallas_grad.py:61-64``)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.maximum(np.abs(ref).max(-1, keepdims=True), 1e-6)
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("name", list(NETS))
def test_rk4_screen_and_lanes_match_pallas(name):
    """K1 and K4 (or K1c and K4c) against JAX's population and cohort RK4
    kernels."""
    net, jnet, jc, nn, betas, kin, port = case(name)
    before = (rk4_population.launches, rk4_cohort.launches)
    out = rk4_population.population_sse(net, *port, SUBSTEPS).numpy()
    ref = np.asarray(population_sse_pallas(
        jnet, jnp.asarray(nn), jnp.asarray(betas), jc, SUBSTEPS,
        interpret=True))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, rtol=RK4_RTOL, atol=RK4_ATOL)

    lanes = _lanes(nn, betas, jc.individuals.glucose, jc.cpeptide, kin)
    out = rk4_cohort.cohort_sse(
        net, *(torch.as_tensor(np.array(a, np.float32)) for a in lanes), TP,
        SUBSTEPS).numpy()
    ref = np.asarray(cohort_sse_pallas(
        jnet, *(jnp.asarray(a) for a in lanes), TP, SUBSTEPS,
        interpret=True))
    np.testing.assert_allclose(out, ref, rtol=RK4_RTOL, atol=RK4_ATOL)
    # the CPU tensors ran the plain versions: no kernel was launched
    assert (rk4_population.launches, rk4_cohort.launches) == before


@pytest.mark.parametrize("name", list(NETS))
def test_packed_value_and_gradient_match_pallas(name):
    """K2's packed route (or K2c's) against JAX's lane gradient kernel."""
    net, jnet, jc, nn, betas, kin, port = case(name)
    f, gnn, gb = lane_grad.packed_sse_and_grad(net, *port, SUBSTEPS)
    f_r, gnn_r, gb_r = jpg.population_sse_and_grad_pallas(
        jnet, jnp.asarray(nn), jnp.asarray(betas), jc, substeps=SUBSTEPS,
        interpret=True)
    assert gnn.shape == (R, net.num_params) and gb.shape == (R, N)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_r), rtol=GRAD_RTOL)
    assert_grads_close(gnn, gnn_r)
    assert_grads_close(gb, gb_r)
    # every weight of every layer has a live gradient
    assert (gnn.abs() > 0).all()


def _tsit5_pallas(jnet, jc, nn, betas, kin):
    lanes = _lanes(nn, betas, jc.individuals.glucose, jc.cpeptide, kin)
    s, ok = cohort_sse_tsit5_pallas(jnet, *(jnp.asarray(a) for a in lanes),
                                    TP, interpret=True)
    return np.asarray(s).reshape(R, N), np.asarray(ok).reshape(R, N)


@pytest.mark.parametrize("name", list(NETS))
def test_tsit5_matches_pallas(name):
    """K3 (or K3c) against JAX's Pallas Tsit5 kernel: the same ``ok`` mask,
    inf where not ok, the SSEs at the JAX suite's Tsit5 tolerance or, on a
    lane outside it, within twice JAX's own move under β ± one ulp."""
    net, jnet, jc, nn, betas, kin, port = case(name)
    sse, ok = tsit5_cohort.cohort_sse_tsit5(net, *port)
    s_ref, ok_ref = _tsit5_pallas(jnet, jc, nn, betas, kin)
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    assert ok_ref.all()
    got = sse.numpy()
    outside = np.abs(got - s_ref) > TSIT5_ATOL + TSIT5_RTOL * np.abs(s_ref)
    if outside.any():
        moves = [np.abs(_tsit5_pallas(jnet, jc, nn, np.nextafter(
            betas, np.float32(d)), kin)[0] - s_ref) for d in (np.inf, -np.inf)]
        spread = np.maximum(*moves)
        np.testing.assert_array_less(np.abs(got - s_ref)[outside],
                                     2 * spread[outside])
    assert outside.sum() <= 1
