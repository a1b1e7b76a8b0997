"""PyTorch port: the 69-point form of the RK4 SSE kernels K1 and K4.

The production term does not depend on the state, so K1 and K4 (and their
plain versions, through ``ops/rk4_cohort.py::rk4_point_sse``) evaluate the
network once at each of the 1 + n_seg·(2·substeps + 1) points that K2
evaluates, and each RK4 step takes three of them.  Held here on the CPU:
the number of evaluations a lane, the values at the points against K2's
plain forward (bit for bit), K1 against the in-order mean of K4's lanes
(bit for bit), and both bodies of each against the JAX package's Pallas
kernels in interpret mode on a ragged grid (rtol 1e-5 / atol 1e-6, the JAX
suite's RK4 kernel tolerance).  Inputs come from numpy generators with the
seed stated in each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.ops.pallas_rk4 import (
    cohort_kinetics,
    cohort_sse_pallas,
    population_sse_pallas,
)
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import (
    lane_grad,
    population_grad,
    rk4_cohort,
    rk4_population,
)

RTOL, ATOL = 1e-5, 1e-6
OGTT = ((0.0, 30.0, 60.0, 90.0, 120.0), 8)       # the Ohashi grid
# 3 segments of uneven spans from before t = 0 (ΔG from the t = 0 blend),
# 5 substeps: 1/(2·substeps) = 0.1 is not a float32 number
RAGGED = ((-10.0, 15.0, 40.0, 70.0), 5)
G, N = 7, 6


def _huge(input_dims):
    """ΔG-to-head weights of 1e20: on a rising glucose curve the trajectory
    leaves float32, so the restart's SSE is inf."""
    w1 = np.zeros((4, input_dims))
    w1[:, 0] = 1e20
    return np.concatenate([w1.ravel(), np.zeros(4), np.eye(4).ravel(),
                           np.zeros(4), np.full(4, 1e20), [0.0]])


def _case(seed, input_dims, grid):
    """G restarts (Glorot-scale weights, the last one huge) with β's on an
    N-subject cohort on ``grid``; the last subject's glucose rises.  The age
    is scaled by 1/100 after the kinetics are made, as the JAX suite's
    covariate tests scale it, so that the first layer is not saturated."""
    tp, _ = grid
    k = len(tp)
    rng = np.random.default_rng(seed)
    net = chain(4, 2, input_dims=input_dims)
    parts = []
    for fi, fo in net.layer_dims:
        b = np.sqrt(6.0 / (fi + fo))
        parts += [rng.uniform(-b, b, (G, fo * fi)),
                  rng.uniform(-0.1, 0.1, (G, fo))]
    nn = np.concatenate(parts, axis=1).astype(np.float32)
    nn[-1] = _huge(input_dims)
    glucose = 5.0 + rng.uniform(0, 5, (N, k))
    glucose[-1] = np.linspace(5.0, 9.0, k)
    jc = jcp.build_cohort(glucose, np.asarray(tp),
                          0.5 + rng.uniform(0, 1.5, (N, k)),
                          rng.uniform(30, 70, N), rng.uniform(size=N) > 0.5)
    kin = np.array(cohort_kinetics(jc, with_age=input_dims == 3))
    if input_dims == 3:
        kin[:, 4] /= 100.0
    betas = rng.uniform(-2.0, 0.0, (G, N)).astype(np.float32)
    t = lambda a: torch.as_tensor(np.array(a, np.float32))  # noqa: E731
    port = (t(nn), t(betas), t(jc.individuals.glucose), t(jc.cpeptide), t(kin))
    return net, jc, (nn, betas, kin), port


def _lanes(port):
    """K1's inputs as K4's (restart × individual) lanes, restart-major."""
    nn, betas, glucose, data, kin = port
    p = nn.shape[1]
    return (nn[:, None].expand(G, N, p).reshape(-1, p), betas.reshape(-1),
            glucose.repeat(G, 1), data.repeat(G, 1), kin.repeat(G, 1))


@pytest.fixture
def recorded(monkeypatch):
    """Every network evaluation of the plain versions, in call order."""
    calls = []
    call = rk4_cohort.PointNetwork.__call__

    def record(self, dg):
        out = call(self, dg)
        calls.append(out)
        return out

    monkeypatch.setattr(rk4_cohort.PointNetwork, "__call__", record)
    return calls


@pytest.mark.parametrize("input_dims", [2, 3])
@pytest.mark.parametrize("grid", [OGTT, RAGGED], ids=["ogtt", "ragged"])
def test_plain_kernels_evaluate_each_point_once(recorded, grid, input_dims):
    """Seed 21: each plain body calls the network 1 + n_seg·(2·substeps + 1)
    times (69 on the OGTT grid at 8 substeps, 34 on the ragged grid at 5),
    each call over every lane at once."""
    tp, substeps = grid
    net, _, _, port = _case(21, input_dims, grid)
    points = 1 + (len(tp) - 1) * (2 * substeps + 1)
    assert points == {OGTT: 69, RAGGED: 34}[grid]
    rk4_population.population_sse(net, *port, tp, substeps)
    assert len(recorded) == points and recorded[0].shape == (G, N)
    recorded.clear()
    rk4_cohort.cohort_sse(net, *_lanes(port), tp, substeps)
    assert len(recorded) == points and recorded[0].shape == (G * N,)


@pytest.mark.parametrize("input_dims", [2, 3])
@pytest.mark.parametrize("grid", [OGTT, RAGGED], ids=["ogtt", "ragged"])
def test_points_equal_k2s_forward_bit_for_bit(recorded, grid, input_dims):
    """Seed 22: the network values of plain K1 and plain K4 at their points
    are those of K2's plain forward on the same inputs, point for point, bit
    for bit (K4's lanes restart-major)."""
    tp, substeps = grid
    net, _, _, port = _case(22, input_dims, grid)
    lane_grad.lane_sse_and_grad_reference(net, *port, tp, substeps)
    k2 = list(recorded)
    recorded.clear()
    rk4_population.population_sse_reference(net, *port, tp, substeps)
    k1 = list(recorded)
    recorded.clear()
    rk4_cohort.cohort_sse_reference(net, *_lanes(port), tp, substeps)
    k4 = list(recorded)
    assert len(k2) == len(k1) == len(k4)
    for q, (a, b, c) in enumerate(zip(k2, k1, k4)):
        assert torch.equal(a, b), f"K1 point {q}"
        assert torch.equal(a, c.reshape(G, N)), f"K4 point {q}"


@pytest.mark.parametrize("input_dims", [2, 3])
@pytest.mark.parametrize("grid", [OGTT, RAGGED], ids=["ogtt", "ragged"])
def test_k1_is_the_in_order_mean_of_k4s_lanes(grid, input_dims):
    """Seed 23: plain K1 equals plain K4's lanes summed over the individuals
    0..N-1 in order, times float32(1/N), with the inf rule; bit for bit,
    the huge restart's inf included."""
    tp, substeps = grid
    net, _, _, port = _case(23, input_dims, grid)
    k1 = rk4_population.population_sse(net, *port, tp, substeps)
    lanes = rk4_cohort.cohort_sse(net, *_lanes(port), tp, substeps)
    mean = population_grad.sum_in_order(lanes.reshape(G, N)) \
        * np.float32(1.0 / N)
    assert bool(torch.isinf(k1[-1]))
    torch.testing.assert_close(
        k1, torch.where(torch.isfinite(mean), mean, torch.inf), rtol=0,
        atol=0)


@pytest.mark.parametrize("input_dims", [2, 3])
def test_both_bodies_match_pallas_interpret_on_a_ragged_grid(input_dims):
    """Seed 24: K1 (K1c) and K4 (K4c) against the JAX package's Pallas
    kernels in interpret mode on the ragged grid, rtol 1e-5 / atol 1e-6;
    inf in the same places."""
    tp, substeps = RAGGED
    net, jc, (nn, betas, kin), port = _case(24, input_dims, RAGGED)
    jnet = jax_chain(4, 2, "tanh", input_dims=input_dims)
    # the JAX screen reads the age from its cohort: hand it the scaled one
    jcs = jc._replace(individuals=jc.individuals._replace(
        age=jnp.asarray(kin[:, 4]))) if input_dims == 3 else jc
    out = rk4_population.population_sse(net, *port, tp, substeps).numpy()
    ref = np.asarray(population_sse_pallas(jnet, jnp.asarray(nn),
                                           jnp.asarray(betas), jcs, substeps,
                                           interpret=True))
    assert np.isinf(out[-1]) and np.isinf(ref[-1])
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_allclose(out[:-1], ref[:-1], rtol=RTOL, atol=ATOL)

    lanes = _lanes(port)
    out = rk4_cohort.cohort_sse(net, *lanes, tp, substeps).numpy()
    ref = np.asarray(cohort_sse_pallas(
        jnet, *(jnp.asarray(a.numpy()) for a in lanes), tp, substeps,
        interpret=True))
    assert np.isinf(out[-1]) and np.isinf(ref[-1])
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=RTOL, atol=ATOL)
