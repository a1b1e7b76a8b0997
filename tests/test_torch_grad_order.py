"""PyTorch port: the order of the sums in the value+gradient kernels K2 and
K5 (``ops/lane_grad.py``, ``ops/population_grad.py``).

K2 gives a (restart, individual) lane one warp: thread t sums the hand VJPs
of points t, t + 32, t + 64, ... and the warp then sums its 32 threads in a
fixed order (``lane_grad.lane_sum``).  K5 gives a restart one block and sums
its lanes over the individuals 0..N−1 in order.  On the CPU these tests
hold, at grids of 13, 21, 69 and 133 evaluation points (not multiples of
32):

- K5's plain version is K2's plain lanes summed over the individuals in
  order, bit for bit (``torch.equal``);
- the warp's order loses no accuracy: on the same float32 per-point terms
  it lies within 8 float32 roundings (2⁻²³) of a row's largest sum of
  |terms| from their float64 sum;
- the one-thread order of the earlier kernel (the points first to last)
  agrees with it within 1e-6 of that scale, and is the same order, bit for
  bit, while a lane has no more than 32 points.

A last test holds how a kernel's library reads its entry point's return,
the refusal of a cohort too large for K5's block included.

The kernels are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools
import operator

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu_torch.models.cpeptide import build_cohort
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import cuda_build, lane_grad, population_grad

TP = (0.0, 30.0, 60.0, 90.0, 120.0)
EPS32 = 2.0 ** -23


def _case(d, r, n, seed=11):
    """r restarts of Glorot weights (scaled by 0.5-3) on n random subjects
    with real ages; the kinetics carry the age for 3 inputs."""
    rng = np.random.default_rng(seed + 10 * d + n)
    net = chain(4, 2, input_dims=d)
    parts = []
    for fi, fo in net.layer_dims:
        b = np.sqrt(6.0 / (fi + fo))
        parts += [rng.uniform(-b, b, (r, fo * fi)) * rng.uniform(0.5, 3.0, (r, 1)),
                  np.zeros((r, fo))]
    cohort = build_cohort(5.0 + rng.uniform(0, 5, (n, 5)), np.asarray(TP),
                          0.5 + rng.uniform(0, 1.5, (n, 5)),
                          rng.uniform(30, 70, n), rng.uniform(size=n) > 0.5,
                          "cpu")
    f32 = dict(dtype=torch.float32)
    return net, (torch.as_tensor(np.concatenate(parts, axis=1), **f32),
                 torch.as_tensor(rng.uniform(-2.0, 0.0, (r, n)), **f32),
                 cohort.glucose, cohort.cpeptide,
                 cohort.kinetics(with_age=d == 3), TP)


@pytest.mark.parametrize("n", [5, 13])
@pytest.mark.parametrize("substeps", [1, 2, 8])
@pytest.mark.parametrize("d", [2, 3])
def test_restart_plain_is_the_lanes_summed_in_order(d, substeps, n):
    net, args = _case(d, 6, n)
    f, gnn, gb = population_grad.restart_sse_and_grad_reference(
        net, *args, substeps)
    sse, l_gnn, l_gb = lane_grad.lane_sse_and_grad_reference(net, *args,
                                                             substeps)
    inv_n = np.float32(1.0 / n)
    total, grads = sse[:, 0], l_gnn[:, 0]
    for i in range(1, n):
        total, grads = total + sse[:, i], grads + l_gnn[:, i]
    assert bool(torch.isfinite(f).all())
    assert torch.equal(f, total * inv_n)
    assert torch.equal(gnn, grads * inv_n)
    assert torch.equal(gb, l_gb * inv_n)


def _terms(d, substeps):
    net, args = _case(d, 8, 13, seed=29)
    return lane_grad.lane_terms(net, *args, substeps)[2]


def _scale(terms):
    """Each row's largest sum of |terms|, in float64."""
    mag = functools.reduce(operator.add, [t.double().abs() for t in terms])
    return mag.amax(-1, keepdim=True)


@pytest.mark.parametrize("substeps", [2, 8, 16])
@pytest.mark.parametrize("d", [2, 3])
def test_warp_order_loses_no_accuracy(d, substeps):
    terms = _terms(d, substeps)
    exact = functools.reduce(operator.add, [t.double() for t in terms])
    got = lane_grad.lane_sum(terms)
    assert got.dtype == torch.float32 and got.shape == exact.shape
    worst = float(((got.double() - exact).abs() / _scale(terms)).amax())
    assert worst <= 8 * EPS32, worst / EPS32


@pytest.mark.parametrize("substeps", [1, 2, 8])
@pytest.mark.parametrize("d", [2, 3])
def test_one_thread_order_agrees_with_the_warp_order(d, substeps):
    terms = _terms(d, substeps)
    sequential = functools.reduce(operator.add, terms)
    warp = lane_grad.lane_sum(terms)
    if len(terms) <= lane_grad.WARP:      # one point a thread: one order
        assert torch.equal(warp, sequential)
    worst = float(((warp.double() - sequential.double()).abs()
                   / _scale(terms)).amax())
    assert worst <= 1e-6, worst


@pytest.mark.parametrize("code,error", [(-232_452, ValueError),
                                        (1, RuntimeError), (0, None)])
def test_a_kernel_library_raises_for_what_its_entry_point_returns(code,
                                                                  error):
    """A C entry point returns 0, a CUDA error (``RuntimeError``) or minus
    the bytes of shared memory a block its inputs need where the card has
    fewer (``ValueError``, as K5 does for a cohort past 227 KB)."""
    lib = cuda_build.KernelLibrary("population_grad.cu", "entry", [])
    lib._fn = lambda *args: code           # no build: the return alone
    if error is None:
        lib()
    else:
        with pytest.raises(error, match="232452 bytes" if code < 0 else ""):
            lib()
