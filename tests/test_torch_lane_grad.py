"""PyTorch port: the value + gradient kernel K2 (``ops/lane_grad.py``).

On the CPU its wrapper runs the plain PyTorch version (the kernel's
arithmetic in tensor code, not autograd).  It is held against the JAX
package's Pallas kernel in interpret mode, against torch autograd through
the plain RK4, and against central differences.  The CUDA kernel is held
against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.ops.pallas_grad import population_sse_and_grad_pallas
from conditional_ude_tpu.ops.pallas_rk4 import cohort_kinetics
from conditional_ude_tpu_torch.fit.losses import population_sse
from conditional_ude_tpu_torch.models.cpeptide import CPeptideModel, build_cohort
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import lane_grad
from conditional_ude_tpu_torch.parallel import make_mesh
from conditional_ude_tpu_torch.parallel.mesh import sharded_population_vg

R, N = 3, 5
TP = (0.0, 30.0, 60.0, 90.0, 120.0)
RTOL, GRAD_ATOL = 1e-4, 2e-4     # tests/test_pallas_grad.py


def _assert_grads_close(got, ref):
    """Rows divided by their largest |reference| entry, within 2e-4
    (``tests/test_pallas_grad.py:61-64``)."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-6)
    np.testing.assert_allclose(got / scale, ref / scale, atol=GRAD_ATOL)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    raw = (5.0 + rng.uniform(0, 5, (N, 5)), np.asarray(TP),
           0.5 + rng.uniform(0, 1.5, (N, 5)), rng.uniform(30, 70, N),
           rng.uniform(size=N) > 0.5)
    jc = jcp.build_cohort(*raw)
    jnet = jax_chain(4, 2, "tanh", input_dims=2)
    nn = np.array(jnet.init_batch(jax.random.key(5), R))
    betas = rng.uniform(-2.0, 0.0, (R, N)).astype(np.float32)
    kin = np.asarray(cohort_kinetics(jc, with_age=False))
    t = lambda a: torch.as_tensor(np.array(a, np.float32))  # noqa: E731
    cohort_args = (t(jc.individuals.glucose), t(jc.cpeptide), t(kin), TP)
    return jnet, jc, raw, nn, betas, cohort_args


def test_plain_matches_pallas_interpret(case):
    jnet, jc, _, nn, betas, cohort_args = case
    before = lane_grad.launches
    f, gnn, gb = lane_grad.population_sse_and_grad(
        chain(4, 2), torch.as_tensor(nn), torch.as_tensor(betas),
        *cohort_args, 8)
    assert lane_grad.launches == before        # the CPU path launches nothing
    f_r, gnn_r, gb_r = population_sse_and_grad_pallas(
        jnet, jnp.asarray(nn), jnp.asarray(betas), jc, substeps=8,
        interpret=True)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_r), rtol=RTOL)
    _assert_grads_close(gnn, gnn_r)
    _assert_grads_close(gb, gb_r)


def test_plain_matches_autograd_through_plain_rk4(case):
    _, _, raw, nn, betas, cohort_args = case
    cohort = build_cohort(*raw, "cpu")
    x = torch.as_tensor(nn).requires_grad_(True)
    b = torch.as_tensor(betas).requires_grad_(True)
    f_ad = population_sse(CPeptideModel(chain(4, 2)), x[:, None, :], b,
                          cohort, substeps=8)
    f_ad.sum().backward()
    f, gnn, gb = lane_grad.population_sse_and_grad(
        chain(4, 2), torch.as_tensor(nn), torch.as_tensor(betas),
        *cohort_args, 8)
    np.testing.assert_allclose(f.numpy(), f_ad.detach().numpy(), rtol=RTOL)
    _assert_grads_close(gnn, x.grad)
    _assert_grads_close(gb, b.grad)


def test_finite_difference_spotcheck(case):
    _, _, _, nn, betas, cohort_args = case
    nn0, b0 = torch.as_tensor(nn[0]), torch.as_tensor(betas[0])
    eps = 1e-3
    e1 = torch.zeros(37)
    e1[0] = eps
    e2 = torch.zeros(37)
    e2[36] = eps
    eb = torch.zeros(N)
    eb[2] = eps
    nn_l = torch.stack([nn0 + e1, nn0 - e1, nn0 + e2, nn0 - e2, nn0, nn0, nn0])
    b_l = torch.stack([b0, b0, b0, b0, b0 + eb, b0 - eb, b0])
    f, gnn, gb = lane_grad.population_sse_and_grad(chain(4, 2), nn_l, b_l,
                                                   *cohort_args, 8)
    for fd, g in (((f[0] - f[1]) / (2 * eps), gnn[6, 0]),
                  ((f[2] - f[3]) / (2 * eps), gnn[6, 36]),
                  ((f[4] - f[5]) / (2 * eps), gb[6, 2])):
        assert abs(float(fd) - float(g)) <= 2e-2 * max(1.0, abs(float(fd)))


def test_population_sse_backward_scales_the_saved_gradients(case):
    _, _, _, nn, betas, cohort_args = case
    f, gnn, gb = lane_grad.population_sse_and_grad(
        chain(4, 2), torch.as_tensor(nn), torch.as_tensor(betas),
        *cohort_args, 8)
    x = torch.as_tensor(nn).requires_grad_(True)
    b = torch.as_tensor(betas).requires_grad_(True)
    # training's value+grad, one shard on the CPU
    vg = sharded_population_vg(chain(4, 2), cohort_args,
                               make_mesh(devices=["cpu"]))
    out = lane_grad.PopulationSSE.apply(x, b, vg)
    torch.testing.assert_close(out, f, rtol=0, atol=0)
    w = torch.tensor([0.5, -2.0, 3.0])
    dx, db = torch.autograd.grad(out, (x, b), grad_outputs=w)
    torch.testing.assert_close(dx, w[:, None] * gnn, rtol=0, atol=0)
    torch.testing.assert_close(db, w[:, None] * gb, rtol=0, atol=0)


def test_diverging_restart_is_inf(case):
    _, _, _, nn, betas, (glucose, data, kin, tp) = case
    rising = glucose.clone()
    rising[-1] = torch.tensor([5.0, 6.0, 7.0, 8.0, 9.0])
    huge = torch.zeros(37)
    huge[[0, 2, 4, 6]] = 1e20
    huge[12:28:5] = 1.0
    huge[32:36] = 1e20
    nn_h = torch.cat([torch.as_tensor(nn[:1]), huge[None]])
    f, _, _ = lane_grad.population_sse_and_grad(
        chain(4, 2), nn_h, torch.as_tensor(betas[:2]), rising, data, kin,
        tp, 8)
    assert bool(torch.isfinite(f[0])) and bool(torch.isinf(f[1]))


def test_grid_constants():
    c = lane_grad.grid_constants(TP, 8)
    dt = 30.0 / 8
    np.testing.assert_array_equal(
        c[:12], np.float32([1.0, 0.0, 1.0 / 16, 0.5, 1.0 / 6, 1.0 / 24,
                            dt, dt / 6, dt / 12, dt / 24, dt / 3, 2 * dt / 3]))
    assert c.shape == (6 + 6 * 4,)


def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    _, _, _, nn, betas, cohort_args = case
    args = (torch.as_tensor(nn), torch.as_tensor(betas), *cohort_args)
    with pytest.raises(ValueError):
        lane_grad.lane_sse_and_grad(chain(4, 2), *args, 17)   # > 16 substeps
    with pytest.raises(ValueError):
        lane_grad.lane_sse_and_grad(chain(4, 2), args[0][:2], *args[1:], 8)
    with pytest.raises(ValueError):
        lane_grad.lane_sse_and_grad(chain(8, 2), torch.zeros(R, 113),
                                    *args[1:], 8)
