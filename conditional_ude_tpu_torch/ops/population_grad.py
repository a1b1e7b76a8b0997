"""K5: population mean SSE per restart with its exact discrete gradient,
restarts as threads, for multi-starts too wide for the packed lanes of K2
(counterpart of ``conditional_ude_tpu/ops/pallas_grad.py:188-311``,
``_build_population_grad_kernel``, and ``_population_sse_and_grad_impl``).

The mathematics is K2's (``ops/lane_grad.py``): the affine matrix-form RK4,
the adjoint recursion over the residuals and one hand VJP of the network
per evaluation point.  What differs is the layout: one thread per restart
loops over the individuals, carries the restart's ∇nn accumulators across
that loop, writes ∇β per individual and applies 1/N itself, so the outputs
are ``(f[R], gnn[R, P], gb[R, N])`` and no ``[R, N, P]`` array exists.

The order of every sum is the JAX kernel's (``pallas_grad.py:273-309``): the
∇nn accumulators start at 0 and run over the individuals 0..N−1 with no
per-individual partial sum; within an individual the segments last to
first, the points of a segment first to last, and the ΔG = 0 baseline
(weight −Σw, the weights summed in that same order) last; each production
is ``kc + (out − base)``; an individual's SSE is added to the running
total; 1/N multiplies last.  K2 sums per lane and then over individuals, so
the two routes agree to float32 reassociation, not bit for bit.

:func:`restart_sse_and_grad` launches ``csrc/population_grad.cu`` for CUDA
tensors and runs :func:`restart_sse_and_grad_reference`, the same
arithmetic in the same order on ``[R]`` tensors, for CPU tensors.
``lane_grad.population_sse_and_grad`` calls it above ``PACK_MAX_LANES``.
"""

from __future__ import annotations

import torch

from conditional_ude_tpu_torch.nn import MLP
from conditional_ude_tpu_torch.ops.cuda_build import (
    F32,
    F32_PTR,
    I32,
    I64,
    VP,
    KernelLibrary,
)
from conditional_ude_tpu_torch.ops.lane_grad import (
    MAX_SUBSTEPS,
    PointNetwork,
    _adjoint_weights,
    _stage_matrices,
    grid_constants,
)
from conditional_ude_tpu_torch.ops.rk4_cohort import (
    _mlp_rows,
    _segments,
    check_restart_inputs,
    kinetics_columns,
    require_contiguous,
)
from conditional_ude_tpu_torch.ops.rk4_population import SHARED_BYTES
from conditional_ude_tpu_torch.ops.tsit5 import f32

# kernel launches since import (or since a caller reset them to 0): the
# 2-input body and the 3-input (covariate) body
launches = 0
launches_age = 0

_ARGTYPES = [VP, VP, VP, VP, VP, VP, VP, VP, I64, I32, F32_PTR, I32, I32, I32,
             F32, VP]
kernel = KernelLibrary("population_grad.cu", "population_sse_and_grad",
                       _ARGTYPES)
kernel_age = KernelLibrary("population_grad.cu",
                           "population_sse_and_grad_age", _ARGTYPES)


def restart_sse_and_grad_reference(net: MLP, nn_params, betas, glucose, data,
                                   kinetics, timepoints, substeps: int = 8):
    """Plain PyTorch version of the kernel: ``(f[R], gnn[R, P], gb[R, N])``
    on ``[R]`` tensors, the individuals looped here as the kernel's thread
    loops them, every sum in the kernel's order."""
    consts = grid_constants(timepoints, substeps)
    _, j0, _, _ = _segments(timepoints, substeps)
    one_minus_w0, w0, inv_2s = consts[:3].tolist()
    rc = consts[3:6].tolist()
    n_seg = len(timepoints) - 1
    q_seg = 2 * substeps + 1
    n_ind = betas.shape[1]
    inv_n = f32(1.0 / n_ind)
    layers = _mlp_rows(nn_params, net)
    blend = [(f32(1.0 - f32(q * inv_2s)), f32(q * inv_2s))
             for q in range(q_seg)]

    gacc = torch.zeros_like(nn_params)
    total = torch.zeros_like(betas[:, 0])
    gb = []
    for n in range(n_ind):
        k0, k1, k2, c0 = (kinetics[n, i] for i in range(4))
        extra = [kinetics[n, 4]] if kinetics.shape[1] == 5 else []  # the age
        eb = torch.exp(betas[:, n])                                  # [R]
        mlp = PointNetwork(layers, eb, extra)
        g, d = glucose[n], data[n]
        g_at0 = one_minus_w0 * g[j0] + w0 * g[j0 + 1]
        kc = k0 * c0
        dgs = [[a * g[s] + b * g[s + 1] - g_at0 for a, b in blend]
               for s in range(n_seg)]

        # forward: matrix-form RK4, the productions taken as out − base
        base = mlp(torch.zeros_like(g_at0))
        u1 = c0.expand_as(eb)
        u2 = (k2 / k1) * u1
        res = [u1 - d[0]]
        for s in range(n_seg):
            seg = consts[6 + 6 * s: 12 + 6 * s].tolist()
            r_m, m_a, m_mid, m_d = _stage_matrices(k0, k1, k2, seg, rc)
            prods = [mlp(dg) - base for dg in dgs[s]]
            for i in range(substeps):
                ra = kc + prods[2 * i]
                rm = kc + prods[2 * i + 1]
                rd = kc + prods[2 * i + 2]
                n1 = (r_m[0] * u1 + r_m[1] * u2 + m_a[0] * ra + m_mid[0] * rm
                      + m_d[0] * rd)
                n2 = (r_m[2] * u1 + r_m[3] * u2 + m_a[2] * ra + m_mid[2] * rm
                      + m_d[2] * rd)
                u1, u2 = n1, n2
            res.append(u1 - d[s + 1])
        sse = res[0] * res[0]
        for r in res[1:]:
            sse = sse + r * r

        # backward: segments last to first, the baseline last
        wts = _adjoint_weights(consts, k0, k1, k2, res, n_seg, substeps)
        w_tot = torch.zeros_like(eb)
        deb = torch.zeros_like(eb)
        for s in range(n_seg - 1, -1, -1):
            for q in range(q_seg):
                wq = wts[1 + s * q_seg + q]
                contrib, dh_eb = mlp.vjp(dgs[s][q], wq)
                gacc = gacc + contrib
                deb = deb + dh_eb
                w_tot = w_tot + wq
        contrib, dh_eb = mlp.vjp(torch.zeros_like(g_at0), -w_tot)
        gacc = gacc + contrib
        deb = deb + dh_eb

        gb.append(deb * eb * inv_n)
        total = total + sse
    mean = total * inv_n
    f = torch.where(torch.isfinite(mean), mean, torch.inf)
    return f, gacc * inv_n, torch.stack(gb, dim=1)


def restart_sse_and_grad(net: MLP, nn_params: torch.Tensor,
                         betas: torch.Tensor, glucose: torch.Tensor,
                         data: torch.Tensor, kinetics: torch.Tensor,
                         timepoints, substeps: int = 8):
    """``(f[R], gnn[R, P], gb[R, N])`` of restarts ``nn_params[R, P]``,
    ``betas[R, N]`` on a cohort ``glucose[N, K]``, ``data[N, K]``,
    ``kinetics[N, 4]`` (``[N, 5]`` with the age for a 3-input network): the
    population mean SSE per restart (``inf`` where it is not finite) and
    its gradient, 1/N applied.  CPU tensors run the plain version; CUDA
    tensors launch the kernel's body for the network's input count."""
    check_restart_inputs(net, nn_params, betas, glucose, data, kinetics,
                         timepoints)
    if betas.shape[1] < 1 or not 1 <= substeps <= MAX_SUBSTEPS:
        raise ValueError("need at least one individual and substeps in "
                         f"1..{MAX_SUBSTEPS}")
    if betas.device.type == "cpu":
        return restart_sse_and_grad_reference(net, nn_params, betas, glucose,
                                              data, kinetics, timepoints,
                                              substeps)
    if betas.device.type != "cuda":
        raise ValueError(f"no restart value+grad kernel for device "
                         f"{betas.device}")
    return _launch(net, nn_params, betas, glucose, data, kinetics,
                   timepoints, substeps)


def _launch(net, nn_params, betas, glucose, data, kinetics, timepoints,
            substeps):
    global launches, launches_age
    require_contiguous(nn_params=nn_params, betas=betas, glucose=glucose,
                       data=data, kinetics=kinetics)
    r, n = betas.shape
    k = glucose.shape[1]
    if 4 * n * (2 * k + kinetics_columns(net)) > SHARED_BYTES:
        raise ValueError(f"a cohort of {n} individuals x {k} times does not "
                         f"fit the kernel's {SHARED_BYTES} bytes of shared "
                         "memory")
    opts = dict(dtype=torch.float32, device=betas.device)
    f = torch.empty(r, **opts)
    gnn = torch.empty(r, nn_params.shape[1], **opts)
    gb = torch.empty(r, n, **opts)
    if r == 0:
        return f, gnn, gb
    _, j0, _, _ = _segments(timepoints, substeps)
    consts = grid_constants(timepoints, substeps)
    with torch.cuda.device(betas.device):
        stream = torch.cuda.current_stream(betas.device).cuda_stream
        lib = kernel_age if net.input_dims == 3 else kernel
        lib(nn_params.data_ptr(), betas.data_ptr(), glucose.data_ptr(),
            data.data_ptr(), kinetics.data_ptr(), f.data_ptr(),
            gnn.data_ptr(), gb.data_ptr(), r, n,
            consts.ctypes.data_as(F32_PTR), len(timepoints) - 1, substeps, j0,
            f32(1.0 / n), stream)
    if net.input_dims == 3:
        launches_age += 1
    else:
        launches += 1
    return f, gnn, gb
