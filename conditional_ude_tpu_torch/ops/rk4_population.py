"""K1: population mean SSE per restart, the screening pass of joint training
(counterpart of ``conditional_ude_tpu/ops/pallas_rk4.py:251-427``,
``population_sse_pallas``).

A restart is one network ``nn[P]`` and one β per individual.  For each
restart the kernel solves every individual's c-peptide ODE with fixed-step
RK4 over the shared observation grid, sums the SSEs over the individuals
and returns their mean, ``inf`` where it is not finite.  β (and, for the
covariate model's 3-input network, the age) enter only layer 1 of the
network and do not change in time, so the partial pre-activations
``(w1[o][1]·e^β + b1[o]) + w1[o][2]·age`` and the baseline network are
computed once per individual (the JAX kernel's hoisting,
``pallas_rk4.py:290-299``; the plain version hoists at the same place, so
the two agree bit for bit).

:func:`population_sse` launches ``csrc/rk4_population.cu`` for CUDA
tensors and runs :func:`population_sse_reference` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
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
from conditional_ude_tpu_torch.ops.rk4_cohort import (
    _mlp_columns,
    _mlp_forward,
    _segments,
    check_restart_inputs,
    kinetics_columns,
    require_contiguous,
)

SHARED_BYTES = 48 * 1024    # the cohort lives in static-limit shared memory

# kernel launches since import (or since a caller reset them to 0): the
# 2-input body and the 3-input (covariate) body
launches = 0
launches_age = 0

_ARGTYPES = [VP, VP, VP, VP, VP, VP, I64, I32, F32_PTR, I32, I32, I32, F32,
             F32, F32, VP]
kernel = KernelLibrary("rk4_population.cu", "rk4_population_sse", _ARGTYPES)
kernel_age = KernelLibrary("rk4_population.cu", "rk4_population_sse_age",
                           _ARGTYPES)


def population_sse_reference(net: MLP, nn_params, betas, glucose, data,
                             kinetics, timepoints, substeps: int = 8
                             ) -> torch.Tensor:
    """Plain PyTorch version of the kernel over ``[G, N]`` lanes; the sum
    over individuals runs in the kernel's order, first to last."""
    segs, j0, one_minus_w0, w0 = _segments(timepoints, substeps)
    n = betas.shape[1]
    # per-restart weight columns [G, 1], broadcast over the individuals
    (w1, b1), *rest = _mlp_columns(nn_params, net)
    eb = torch.exp(betas)
    k0, k1, k2, c0 = (kinetics[:, i] for i in range(4))

    # hoisted: layer-1 β (and age) partials and the baseline network
    s1 = [w1[o][1] * eb + b1[o] for o in range(len(w1))]
    if kinetics.shape[1] == 5:
        s1 = [s1[o] + w1[o][2] * kinetics[:, 4] for o in range(len(w1))]
    base = _mlp_forward(rest, [torch.tanh(v) for v in s1])
    g_at0 = one_minus_w0 * glucose[:, j0] + w0 * glucose[:, j0 + 1]
    decay = -(k0 + k2)
    inflow = k0 * c0

    def production(dg):
        return _mlp_forward(rest, [torch.tanh(w1[o][0] * dg + s1[o])
                                   for o in range(len(w1))]) - base

    u1 = c0.expand_as(eb)
    u2 = (k2 / k1) * u1
    sse = torch.square(u1 - data[:, 0])
    for s, (t0, dt, half, sixth, inv_span) in enumerate(segs):
        gl, gr = glucose[:, s], glucose[:, s + 1]

        def rhs(t, v1, v2):
            w = (t - t0) * inv_span
            dg = float(np.float32(1.0) - w) * gl + float(w) * gr - g_at0
            return (decay * v1 + k1 * v2 + inflow + production(dg),
                    -k1 * v2 + k2 * v1)

        h, d_t, sx = float(half), float(dt), float(sixth)
        for i in range(substeps):
            t = t0 + np.float32(i) * dt
            a1, a2 = rhs(t, u1, u2)
            b1_, b2_ = rhs(t + half, u1 + h * a1, u2 + h * a2)
            c1, c2 = rhs(t + half, u1 + h * b1_, u2 + h * b2_)
            e1, e2 = rhs(t + dt, u1 + d_t * c1, u2 + d_t * c2)
            u1 = u1 + sx * (a1 + 2.0 * b1_ + 2.0 * c1 + e1)
            u2 = u2 + sx * (a2 + 2.0 * b2_ + 2.0 * c2 + e2)
        sse = sse + torch.square(u1 - data[:, s + 1])
    total = sse[:, 0]
    for i in range(1, n):
        total = total + sse[:, i]
    mean = total * float(np.float32(1.0 / n))
    return torch.where(torch.isfinite(mean), mean, torch.inf)


def population_sse(net: MLP, nn_params: torch.Tensor, betas: torch.Tensor,
                   glucose: torch.Tensor, data: torch.Tensor,
                   kinetics: torch.Tensor, timepoints, substeps: int = 8
                   ) -> torch.Tensor:
    """Population mean SSE ``[G]`` of restarts ``nn_params[G, P]``,
    ``betas[G, N]`` (β, not e^β) on a cohort ``glucose[N, K]``,
    ``data[N, K]``, ``kinetics[N, 4]`` (k0, k1, k2, c0; a 5th column, the
    age, for a 3-input network) over the shared ``timepoints[K]``.  CPU
    tensors run the plain version; CUDA tensors launch the kernel's body
    for the network's input count."""
    check_restart_inputs(net, nn_params, betas, glucose, data, kinetics,
                         timepoints)
    if betas.shape[1] < 1 or substeps < 1:
        raise ValueError("need at least one individual and one substep")
    if betas.device.type == "cpu":
        return population_sse_reference(net, nn_params, betas, glucose, data,
                                        kinetics, timepoints, substeps)
    if betas.device.type != "cuda":
        raise ValueError(f"no population RK4 kernel for device {betas.device}")
    return _launch(net, nn_params, betas, glucose, data, kinetics,
                   timepoints, substeps)


def _launch(net, nn_params, betas, glucose, data, kinetics, timepoints,
            substeps):
    global launches, launches_age
    require_contiguous(nn_params=nn_params, betas=betas, glucose=glucose,
                       data=data, kinetics=kinetics)
    g, n = betas.shape
    k = glucose.shape[1]
    if 4 * n * (2 * k + kinetics_columns(net)) > SHARED_BYTES:
        raise ValueError(f"a cohort of {n} individuals x {k} times does not "
                         f"fit the kernel's {SHARED_BYTES} bytes of shared "
                         "memory")
    out = torch.empty(g, dtype=torch.float32, device=betas.device)
    if g == 0:
        return out
    segs, j0, one_minus_w0, w0 = _segments(timepoints, substeps)
    with torch.cuda.device(betas.device):
        stream = torch.cuda.current_stream(betas.device).cuda_stream
        lib = kernel_age if net.input_dims == 3 else kernel
        lib(nn_params.data_ptr(), betas.data_ptr(), glucose.data_ptr(),
            data.data_ptr(), kinetics.data_ptr(), out.data_ptr(), g, n,
            segs.ctypes.data_as(F32_PTR), segs.shape[0], substeps, j0,
            one_minus_w0, w0, float(np.float32(1.0 / n)), stream)
    if net.input_dims == 3:
        launches_age += 1
    else:
        launches += 1
    return out
