"""K2: population SSE with its exact discrete gradient, for every Adam step
and every L-BFGS trial of joint training (counterpart of
``conditional_ude_tpu/ops/pallas_grad.py:314-473``,
``_build_lane_grad_kernel``, and ``population_sse_and_grad_pallas``).

The production term depends on time and parameters but not on the state,
so the c-peptide ODE is affine in the state and one RK4 step is

    v ← R·v + M_a·r(t) + M_mid·r(t + dt/2) + M_d·r(t + dt)

with 2×2 stage matrices of the kinetics (``_stage_matrices``).  A lane is
one (restart, individual) pair, and the kernel gives it one warp.  Its
forward pass needs the network at 1 + n_seg·(2·substeps + 1) points (69 on
the OGTT grid; row 0 is the ΔG = 0 baseline), spread over the warp's 32
threads; an adjoint recursion over the five residuals gives each point's
weight (the baseline's is −Σw), and one hand VJP per point gives ∇nn[P]
(37 weights for the canonical ``chain(4, 2)``; any network of tanh
layers with a softplus head, one library a shape) and
∇β = (Σ_q ∂/∂e^β)·e^β, each thread summing its own points and the warp
then summing its threads in a fixed order (:func:`lane_sum`, at any
width: past 127 weights the kernel sums the columns in passes of 128).  That order is not the JAX kernel's, so the
port agrees with JAX's K2 to float32 reassociation.  The covariate
model's network takes the age as a third input (the kinetics' 5th
column): ∇nn gains a weight a first-layer unit (41 entries for
``chain(4, 2)``), w1[o][2]'s being Σ_q dz1[o]·age, and ∇β is unchanged
(``pallas_grad.py:457-471``).  The sum over individuals runs outside the
kernel
(:func:`packed_sse_and_grad`), as in the JAX package;
:func:`population_sse_and_grad` takes that route up to ``PACK_MAX_LANES``
lanes and the restart kernel K5 (``ops/population_grad.py``) above.

:func:`lane_sse_and_grad` launches ``csrc/lane_grad.cu`` for CUDA tensors
and runs :func:`lane_sse_and_grad_reference`, the same arithmetic as plain
tensor code over a leading lane axis, for CPU tensors.
:class:`PopulationSSE` puts a value+grad under autograd: its forward
evaluates once and its backward scales the saved gradients.
"""

from __future__ import annotations

import numpy as np
import torch

from conditional_ude_tpu_torch.nn import MLP
from conditional_ude_tpu_torch.ops.cuda_build import (
    F32_PTR,
    I32,
    I64,
    VP,
    KernelLibrary,
    count_launch,
    device_table,
    launch_total,
    long_grid,
)
from conditional_ude_tpu_torch.ops.rk4_cohort import (
    PointNetwork,
    _mlp_columns,
    _segments,
    check_restart_inputs,
    point_dgs,
    require_contiguous,
)
from conditional_ude_tpu_torch.ops.tsit5 import f32

WARP = 32          # threads that share a lane's evaluation points
# above this many (restart × individual) lanes the restart kernel takes over
# (``pallas_grad.py:550-553``)
PACK_MAX_LANES = 131072

# kernel launches since import (or since a caller cleared it), by network
# shape: ``{(input_dims, hidden widths): launches}``; ``launches`` and
# ``launches_age`` are its totals for the 2-input and the 3-input body
shape_launches: dict = {}


def __getattr__(name: str) -> int:
    return launch_total(shape_launches, name, __name__)

_ARGTYPES = [VP, VP, VP, VP, VP, VP, VP, VP, I64, I32, F32_PTR, VP, I32, I32,
             I32, VP, VP]
kernel = KernelLibrary("lane_grad.cu", "lane_sse_and_grad", _ARGTYPES)
kernel_age = KernelLibrary("lane_grad.cu", "lane_sse_and_grad_age",
                           _ARGTYPES)


def grid_constants(timepoints, substeps: int) -> np.ndarray:
    """Host float32 constants of the kernel: ``[1 − w0, w0, 1/(2·substeps),
    1/2, 1/6, 1/24]`` then per segment ``[dt, c, c/2, c/4, 2c, 4c]`` with
    c = dt/6, each rounded once from float64 as the JAX kernel's Python
    floats are."""
    _, j0, one_minus_w0, w0 = _segments(timepoints, substeps)
    ts = np.asarray(timepoints, np.float64)
    head = [one_minus_w0, w0, 1.0 / (2.0 * substeps), 0.5, 1.0 / 6.0,
            1.0 / 24.0]
    segs = []
    for s in range(ts.shape[0] - 1):
        dt = (float(ts[s + 1]) - float(ts[s])) / substeps
        c = dt / 6.0
        segs += [dt, c, 0.5 * c, 0.25 * c, 2.0 * c, 4.0 * c]
    return np.asarray(head + segs, np.float32)


def _mm(x, y):
    x11, x12, x21, x22 = x
    y11, y12, y21, y22 = y
    return (x11 * y11 + x12 * y21, x11 * y12 + x12 * y22,
            x21 * y11 + x22 * y21, x21 * y12 + x22 * y22)


def _stage_matrices(k0, k1, k2, seg, rc):
    """(R, M_a, M_mid, M_d) of one RK4 step of v' = A v + r(t), in the JAX
    kernel's order of operations (``pallas_grad.py:109-121``)."""
    dt, c, hc, qc, c2, c4 = seg
    half, sixth, t24 = rc
    b = (dt * -(k0 + k2), dt * k1, dt * k2, dt * -k1)
    b2 = _mm(b, b)
    b3 = _mm(b2, b)
    b4 = _mm(b3, b)
    eye = (1.0, 0.0, 0.0, 1.0)
    r_m = [eye[i] + b[i] + half * b2[i] + sixth * b3[i] + t24 * b4[i]
           for i in range(4)]
    m_a = [c * eye[i] + c * b[i] + hc * b2[i] + qc * b3[i] for i in range(4)]
    m_mid = [c4 * eye[i] + c2 * b[i] + hc * b2[i] for i in range(4)]
    m_d = (c, 0.0, 0.0, c)
    return r_m, m_a, m_mid, m_d


def _adjoint_weights(consts, k0, k1, k2, res, n_seg, substeps):
    """Per-point head weights ``[QT][lanes]`` from the residuals; row 0
    (the baseline) gets −Σ of the others."""
    rc = consts[3:6].tolist()
    q_seg = 2 * substeps + 1
    rows = [None] * (1 + n_seg * q_seg)
    l1 = l2 = torch.zeros_like(res[0])
    for s in range(n_seg - 1, -1, -1):
        seg = consts[6 + 6 * s: 12 + 6 * s].tolist()
        r_m, m_a, m_mid, m_d = _stage_matrices(k0, k1, k2, seg, rc)
        l1 = l1 + 2.0 * res[s + 1]
        w = [None] * q_seg
        for i in range(substeps - 1, -1, -1):
            a = m_a[0] * l1 + m_a[2] * l2
            w[2 * i] = a
            mid = m_mid[0] * l1 + m_mid[2] * l2
            w[2 * i + 1] = mid
            end = m_d[0] * l1 + m_d[2] * l2
            w[2 * i + 2] = end if w[2 * i + 2] is None else w[2 * i + 2] + end
            l1, l2 = r_m[0] * l1 + r_m[2] * l2, r_m[1] * l1 + r_m[3] * l2
        rows[1 + s * q_seg: 1 + (s + 1) * q_seg] = w
    w_tot = rows[1]
    for q in range(2, len(rows)):
        w_tot = w_tot + rows[q]
    rows[0] = -w_tot
    return rows


def lane_sum(terms: list[torch.Tensor]) -> torch.Tensor:
    """Σ of a lane's per-point terms ``terms[q][..., C]`` in the kernels'
    order (``csrc/cude_grad.cuh``, ``warp_lane`` steps 4 and 5): thread t
    adds points t, t + 32, t + 64, ... in increasing order to a sum that
    starts at 0 (zero rows pad the points to a multiple of 32), then column
    c of the 32 threads' sums is added over the threads 0..31 one after
    another."""
    acc = 0.0
    for first in range(0, len(terms), WARP):
        rows = torch.stack(terms[first:first + WARP], dim=-2)
        acc = acc + torch.nn.functional.pad(
            rows, (0, 0, 0, WARP - rows.shape[-2]))
    total = acc[..., 0, :]
    for k in range(1, WARP):
        total = total + acc[..., k, :]
    return total


def lane_terms(net: MLP, nn_params, betas, glucose, data, kinetics,
               timepoints, substeps: int = 8):
    """The plain version's work before its sums over the evaluation points:
    ``(sse[R, N], e^β[R, N], terms)``, where ``terms[q][R, N, P + 1]`` is
    point q's hand VJP, ∇nn then the e^β cotangent."""
    consts = grid_constants(timepoints, substeps)
    n_seg = len(timepoints) - 1
    q_seg = 2 * substeps + 1
    eb = torch.exp(betas)                                         # [R, N]
    k0, k1, k2, c0 = (kinetics[:, i] for i in range(4))
    extra = [kinetics[:, 4]] if kinetics.shape[1] == 5 else []     # the age
    mlp = PointNetwork(_mlp_columns(nn_params, net), eb, extra)

    # ΔG of every evaluation point [QT][N]; row 0 is the baseline ΔG = 0
    dgs = point_dgs(glucose, timepoints, substeps)
    out = [mlp(dg) for dg in dgs]
    base = out[0]
    kc = k0 * c0

    # forward: matrix-form RK4 on the precomputed productions
    rc = consts[3:6].tolist()
    u1 = c0.expand_as(eb)
    u2 = (k2 / k1) * u1
    res = [u1 - data[:, 0]]
    for s in range(n_seg):
        seg = consts[6 + 6 * s: 12 + 6 * s].tolist()
        r_m, m_a, m_mid, m_d = _stage_matrices(k0, k1, k2, seg, rc)
        bq = 1 + s * q_seg
        for i in range(substeps):
            ra = kc + out[bq + 2 * i] - base
            rm = kc + out[bq + 2 * i + 1] - base
            rd = kc + out[bq + 2 * i + 2] - base
            n1 = (r_m[0] * u1 + r_m[1] * u2 + m_a[0] * ra + m_mid[0] * rm
                  + m_d[0] * rd)
            n2 = (r_m[2] * u1 + r_m[3] * u2 + m_a[2] * ra + m_mid[2] * rm
                  + m_d[2] * rd)
            u1, u2 = n1, n2
        res.append(u1 - data[:, s + 1])
    sse = res[0] * res[0]
    for r in res[1:]:
        sse = sse + r * r

    # backward: the adjoint weights, then one hand VJP per point
    wts = _adjoint_weights(consts, k0, k1, k2, res, n_seg, substeps)
    terms = []
    for dg, wq in zip(dgs, wts):
        contrib, dh_eb = mlp.vjp(dg, wq)
        terms.append(torch.cat([contrib, dh_eb[..., None]], dim=-1))
    return sse, eb, terms


def lane_sse_and_grad_reference(net: MLP, nn_params, betas, glucose, data,
                                kinetics, timepoints, substeps: int = 8,
                                magnitudes: bool = False):
    """Plain PyTorch version of the kernel over ``[R, N]`` lanes: per-lane
    ``(sse[R, N], gnn[R, N, P], gb[R, N])`` with every sum in the kernel's
    order; the sums over the evaluation points are :func:`lane_sum`'s.  It
    follows the dtype of its tensors, so float64 inputs give a witness for
    the float32 routes.  With ``magnitudes`` it also returns the sums of the
    absolute per-point terms of both gradients (``[R, N, P]``, ``[R, N]``):
    the scale of a route's rounding error where the terms cancel."""
    sse, eb, terms = lane_terms(net, nn_params, betas, glucose, data,
                                kinetics, timepoints, substeps)
    total = lane_sum(terms)
    if magnitudes:
        mag = lane_sum([t.abs() for t in terms])
        return (sse, total[..., :-1], total[..., -1] * eb, mag[..., :-1],
                mag[..., -1] * eb)
    return sse, total[..., :-1], total[..., -1] * eb


def lane_sse_and_grad(net: MLP, nn_params: torch.Tensor, betas: torch.Tensor,
                      glucose: torch.Tensor, data: torch.Tensor,
                      kinetics: torch.Tensor, timepoints, substeps: int = 8):
    """Per-lane ``(sse[R, N], gnn[R, N, P], gb[R, N])`` of restarts
    ``nn_params[R, P]``, ``betas[R, N]`` on a cohort ``glucose[N, K]``,
    ``data[N, K]``, ``kinetics[N, 4]`` (``[N, 5]`` with the age for a
    3-input network): lane (r, n) is restart r on individual n.  CPU tensors
    run the plain version; CUDA tensors launch the kernel's body for the
    network's input count."""
    check_restart_inputs(net, nn_params, betas, glucose, data, kinetics,
                         timepoints)
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    if betas.device.type == "cpu":
        return lane_sse_and_grad_reference(net, nn_params, betas, glucose,
                                           data, kinetics, timepoints,
                                           substeps)
    if betas.device.type != "cuda":
        raise ValueError(f"no value+grad kernel for device {betas.device}")
    return _launch(net, nn_params, betas, glucose, data, kinetics,
                   timepoints, substeps)


def _launch(net, nn_params, betas, glucose, data, kinetics, timepoints,
            substeps):
    require_contiguous(nn_params=nn_params, betas=betas, glucose=glucose,
                       data=data, kinetics=kinetics)
    r, n = betas.shape
    p = nn_params.shape[1]
    opts = dict(dtype=torch.float32, device=betas.device)
    sse = torch.empty(r, n, **opts)
    gnn = torch.empty(r, n, p, **opts)
    gb = torch.empty(r, n, **opts)
    if r * n == 0:
        return sse, gnn, gb
    _, j0, _, _ = _segments(timepoints, substeps)
    consts = grid_constants(timepoints, substeps)
    long = long_grid(timepoints)
    n_seg = len(timepoints) - 1
    with torch.cuda.device(betas.device):
        stream = torch.cuda.current_stream(betas.device).cuda_stream
        lib = (kernel_age if net.input_dims == 3 else kernel).at(net.widths,
                                                                 long)
        consts_dev = device_table(consts if long else None, betas.device)
        ws = lib.workspace(betas.device, r * n, n_seg, substeps)
        lib(nn_params.data_ptr(), betas.data_ptr(), glucose.data_ptr(),
            data.data_ptr(), kinetics.data_ptr(), sse.data_ptr(),
            gnn.data_ptr(), gb.data_ptr(), r * n, n,
            consts.ctypes.data_as(F32_PTR), consts_dev, n_seg, substeps, j0,
            None if ws is None else ws.data_ptr(), stream)
    count_launch(shape_launches, net)
    return sse, gnn, gb


def packed_sse_and_grad(net: MLP, nn_params: torch.Tensor,
                        betas: torch.Tensor, glucose: torch.Tensor,
                        data: torch.Tensor, kinetics: torch.Tensor,
                        timepoints, substeps: int = 8):
    """``(f[R], gnn[R, P], gb[R, N])`` by the packed route: one launch of
    the lane kernel over the (restart × individual) lanes, then the mean
    over individuals, ``inf`` where it is not finite
    (``pallas_grad.py:651-663``)."""
    sse, gnn, gb = lane_sse_and_grad(net, nn_params, betas, glucose, data,
                                     kinetics, timepoints, substeps)
    inv_n = f32(1.0 / betas.shape[1])
    mean = sse.sum(1) * inv_n
    f = torch.where(torch.isfinite(mean), mean, torch.inf)
    return f, gnn.sum(1) * inv_n, gb * inv_n


def takes_restart_kernel(restarts: int, individuals: int) -> bool:
    """Whether a multi-start this wide is past the packed lanes of K2, so
    that :func:`population_sse_and_grad` takes the restart kernel K5."""
    return restarts * individuals > PACK_MAX_LANES


def population_sse_and_grad(net: MLP, nn_params: torch.Tensor,
                            betas: torch.Tensor, glucose: torch.Tensor,
                            data: torch.Tensor, kinetics: torch.Tensor,
                            timepoints, substeps: int = 8):
    """``(f[R], gnn[R, P], gb[R, N])``: the population mean SSE per restart
    and its exact gradient, ``inf`` where the mean is not finite.

    The layout follows the width of the multi-start, as in the JAX package
    (``pallas_grad.py:651-670``): up to ``PACK_MAX_LANES`` (restart ×
    individual) lanes :func:`packed_sse_and_grad`; above, the restart
    kernel of ``ops/population_grad.py``, which loops over the individuals
    itself."""
    nn_params, betas = nn_params.contiguous(), betas.contiguous()
    route = packed_sse_and_grad
    if takes_restart_kernel(*betas.shape):
        # imported here: that module builds on this one
        from conditional_ude_tpu_torch.ops.population_grad import (
            restart_sse_and_grad as route,
        )
    return route(net, nn_params, betas, glucose, data, kinetics, timepoints,
                 substeps)


class PopulationSSE(torch.autograd.Function):
    """``f[R]`` of a value+grad ``vg(nn, β) -> (f[R], ∇nn[R, P], ∇β[R, N])``
    under autograd (``parallel.mesh.sharded_population_vg``, which runs
    :func:`population_sse_and_grad` on each restart shard): the forward
    evaluates ``vg`` once and keeps ∇nn and ∇β; the backward returns them
    times ``grad_output``."""

    @staticmethod
    def forward(ctx, nn_params, betas, vg):
        f, gnn, gb = vg(nn_params, betas)
        ctx.save_for_backward(gnn, gb)
        return f

    @staticmethod
    def backward(ctx, grad_output):
        gnn, gb = ctx.saved_tensors
        return grad_output[:, None] * gnn, grad_output[:, None] * gb, None
