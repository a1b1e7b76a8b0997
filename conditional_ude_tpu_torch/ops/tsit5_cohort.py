"""K3: adaptive Tsit5 solve + SSE per (restart, individual) lane, the final
re-rank of joint training (counterpart of
``conditional_ude_tpu/ops/pallas_tsit5.py:42-297``, ``_build_kernel``,
``cohort_sse_tsit5_pallas`` and ``screen_population_tsit5_pallas``).

Every lane runs its own adaptive step sequence (t, dt and PI-controller
memory per lane, at most ``max_steps`` steps, rtol 1e-3, atol 1e-6) and
adds a residual to its SSE each time an accepted step crosses a save time,
through the free interpolant.  A lane that is done or failed changes no
more, so it may stop stepping.  Failed lanes report ``ok = False`` and an
``inf`` SSE.  The operations and their order are the JAX kernel's, which
differ in small ways from ``ops/tsit5.py`` (the glucose interpolant, the
2-state error norm, the save-time test).  The covariate model's network
takes the age (the kinetics' 5th column) as a third input at every stage.

The production term does not depend on the state, so a step evaluates the
network at its five stage times before it runs the stages (stage 7 takes
stage 6's production: both are at t + dtc), and the glucose at a time comes
from its one segment (:func:`glucose_at`).  Neither changes an operation:
the SSE, ``ok`` and the steps equal the formulation they replaced (six
right-hand sides in a chain, kept in ``tests/test_torch_tsit5_stages.py``)
bit for bit, and agree with the JAX kernel within the JAX suite's rtol
2e-2 (``tests/test_torch_tsit5.py``).

:func:`cohort_sse_tsit5` launches ``csrc/tsit5_cohort.cu`` for CUDA tensors
and runs :func:`cohort_sse_tsit5_reference` for CPU tensors.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from conditional_ude_tpu_torch.nn import MLP
from conditional_ude_tpu_torch.ops import tsit5 as tableau
from conditional_ude_tpu_torch.ops.cuda_build import (
    F32_PTR,
    I32,
    I64,
    VP,
    SHORT_GRID,
    KernelLibrary,
    count_launch,
    device_table,
    launch_total,
    long_grid,
)
from conditional_ude_tpu_torch.ops.rk4_cohort import (
    _mlp_columns,
    _mlp_forward,
    _segments,
    check_restart_inputs,
    require_contiguous,
)
from conditional_ude_tpu_torch.ops.tsit5 import f32

# kernel launches since import (or since a caller cleared it), by network
# shape: ``{(input_dims, hidden widths): launches}``; ``launches`` and
# ``launches_age`` are its totals for the 2-input and the 3-input body
shape_launches: dict = {}


def __getattr__(name: str) -> int:
    return launch_total(shape_launches, name, __name__)

_ARGTYPES = [VP, VP, VP, VP, VP, VP, VP, I64, I32, F32_PTR, VP, I32, I32, I32,
             VP]
kernel = KernelLibrary("tsit5_cohort.cu", "tsit5_cohort_sse", _ARGTYPES)
kernel_age = KernelLibrary("tsit5_cohort.cu", "tsit5_cohort_sse_age",
                           _ARGTYPES)


def constants(timepoints, rtol: float, atol: float) -> np.ndarray:
    """Host float32 constants of the kernel, each rounded once from float64
    as the JAX kernel's Python floats are: the tableau (c[7], a[7][6]
    lower-triangular, btilde[7]), the interpolant's 22 constants, the knots
    and spans of the glucose grid (padded to ``SHORT_GRID`` for a short
    grid, as many as the grid has points for a long one), then the scalars
    below, in the order of ``struct Tsit5Consts`` in the kernel.
    Kept per (grid, rtol, atol), so a call of the wrapper does not build
    them again (the array is read-only)."""
    return _constants_of(tuple(float(t) for t in timepoints), float(rtol),
                         float(atol))


@functools.lru_cache(maxsize=32)
def _constants_of(timepoints: tuple[float, ...], rtol: float,
                  atol: float) -> np.ndarray:
    ts = np.asarray(timepoints, np.float64)
    k = ts.shape[0]
    t0, t1 = float(ts[0]), float(ts[-1])
    span = t1 - t0
    _, j0, one_minus_w0, w0 = _segments(timepoints, 1)
    a = np.zeros((7, 6))
    for s, row in enumerate(tableau._A):
        a[s, :len(row)] = row
    knots = np.zeros(max(k, SHORT_GRID))
    knots[:k] = ts
    spans = np.zeros(max(k, SHORT_GRID))
    spans[:k - 1] = np.diff(ts)
    scalars = dict(
        one_minus_w0=one_minus_w0, w0=w0, t0=t0, t1=t1, t_span=span,
        rtol=rtol, atol=atol, tenth_span=0.1 * span,
        dt_fallback=1e-6 * span, dt_min=1e-10 * span,
        dt_floor=1e-12 * span, end_tol=t1 - 1e-8 * span,
        save_slack=1e-8 * span, safety=tableau.SAFETY,
        neg_beta1=-tableau.BETA1, beta2=tableau.BETA2,
        neg_inv_order=-1.0 / tableau.ORDER, h1_exp=1.0 / (tableau.ORDER + 1.0),
        fmin=tableau.FACTOR_MIN, fmax=tableau.FACTOR_MAX)
    out = np.concatenate([
        tableau._C, a.ravel(), tableau._BTILDE, tableau._INTERP, knots, spans,
        list(scalars.values())]).astype(np.float32)
    out.flags.writeable = False
    return out


def glucose_grid(timepoints, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The glucose grid as float32 tensors on ``device``: the knots
    ``[K - 1]`` (each segment's start) and spans ``[K - 1]``, each rounded
    once from float64 (the kernel's ``knot`` and ``span``)."""
    ts = np.asarray(timepoints, np.float64)
    return (torch.as_tensor(ts[:-1].astype(np.float32), device=device),
            torch.as_tensor(np.diff(ts).astype(np.float32), device=device))


def glucose_at(t: torch.Tensor, glucose: torch.Tensor, knots: torch.Tensor,
               spans: torch.Tensor) -> torch.Tensor:
    """Glucose ``[R, N]`` of individuals ``glucose[N, K]`` at lane times
    ``t[R, N]``, from one segment: j, the last with ``t >= knots[j]``,
    blended as ``(1 - w)·g[j] + w·g[j + 1]`` with ``w = clip((t -
    knots[j]) / spans[j], 0, 1)``, and ``g[0]`` below the first knot (or
    at a NaN time).  This is the segment the JAX kernel's chain of
    ``where(t >= knot[j], segment j, value)`` keeps, by the same
    operations, so the value is the chain's bit for bit
    (``tests/test_torch_tsit5_stages.py``); the kernel looks up the same
    segment."""
    j = torch.zeros(t.shape, dtype=torch.long, device=t.device)
    for i in range(1, knots.shape[0]):
        j = torch.where(t >= knots[i], i, j)
    rows = glucose.expand(*t.shape, glucose.shape[-1])
    g_lo = rows.gather(-1, j[..., None])[..., 0]
    g_hi = rows.gather(-1, (j + 1)[..., None])[..., 0]
    w = torch.clamp((t - knots[j]) / spans[j], 0.0, 1.0)
    return torch.where(t >= knots[0], (1.0 - w) * g_lo + w * g_hi,
                       glucose[:, 0])


def cohort_sse_tsit5_reference(net: MLP, nn_params, betas, glucose, data,
                               kinetics, timepoints, max_steps: int = 256,
                               rtol: float = 1e-3, atol: float = 1e-6,
                               return_steps: bool = False):
    """Plain PyTorch version of the kernel over ``[R, N]`` lanes:
    ``(sse[R, N], ok[R, N])``, and with ``return_steps`` also the steps
    each lane attempted and the steps it accepted (the work the kernel
    does on these inputs).

    The network's input does not depend on the state, so an attempted step
    first evaluates the production at its five stage times t + c_s·dtc,
    s = 2..6, then runs the stages' 2-state recurrence on them: stage 7's
    time t + dtc equals stage 6's (c6 = c7 = 1), so it takes stage 6's
    production.  A lane evaluates the network 1 + 2 + 5·(attempted steps)
    times: the baseline, Hairer's initial step, the steps."""
    ts = np.asarray(timepoints, np.float64)
    n_save = ts.shape[0]
    t0_f, t1_f = float(ts[0]), float(ts[-1])
    span = t1_f - t0_f
    _, j0, one_minus_w0, w0 = _segments(timepoints, 1)
    layers = _mlp_columns(nn_params, net)
    eb = torch.exp(betas)
    k0, k1, k2, c0 = (kinetics[:, i] for i in range(4))
    extra = [kinetics[:, 4]] if kinetics.shape[1] == 5 else []     # the age
    base = _mlp_forward(layers, [torch.zeros_like(eb), eb] + extra)
    A = [[f32(a) for a in row] for row in tableau._A]
    C = [f32(c) for c in tableau._C]
    BT = [f32(b) for b in tableau._BTILDE]
    # divisors as tensors: PyTorch on the card multiplies by the reciprocal
    # of a Python-number divisor, the kernel (and JAX) divide
    knots, spans = glucose_grid(timepoints, eb.device)
    g_at0 = one_minus_w0 * glucose[:, j0] + w0 * glucose[:, j0 + 1]

    def production(t):
        dg = glucose_at(t, glucose, knots, spans) - g_at0
        return _mlp_forward(layers, [dg, eb] + extra) - base

    def kinetics_rhs(v1, v2, prod):
        return (-(k0 + k2) * v1 + k1 * v2 + k0 * c0 + prod,
                -k1 * v2 + k2 * v1)

    def rms2(a1, a2, s1, s2):
        x1, x2 = a1 / s1, a2 / s2
        return torch.sqrt(f32(0.5) * (x1 * x1 + x2 * x2) + f32(1e-30))

    u1 = c0.expand_as(eb)
    u2 = (k2 / k1) * c0.expand_as(eb)
    t = torch.full_like(eb, f32(t0_f))
    f1a, f1b = kinetics_rhs(u1, u2, production(t))
    s1 = f32(atol) + f32(rtol) * torch.abs(u1)
    s2 = f32(atol) + f32(rtol) * torch.abs(u2)
    d0 = rms2(u1, u2, s1, s2)
    d1 = rms2(f1a, f1b, s1, s2)
    small = (d0 < f32(1e-5)) | (d1 < f32(1e-5))
    h0 = torch.where(small, f32(1e-6),
                     f32(0.01) * d0 / torch.where(d1 == 0, 1.0, d1))
    h0 = torch.clamp_max(h0, f32(0.1 * span))
    f2a, f2b = kinetics_rhs(u1 + h0 * f1a, u2 + h0 * f1b, production(t + h0))
    d2 = rms2(f2a - f1a, f2b - f1b, s1, s2) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= f32(1e-15),
                     torch.clamp_min(h0 * f32(1e-3), f32(1e-6)),
                     torch.pow(torch.full_like(dmax, f32(0.01)) / dmax,
                               f32(1.0 / (tableau.ORDER + 1.0))))
    dt = torch.minimum(f32(100.0) * h0, torch.clamp_max(h1, f32(span)))
    dt = torch.where(torch.isfinite(dt) & (dt > 0), dt, f32(1e-6 * span))

    sse = torch.square(u1 - data[:, 0])
    err_prev = torch.ones_like(eb)
    done = torch.zeros_like(eb, dtype=torch.bool)
    failed = torch.zeros_like(done)
    steps = torch.zeros_like(eb, dtype=torch.int32)
    accepted = torch.zeros_like(steps)
    dt_min = f32(1e-10 * span)
    save = [(si, f32(ts[si])) for si in range(n_save)
            if not math.isclose(float(ts[si]), t0_f)]

    for _ in range(max_steps):
        active = ~done & ~failed
        if not bool(active.any()):
            break
        steps = steps + active.int()
        dtc = torch.clamp_min(torch.minimum(dt, f32(t1_f) - t), f32(1e-12 * span))
        prods = [production(t + C[s] * dtc) for s in range(1, 6)]
        ka, kb = [f1a], [f1b]
        for s in range(1, 6):
            va, vb = u1, u2
            for j in range(s):
                va = va + dtc * A[s][j] * ka[j]
                vb = vb + dtc * A[s][j] * kb[j]
            ra, rb = kinetics_rhs(va, vb, prods[s - 1])
            ka.append(ra)
            kb.append(rb)
        ya, yb = u1, u2
        for j in range(6):
            ya = ya + dtc * A[6][j] * ka[j]
            yb = yb + dtc * A[6][j] * kb[j]
        k7a, k7b = kinetics_rhs(ya, yb, prods[4])
        ka.append(k7a)
        kb.append(k7b)

        ea = BT[0] * ka[0]
        ebb = BT[0] * kb[0]
        for j in range(1, 7):
            ea = ea + BT[j] * ka[j]
            ebb = ebb + BT[j] * kb[j]
        ea, ebb = dtc * ea, dtc * ebb
        sc1 = f32(atol) + f32(rtol) * torch.maximum(torch.abs(u1), torch.abs(ya))
        sc2 = f32(atol) + f32(rtol) * torch.maximum(torch.abs(u2), torch.abs(yb))
        err = rms2(ea, ebb, sc1, sc2)

        finite = torch.isfinite(ya) & torch.isfinite(yb) & torch.isfinite(err)
        accept = finite & (err <= 1.0)
        err_c = torch.clamp_min(err, f32(1e-10))
        fac_acc = torch.clamp(
            f32(tableau.SAFETY) * torch.pow(err_c, f32(-tableau.BETA1))
            * torch.pow(err_prev, f32(tableau.BETA2)),
            f32(tableau.FACTOR_MIN), f32(tableau.FACTOR_MAX))
        fac_rej = torch.clamp(
            f32(tableau.SAFETY) * torch.pow(err_c, f32(-1.0 / tableau.ORDER)),
            f32(tableau.FACTOR_MIN), 1.0)
        factor = torch.where(accept, fac_acc, torch.where(finite, fac_rej, 0.5))
        dt_next = dtc * factor

        t_new = t + dtc
        reached_end = t_new >= f32(t1_f - 1e-8 * span)
        upd = active & accept
        for si, t_s in save:
            hit = upd & (t_s > t) & ((t_s <= t_new) | reached_end
                                     & (t_s <= t_new + f32(1e-8 * span)))
            theta = torch.clamp((t_s - t) / dtc, 0.0, 1.0)
            bs = tableau._interp_coeffs(theta)
            yi = u1
            for j in range(7):
                yi = yi + dtc * bs[j] * ka[j]
            sse = torch.where(hit, sse + torch.square(yi - data[:, si]), sse)

        accepted = accepted + upd.int()
        failed = failed | (active & ~accept & (dt_next < dt_min))
        done = done | (upd & reached_end)
        t = torch.where(upd, t_new, t)
        dt = torch.where(active, dt_next, dt)
        u1 = torch.where(upd, ya, u1)
        u2 = torch.where(upd, yb, u2)
        f1a = torch.where(upd, k7a, f1a)
        f1b = torch.where(upd, k7b, f1b)
        err_prev = torch.where(upd, err_c, err_prev)

    ok = done & ~failed
    sse = torch.where(ok & torch.isfinite(sse), sse, torch.inf)
    return (sse, ok, steps, accepted) if return_steps else (sse, ok)


def cohort_sse_tsit5(net: MLP, nn_params: torch.Tensor, betas: torch.Tensor,
                     glucose: torch.Tensor, data: torch.Tensor,
                     kinetics: torch.Tensor, timepoints, max_steps: int = 256,
                     rtol: float = 1e-3, atol: float = 1e-6):
    """Per-lane adaptive ``(sse[R, N], ok[R, N])`` of restarts
    ``nn_params[R, P]``, ``betas[R, N]`` on a cohort ``glucose[N, K]``,
    ``data[N, K]``, ``kinetics[N, 4]`` (``[N, 5]`` with the age for a
    3-input network).  CPU tensors run the plain version; CUDA tensors
    launch the kernel's body for the network's input count."""
    check_restart_inputs(net, nn_params, betas, glucose, data, kinetics,
                         timepoints)
    if max_steps < 1:
        raise ValueError("max_steps must be >= 1")
    if betas.device.type == "cpu":
        return cohort_sse_tsit5_reference(net, nn_params, betas, glucose,
                                          data, kinetics, timepoints,
                                          max_steps, rtol, atol)
    if betas.device.type != "cuda":
        raise ValueError(f"no Tsit5 kernel for device {betas.device}")
    return _launch(net, nn_params, betas, glucose, data, kinetics,
                   timepoints, max_steps, rtol, atol)


def _launch(net, nn_params, betas, glucose, data, kinetics, timepoints,
            max_steps, rtol, atol):
    require_contiguous(nn_params=nn_params, betas=betas, glucose=glucose,
                       data=data, kinetics=kinetics)
    r, n = betas.shape
    sse = torch.empty(r, n, dtype=torch.float32, device=betas.device)
    ok = torch.empty(r, n, dtype=torch.bool, device=betas.device)
    if r * n == 0:
        return sse, ok
    consts = constants(timepoints, rtol, atol)
    _, j0, _, _ = _segments(timepoints, 1)
    long = long_grid(timepoints)
    with torch.cuda.device(betas.device):
        stream = torch.cuda.current_stream(betas.device).cuda_stream
        lib = (kernel_age if net.input_dims == 3 else kernel).at(net.widths,
                                                                 long)
        consts_dev = device_table(consts if long else None, betas.device)
        lib(nn_params.data_ptr(), betas.data_ptr(), glucose.data_ptr(),
            data.data_ptr(), kinetics.data_ptr(), sse.data_ptr(),
            ok.data_ptr(), r * n, n, consts.ctypes.data_as(F32_PTR),
            consts_dev, len(timepoints), j0, max_steps, stream)
    count_launch(shape_launches, net)
    return sse, ok


def screen_population_tsit5(net: MLP, nn_params: torch.Tensor,
                            betas: torch.Tensor, glucose: torch.Tensor,
                            data: torch.Tensor, kinetics: torch.Tensor,
                            timepoints, max_steps: int = 256) -> torch.Tensor:
    """Population mean adaptive SSE ``[R]``; a failed lane makes its
    restart's mean ``inf`` (``pallas_tsit5.py:279-297``)."""
    sse, _ = cohort_sse_tsit5(net, nn_params.contiguous(), betas.contiguous(),
                              glucose, data, kinetics, timepoints, max_steps)
    return sse.mean(1)
