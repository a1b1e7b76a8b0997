"""Adaptive Tsit5 (Tsitouras 5(4)) over a leading batch of trajectories
(counterpart of ``conditional_ude_tpu/ops/tsit5.py``).

FSAL stage reuse, a PI step-size controller (β1 = 0.7/5, β2 = 0.4/5,
safety 0.9, factor in [0.2, 10]), Hairer's initial step, dense output at
the save times through the free interpolant, and done/failed masks: a
non-finite state or a step below ``1e-10 · span`` fails a trajectory.

Every trajectory carries its own t, dt and controller memory.  A step
changes nothing in a trajectory that is done or failed, so the loop ends as
soon as no trajectory is active; the result equals the JAX package's
fixed-length scan over ``max_steps``.  Plain tensor code: it serves the CPU
path and the tests; the re-rank on the card goes through the kernel in
``ops/tsit5_cohort.py``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

# -- Tsit5 tableau (Tsitouras 2011) -------------------------------------------

_C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)

_A = (
    (),
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774),
)

# embedded error weights (b − b̂)
_BTILDE = (-0.00178001105222577714, -0.0008164344596567469,
           0.007880878010261995, -0.1447110071732629, 0.5823571654525552,
           -0.45808210592918697, 0.015151515151515152)

# free-interpolant constants, in the order _interp_coeffs uses them
_INTERP = (
    -1.0530884977290216, 1.3299890189751412, 1.4364028541716351,
    0.7139816917074209,
    0.1017, 2.1966568338249754, 1.2949852507374631,
    2.490627285651252793, 2.38535645472061657, 1.57803468208092486,
    -16.54810288924490272, 1.21712927295533244, 0.61620406037800089,
    47.37952196281928122, 1.203071208372362603, 0.658047292653547382,
    -34.87065786149660974, 1.2, 0.666666666666666667,
    2.5, 1.0, 0.6,
)

ORDER = 5.0
BETA1 = 0.7 / ORDER
BETA2 = 0.4 / ORDER
SAFETY = 0.9
FACTOR_MIN = 0.2
FACTOR_MAX = 10.0


def f32(x: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weak constant."""
    return float(np.float32(x))


def _interp_coeffs(t):
    """Tsit5 free interpolant weights b_i(θ), 4th-order accurate, in the
    JAX package's operation order with float32 constants."""
    c = [f32(v) for v in _INTERP]
    t2 = t * t
    return (
        c[0] * t * (t - c[1]) * (t2 - c[2] * t + c[3]),
        c[4] * t2 * (t2 - c[5] * t + c[6]),
        c[7] * t2 * (t2 - c[8] * t + c[9]),
        c[10] * (t - c[11]) * (t - c[12]) * t2,
        c[13] * (t - c[14]) * (t - c[15]) * t2,
        c[16] * (t - c[17]) * (t - c[18]) * t2,
        c[19] * (t - c[20]) * (t - c[21]) * t2,
    )


class SolveResult(NamedTuple):
    ys: torch.Tensor           # [..., T, S] solution at the save times
    success: torch.Tensor      # [...] bool
    num_steps: torch.Tensor    # [...] int32 attempted steps
    num_accepted: torch.Tensor


def _rms(x):
    return torch.sqrt((x * x).mean(-1) + f32(1e-30))


def _initial_dt(f, t0, y0, f0, rtol, atol, t_span):
    """Hairer's automatic initial step (order 5)."""
    scale = f32(atol) + f32(rtol) * torch.abs(y0)
    d0 = _rms(y0 / scale)
    d1 = _rms(f0 / scale)
    small = (d0 < f32(1e-5)) | (d1 < f32(1e-5))
    h0 = torch.where(small, f32(1e-6),
                     f32(0.01) * d0 / torch.where(d1 == 0, 1.0, d1))
    h0 = torch.clamp_max(h0, f32(0.1) * t_span)
    f1 = f(t0 + h0, y0 + h0[..., None] * f0)
    d2 = _rms((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= f32(1e-15),
                     torch.clamp_min(h0 * f32(1e-3), f32(1e-6)),
                     torch.pow(torch.full_like(dmax, f32(0.01)) / dmax,
                               f32(1.0 / (ORDER + 1.0))))
    dt = torch.minimum(f32(100.0) * h0, torch.clamp_max(h1, t_span))
    return torch.where(torch.isfinite(dt) & (dt > 0), dt, f32(1e-6) * t_span)


def solve_tsit5(
    f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    t0: float,
    t1: float,
    saveat,
    max_steps: int = 256,
    rtol: float = 1e-3,
    atol: float = 1e-6,
) -> SolveResult:
    """Integrate ``dy/dt = f(t, y)`` from ``t0`` to ``t1`` for every
    trajectory of ``y0[..., S]``.

    ``f(t[...], y[..., S]) -> [..., S]`` gets each trajectory's own time.
    ``saveat[T]`` (ascending, within [t0, t1]) is shared by all.
    """
    dtype, dev = y0.dtype, y0.device
    batch = y0.shape[:-1]
    t0, t1 = np.float32(t0), np.float32(t1)
    t_span = f32(t1 - t0)
    sv = np.asarray(saveat, np.float32)
    save_t = torch.as_tensor(sv, device=dev)

    t = torch.full(batch, float(t0), dtype=dtype, device=dev)
    f0 = f(t, y0)
    dt = _initial_dt(f, t, y0, f0, rtol, atol, t_span)
    dt_min = f32(1e-10) * t_span
    end_tol = f32(t1 - np.float32(1e-8) * np.float32(t_span))

    ys = torch.where(torch.as_tensor(sv <= t0, device=dev)[:, None],
                     y0[..., None, :], 0.0)
    y, k1 = y0, f0
    err_prev = torch.ones(batch, dtype=dtype, device=dev)
    done = torch.full(batch, bool(t_span <= 0), device=dev)
    failed = torch.zeros(batch, dtype=torch.bool, device=dev)
    n_acc = torch.zeros(batch, dtype=torch.int32, device=dev)
    n_tot = torch.zeros(batch, dtype=torch.int32, device=dev)
    A = [[f32(a) for a in row] for row in _A]
    C = [f32(c) for c in _C]
    BT = [f32(b) for b in _BTILDE]

    for _ in range(max_steps):
        active = ~(done | failed)
        if not bool(active.any()):
            break
        dtc = torch.clamp_min(torch.minimum(dt, float(t1) - t),
                              f32(1e-12) * t_span)
        h = dtc[..., None]

        ks = [k1]
        for s in range(1, 6):
            acc = A[s][0] * ks[0]
            for j in range(1, s):
                acc = acc + A[s][j] * ks[j]
            ks.append(f(t + C[s] * dtc if s < 5 else t + dtc, y + h * acc))
        acc = A[6][0] * ks[0]
        for j in range(1, 6):
            acc = acc + A[6][j] * ks[j]
        y_new = y + h * acc
        k7 = f(t + dtc, y_new)
        ks.append(k7)

        acc = BT[0] * ks[0]
        for j in range(1, 7):
            acc = acc + BT[j] * ks[j]
        err = h * acc
        scale = f32(atol) + f32(rtol) * torch.maximum(torch.abs(y),
                                                       torch.abs(y_new))
        r = err / scale
        err_norm = torch.sqrt((r * r).mean(-1) + f32(1e-30))

        finite = torch.isfinite(y_new).all(-1) & torch.isfinite(err_norm)
        accept = finite & (err_norm <= 1.0)

        err_c = torch.clamp_min(err_norm, f32(1e-10))
        fac_acc = torch.clamp(
            f32(SAFETY) * torch.pow(err_c, f32(-BETA1))
            * torch.pow(err_prev, f32(BETA2)), f32(FACTOR_MIN),
            f32(FACTOR_MAX))
        fac_rej = torch.clamp(
            f32(SAFETY) * torch.pow(err_c, f32(-1.0 / ORDER)),
            f32(FACTOR_MIN), 1.0)
        factor = torch.where(accept, fac_acc,
                             torch.where(finite, fac_rej, 0.5))
        dt_next = dtc * factor

        # dense output at the save times inside (t, t_new]; the final step
        # also takes any beyond t_new left by rounding
        t_new = t + dtc
        reached_end = t_new >= end_tol
        upper = torch.where(reached_end, torch.inf, t_new)
        save_mask = ((active & accept)[..., None] & (save_t > t[..., None])
                     & (save_t <= upper[..., None]))
        theta = torch.clamp((save_t - t[..., None])
                            / torch.where(dtc == 0, 1.0, dtc)[..., None],
                            0.0, 1.0)
        bs = _interp_coeffs(theta)
        acc = bs[0][..., None] * ks[0][..., None, :]
        for j in range(1, 7):
            acc = acc + bs[j][..., None] * ks[j][..., None, :]
        y_interp = y[..., None, :] + h[..., None] * acc
        ys = torch.where(save_mask[..., None], y_interp, ys)

        upd = active & accept
        failed = failed | (active & ~accept & (dt_next < dt_min))
        done = done | (upd & reached_end)
        t = torch.where(upd, t_new, t)
        y = torch.where(upd[..., None], y_new, y)
        dt = torch.where(active, dt_next, dt)
        k1 = torch.where(upd[..., None], k7, k1)
        err_prev = torch.where(upd, err_c, err_prev)
        n_acc = n_acc + upd.int()
        n_tot = n_tot + active.int()

    return SolveResult(ys=ys, success=done & ~failed, num_steps=n_tot,
                       num_accepted=n_acc)
