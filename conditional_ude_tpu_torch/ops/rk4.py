"""Batched fixed-step RK4 with exact landing on save points
(counterpart of ``conditional_ude_tpu/ops/rk4.py``).

Plain tensor code, differentiable through torch autograd: the β/σ fits take
their gradients here, as the JAX package takes them through XLA autodiff.
Every lane steps in lockstep, so the times are host float32 scalars.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class SolveResult(NamedTuple):
    ys: torch.Tensor        # [..., T, S] state at each save time
    success: torch.Tensor   # [...] bool: every saved state finite


def _schedule(saveat, t0, substeps):
    """Per save segment, its steps ``(t, dt, dt/2, dt/6)`` in float32.

    Integration starts at ``t0`` (default ``saveat[0]``), so the first
    segment may have zero length, exactly as in the JAX package.
    """
    saveat = np.asarray(saveat, np.float32)
    t_start = saveat[0] if t0 is None else np.float32(t0)
    seg_t0 = np.concatenate([[t_start], saveat[:-1]]).astype(np.float32)
    seg_dt = (saveat - seg_t0) / np.float32(substeps)
    return [[(t0_s + np.float32(i) * dt, dt, np.float32(0.5) * dt,
              dt / np.float32(6.0)) for i in range(substeps)]
            for t0_s, dt in zip(seg_t0, seg_dt)]


def stage_times(saveat, t0=None, substeps: int = 16) -> np.ndarray:
    """Every distinct time at which :func:`solve_rk4` evaluates ``f``."""
    return np.unique(np.asarray(
        [s for seg in _schedule(saveat, t0, substeps)
         for t, dt, half, _ in seg for s in (t, t + half, t + dt)],
        np.float32))


def solve_rk4(
    f: Callable[[np.float32, torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    saveat,
    t0: float | None = None,
    substeps: int = 16,
) -> SolveResult:
    """Integrate ``dy/dt = f(t, y)`` with ``substeps`` RK4 steps between
    consecutive save times.

    ``y0[..., S]``; ``f(t, y)`` gets the float32 scalar time shared by all
    lanes.  A lane whose state goes non-finite has ``success`` False.
    """
    y = y0
    ys = []
    for seg in _schedule(saveat, t0, substeps):
        for t, dt, half, sixth in seg:
            h = float(half)
            k1 = f(t, y)
            k2 = f(t + half, y + h * k1)
            k3 = f(t + half, y + h * k2)
            k4 = f(t + dt, y + float(dt) * k3)
            y = y + float(sixth) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        ys.append(y)
    ys = torch.stack(ys, dim=-2)
    success = torch.isfinite(ys).flatten(-2).all(-1)
    return SolveResult(ys=ys, success=success)
