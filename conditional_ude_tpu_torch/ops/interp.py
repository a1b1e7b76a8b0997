"""Piecewise-linear interpolation of the glucose forcing, and uniform grids
(counterpart of ``conditional_ude_tpu/ops/interp.py``).

Every individual of a cohort shares one measurement grid, and the fixed-step
solvers step all lanes in lockstep, so query times are host values: the
knot indices and blend weights are computed on the host in float32, and
only the lerp runs on the tensors.
"""

from __future__ import annotations

import numpy as np
import torch


class LinearInterp:
    """``y(t)`` over sorted knots ``ts[K]`` shared by every lane; ``ys[..., K]``.

    Queries clamp to the knot range, as in the JAX package.
    """

    def __init__(self, ts, ys: torch.Tensor):
        self.ts = np.asarray(ts, np.float32)
        if self.ts.ndim != 1 or self.ts.shape[0] < 2:
            raise ValueError("ts must be a 1-d grid of at least 2 knots")
        if ys.shape[-1] != self.ts.shape[0]:
            raise ValueError(
                f"ys has {ys.shape[-1]} knots, ts has {self.ts.shape[0]}")
        self.ys = ys

    def __call__(self, t) -> torch.Tensor:
        """``y`` at a time (``[...]``) or at a 1-d array of times (``[..., Q]``)."""
        ts = self.ts
        tq = np.clip(np.atleast_1d(np.asarray(t, np.float32)), ts[0], ts[-1])
        # index of the left knot of the interval holding each query
        idx = np.clip(np.searchsorted(ts, tq, side="right") - 1,
                      0, ts.shape[0] - 2)
        w = ((tq - ts[idx]) / (ts[idx + 1] - ts[idx])).astype(np.float32)
        dev = self.ys.device
        i0 = torch.as_tensor(idx, device=dev)
        y0 = self.ys[..., i0]
        y1 = self.ys[..., i0 + 1]
        out = y0 + torch.as_tensor(w, device=dev) * (y1 - y0)
        return out[..., 0] if np.ndim(t) == 0 else out


def linspace(lower: float, upper: float, steps: int) -> np.ndarray:
    """float32 ``[steps]`` grid computed as ``jnp.linspace`` computes it:
    ``lower·(1 − s) + upper·s`` with ``s = i / (steps − 1)``, the last point
    exactly ``upper``."""
    lo, hi = np.float32(lower), np.float32(upper)
    if steps == 1:
        return np.array([lo], np.float32)
    div = steps - 1
    s = np.arange(div, dtype=np.float32) / np.float32(div)
    out = lo * (np.float32(1.0) - s) + hi * s
    return np.concatenate([out, [hi]]).astype(np.float32)
