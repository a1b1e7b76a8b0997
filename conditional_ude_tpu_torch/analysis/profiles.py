"""Likelihood profiles, confidence intervals, identifiability classification
(counterpart of ``conditional_ude_tpu/analysis/profiles.py:46-242``).

* ``likelihood_profile`` scans one scalar parameter of any batched loss
  over a uniform grid: NLL = loss / (2σ²);
* ``cohort_beta_profiles`` scans every individual's β over a uniform grid
  (or a shared Δβ axis around per-individual centres) and evaluates
  NLL = SSE / (2σ²); lanes are (grid point × individual) pairs, in grid
  chunks, and go through the fused cohort RK4 kernel (K4) for a network of
  tanh hidden layers with a softplus head on 2 inputs or, for the covariate
  model, on 3 (``fused_kernel_eligible``), otherwise through the batched
  RK4;
* ``find_confidence_intervals``: threshold crossing with the Cantelli-95
  (Δ = 7.16), Cantelli-90 (Δ = 5.24) or Raue-95 (Δ = χ²₁(0.95)) offsets,
  ±inf when the interval reaches the scan edge;
* ``classify_identifiability``: identifiable / practically unidentifiable /
  unidentifiable by whether the threshold is crossed on both / one / no side.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from conditional_ude_tpu_torch.fit.losses import sse
from conditional_ude_tpu_torch.models.cpeptide import Cohort, CPeptideModel
from conditional_ude_tpu_torch.ops import rk4_cohort
from conditional_ude_tpu_torch.ops.interp import linspace

THRESHOLDS = {
    "cantelli95": 7.16,
    "cantelli90": 5.24,
    "raue95": 3.8414588206941205,   # chi2(1).quantile(0.95)
}


class Profile(NamedTuple):
    grid: torch.Tensor      # [S] scanned parameter values
    values: torch.Tensor    # [N, S] NLL at each grid point
    minimum: torch.Tensor   # [N]


def fused_kernel_eligible(model: CPeptideModel,
                          solver_kwargs: dict | None = None) -> bool:
    """Whether the kernels compute this model, as the JAX package's
    predicate decides: a network of tanh hidden layers (any widths and
    depth) with a softplus head on [ΔG, e^β] or, for the covariate model,
    on [ΔG, e^β, age] (one conditional parameter), with no solver keyword
    but ``substeps`` in ``solver_kwargs``."""
    if (model.kind not in ("conditional", "conditional_covariate")
            or model.n_conditional != 1
            or not set(solver_kwargs or ()) <= {"substeps"}):
        return False
    try:
        rk4_cohort.check_net_canonical(model.net)
    except ValueError:
        return False
    return True


def likelihood_profile(loss_fn, lower: float, upper: float,
                       steps: int = 10_000, sigma=1.0,
                       device: torch.device | str = "cpu") -> Profile:
    """``loss_fn(grid[S]) -> [S]`` over ``linspace(lower, upper, steps)``
    on ``device``, as NLL = loss / (2σ²) (``src/likelihood-profiles.jl
    :19-32``); ``minimum`` is the least value of the scan."""
    grid = torch.as_tensor(linspace(lower, upper, steps), device=device)
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    values = loss_fn(grid) / (2.0 * sig**2)
    return Profile(grid=grid, values=values, minimum=values.amin(-1))


def cohort_beta_profiles(model: CPeptideModel,
                         nn_params: torch.Tensor | None, cohort: Cohort,
                         sigmas=1.0, lower: float = -4.0,
                         upper: float = 1.0, steps: int = 10_000,
                         chunk: int = 500, center=None,
                         substeps: int = 8, solver: str = "rk4",
                         require_kernel: bool = False,
                         **solver_kwargs) -> Profile:
    """β-profiles of every individual at once: ``values[N, S]``; for the
    analytic head (``nn_params`` None) the profiles of its θ.

    ``center[N]``: individual *i* is profiled at ``center[i] + grid``, so the
    grid is a shared Δβ axis (the identifiability census).  The scan runs in
    chunks of ``chunk`` grid points, by RK4 at ``substeps`` or by Tsit5
    (``solver="tsit5"``, which K4 does not compute) at the JAX defaults or
    at ``solver_kwargs``' ``rtol``, ``atol`` and ``max_steps``; K4 runs
    only where no such keyword is given, as in the JAX package.
    ``require_kernel=True`` raises ``ValueError`` where K4 cannot compute
    the model (the JAX package's ``use_pallas=True``).
    """
    dev, n = cohort.device, cohort.n
    f32 = dict(dtype=torch.float32, device=dev)
    grid = torch.as_tensor(linspace(lower, upper, steps), device=dev)
    sig = torch.as_tensor(sigmas, **f32).expand(n)
    ctr = (torch.zeros(n, **f32) if center is None
           else torch.as_tensor(center, **f32))
    fused = solver == "rk4" and fused_kernel_eligible(model, solver_kwargs)
    if require_kernel and not fused:
        raise ValueError("require_kernel=True needs a conditional or "
                         "covariate model the kernels take, solver='rk4' "
                         "and no solver keyword but substeps")
    if fused:
        kin = cohort.kinetics(with_age=model.with_age)
        nn_params = nn_params.contiguous()    # a row of a strided table

    parts = []
    for i in range(0, steps, chunk):
        g_chunk = grid[i:i + chunk]
        s = g_chunk.shape[0]
        betas = g_chunk[:, None] + ctr[None, :]          # [s, N]
        if fused:
            lanes = s * n

            def expand(x):
                return x.expand(s, *x.shape).reshape(lanes, *x.shape[1:])

            sse_lanes = rk4_cohort.cohort_sse(
                model.net, nn_params.expand(lanes, -1), betas.reshape(-1),
                expand(cohort.glucose), expand(cohort.cpeptide), expand(kin),
                cohort.timepoints, substeps).reshape(s, n)
        else:
            with torch.no_grad():
                sse_lanes = sse(model, nn_params, betas, cohort,
                                substeps=substeps, solver=solver,
                                **solver_kwargs)
        parts.append(sse_lanes.T / (2.0 * sig[:, None] ** 2))
    values = torch.cat(parts, dim=1)
    return Profile(grid=grid, values=values, minimum=values.amin(1))


class ConfidenceInterval(NamedTuple):
    lower: np.ndarray   # ±inf when the threshold is not crossed on that side
    upper: np.ndarray


def find_confidence_intervals(profile: Profile,
                              method: str = "cantelli95") -> ConfidenceInterval:
    """Threshold-crossing CIs of one profile (``values[S]``) or a batch
    (``values[N, S]``); a bound is ±inf when the profile never rises above
    minimum + Δ on that side of the minimizer."""
    if method not in THRESHOLDS:
        raise ValueError(f"method must be one of {sorted(THRESHOLDS)}")
    delta = THRESHOLDS[method]

    values = np.asarray(torch.as_tensor(profile.values).cpu())
    grid = np.asarray(torch.as_tensor(profile.grid).cpu())
    squeeze = values.ndim == 1
    if squeeze:
        values = values[None]

    n = values.shape[0]
    lo = np.full(n, -np.inf)
    hi = np.full(n, np.inf)
    for i in range(n):
        v = values[i]
        finite = np.isfinite(v)
        if not finite.any():
            continue
        imin = int(np.argmin(np.where(finite, v, np.inf)))
        thresh = np.min(v[finite]) + delta
        above = v > thresh
        left = np.flatnonzero(above[:imin])
        if left.size:
            lo[i] = grid[left[-1]]
        right = np.flatnonzero(above[imin + 1:])
        if right.size:
            hi[i] = grid[imin + 1 + right[0]]
    if squeeze:
        return ConfidenceInterval(lower=lo[0], upper=hi[0])
    return ConfidenceInterval(lower=lo, upper=hi)


def classify_identifiability(ci: ConfidenceInterval) -> np.ndarray:
    """"identifiable" (both bounds finite), "practically unidentifiable"
    (one side open) or "unidentifiable" (both open), per individual."""
    lo = np.atleast_1d(np.asarray(ci.lower))
    hi = np.atleast_1d(np.asarray(ci.upper))
    return np.where(
        np.isfinite(lo) & np.isfinite(hi), "identifiable",
        np.where(np.isfinite(lo) | np.isfinite(hi),
                 "practically unidentifiable", "unidentifiable"))
