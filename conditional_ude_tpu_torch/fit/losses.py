"""Loss functions (counterpart of ``conditional_ude_tpu/fit/losses.py``).

Batched over every lane: ``betas[..., N]`` gives losses ``[..., N]``; the
lanes are β, θ for the analytic head (``nn_params`` None), or None for the
UDE head (``models/cpeptide.py::lanes``).  A failed (non-finite) solve
gives ``inf``.  ``solver`` is ``"rk4"`` (fixed steps, ``substeps`` per save
segment) or ``"tsit5"`` (adaptive, at most ``max_steps`` steps); both are
plain tensor code, differentiable by autograd.  The JAX package's losses
default to Tsit5 (its ``simulate``); these default to RK4.  A cohort split
over a mesh (``parallel.mesh.ShardedCohort``) is solved shard by shard, each
on its device, and the per-individual losses gather in order before any
sum.
"""

from __future__ import annotations

import torch

from conditional_ude_tpu_torch.models.cpeptide import (
    Cohort,
    CPeptideModel,
    simulate_cohort,
)
from conditional_ude_tpu_torch.parallel.mesh import ShardedCohort


def sse(model: CPeptideModel, nn_params: torch.Tensor | None, betas,
        cohort: Cohort, substeps: int = 16, solver: str = "rk4",
        max_steps: int = 256) -> torch.Tensor:
    """Sum of squared errors on the plasma compartment; ``inf`` on failure."""
    if isinstance(cohort, ShardedCohort):
        if betas is None:
            raise ValueError("a sharded cohort needs lanes with an "
                             "individual axis")
        return cohort.map(lambda c, b, nn: sse(
            model, nn, b, c, substeps=substeps, solver=solver,
            max_steps=max_steps), torch.as_tensor(betas), nn_params)
    res = simulate_cohort(model, nn_params, betas, cohort, substeps=substeps,
                          solver=solver, max_steps=max_steps)
    err = torch.square(res.ys[..., 0] - cohort.cpeptide).sum(-1)
    return torch.where(res.success, err, torch.inf)


def sse_sigma(model: CPeptideModel, nn_params: torch.Tensor | None,
              betas, sigmas: torch.Tensor, cohort: Cohort,
              substeps: int = 16, solver: str = "rk4",
              max_steps: int = 256) -> torch.Tensor:
    """Gaussian NLL: (n/2)·log σ² + SSE/(2σ²)."""
    err = sse(model, nn_params, betas, cohort, substeps=substeps,
              solver=solver, max_steps=max_steps)
    n = cohort.timepoints.shape[0]
    return (n / 2.0) * torch.log(sigmas**2) + err / (2.0 * sigmas**2)


def conditional_sse(model: CPeptideModel, betas: torch.Tensor,
                    nn_params: torch.Tensor, cohort: Cohort,
                    substeps: int = 16) -> torch.Tensor:
    """β-only SSE with the network frozen."""
    return sse(model, nn_params, betas, cohort, substeps=substeps)


def population_sse(model: CPeptideModel, nn_params: torch.Tensor,
                   betas: torch.Tensor, cohort: Cohort,
                   substeps: int = 16, solver: str = "rk4",
                   max_steps: int = 256) -> torch.Tensor:
    """Mean over individuals of the per-individual SSE: ``[...]`` for
    ``betas[..., N]``; one diverged individual makes it ``inf``."""
    return sse(model, nn_params, betas, cohort, substeps=substeps,
               solver=solver, max_steps=max_steps).mean(-1)
