"""Loss functions (counterpart of ``conditional_ude_tpu/fit/losses.py``).

Batched over every lane: ``betas[..., N]`` gives losses ``[..., N]``.  A
failed (non-finite) solve gives ``inf``.
"""

from __future__ import annotations

import torch

from conditional_ude_tpu_torch.models.cpeptide import (
    Cohort,
    CPeptideModel,
    simulate_cohort,
)


def sse(model: CPeptideModel, nn_params: torch.Tensor, betas: torch.Tensor,
        cohort: Cohort, substeps: int = 16) -> torch.Tensor:
    """Sum of squared errors on the plasma compartment; ``inf`` on failure."""
    res = simulate_cohort(model, nn_params, betas, cohort, substeps=substeps)
    err = torch.square(res.ys[..., 0] - cohort.cpeptide).sum(-1)
    return torch.where(res.success, err, torch.inf)


def sse_sigma(model: CPeptideModel, nn_params: torch.Tensor,
              betas: torch.Tensor, sigmas: torch.Tensor, cohort: Cohort,
              substeps: int = 16) -> torch.Tensor:
    """Gaussian NLL: (n/2)·log σ² + SSE/(2σ²)."""
    err = sse(model, nn_params, betas, cohort, substeps=substeps)
    n = cohort.timepoints.shape[0]
    return (n / 2.0) * torch.log(sigmas**2) + err / (2.0 * sigmas**2)


def conditional_sse(model: CPeptideModel, betas: torch.Tensor,
                    nn_params: torch.Tensor, cohort: Cohort,
                    substeps: int = 16) -> torch.Tensor:
    """β-only SSE with the network frozen."""
    return sse(model, nn_params, betas, cohort, substeps=substeps)


def population_sse(model: CPeptideModel, nn_params: torch.Tensor,
                   betas: torch.Tensor, cohort: Cohort,
                   substeps: int = 16) -> torch.Tensor:
    """Mean over individuals of the per-individual SSE: ``[...]`` for
    ``betas[..., N]``; one diverged individual makes it ``inf``."""
    return sse(model, nn_params, betas, cohort, substeps=substeps).mean(-1)
