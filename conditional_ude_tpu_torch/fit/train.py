"""Frozen-network fits (counterpart of ``conditional_ude_tpu/fit/train.py:656-782``).

With the network fixed, each individual's β (and σ) is re-estimated by the
batched L-BFGS, every individual a row.  Gradients go through torch
autograd on the plain batched RK4, as the JAX package takes them through
XLA autodiff.  Joint training (``train_conditional``) comes with the next
slice.
"""

from __future__ import annotations

import torch

from conditional_ude_tpu_torch.fit.losses import sse, sse_sigma
from conditional_ude_tpu_torch.models.cpeptide import Cohort, CPeptideModel
from conditional_ude_tpu_torch.ops.lbfgs import lbfgs_minimize

_BIG = 1e30   # the "unbounded" box edge of the JAX package


def _initial(initial_beta, cohort: Cohort) -> torch.Tensor:
    b0 = torch.as_tensor(initial_beta, dtype=torch.float32,
                         device=cohort.device)
    return b0.expand(torch.broadcast_shapes(b0.shape, (cohort.n,)))


def fit_betas(model: CPeptideModel, nn_params: torch.Tensor, cohort: Cohort,
              initial_beta=-2.0, bounds=(-4.0, 1.0), lbfgs_iters: int = 1000,
              substeps: int = 8):
    """Per-individual bounded β re-estimation with the network frozen.

    ``nn_params[..., P]`` broadcasts against ``[..., N, P]`` and
    ``initial_beta`` against ``[..., N]``.  Returns ``(betas, objectives)``
    of that batch shape.
    """
    b0 = _initial(initial_beta, cohort)
    batch = b0.shape
    lb, ub = bounds
    opts = dict(dtype=torch.float32, device=cohort.device)

    def loss(x):
        return sse(model, nn_params, x.reshape(batch), cohort,
                   substeps=substeps).reshape(-1)

    res = lbfgs_minimize(loss, b0.reshape(-1, 1),
                         lower=torch.tensor([lb], **opts),
                         upper=torch.tensor([ub], **opts),
                         max_iters=lbfgs_iters)
    return res.x[:, 0].reshape(batch), res.fval.reshape(batch)


def fit_betas_sigma(model: CPeptideModel, nn_params: torch.Tensor,
                    cohort: Cohort, initial_beta=-2.0, bounds=(-4.0, 1.0),
                    lbfgs_iters: int = 1000, substeps: int = 8):
    """(β, σ) re-estimation by the Gaussian NLL; initial σ 1.0.

    σ is floored at 1e-6: the NLL is even in σ, and the positive floor
    keeps the optimizer on the positive one of two equal minima.  Returns
    ``(betas[N], sigmas[N], objectives[N])``.
    """
    b0 = _initial(initial_beta, cohort)
    lb, ub = bounds
    opts = dict(dtype=torch.float32, device=cohort.device)

    def loss(x):
        return sse_sigma(model, nn_params, x[:, 0], x[:, 1], cohort,
                         substeps=substeps)

    res = lbfgs_minimize(loss, torch.stack([b0, torch.ones_like(b0)], -1),
                         lower=torch.tensor([lb, 1e-6], **opts),
                         upper=torch.tensor([ub, _BIG], **opts),
                         max_iters=lbfgs_iters)
    return res.x[:, 0], res.x[:, 1], res.fval


def evaluate_model(model: CPeptideModel, candidates_nn: torch.Tensor,
                   betas_train: torch.Tensor, cohort: Cohort,
                   lbfgs_iters: int = 1000, substeps: int = 8) -> torch.Tensor:
    """Validation objectives ``[R, N_valid]`` for model selection: for each
    candidate network ``candidates_nn[R, P]``, an unbounded β fit on every
    validation individual, started from the mean of that candidate's
    training β's (``betas_train[R, N_train(, 1)]``)."""
    init = betas_train.reshape(betas_train.shape[0], -1).mean(1)
    _, objectives = fit_betas(
        model, candidates_nn[:, None, :], cohort,
        initial_beta=init[:, None].expand(-1, cohort.n),
        bounds=(-_BIG, _BIG), lbfgs_iters=lbfgs_iters, substeps=substeps)
    return objectives


def select_best(objectives: torch.Tensor) -> int:
    """argmin over candidates of the summed validation objectives."""
    return int(torch.argmin(objectives.sum(1)))
