"""The symbolic (Michaelis-Menten) production and the in-repo discovered
equation, with their per-individual refits (counterpart of
``conditional_ude_tpu/models/symbolic.py``).

    symbolic:    production(ΔG, k) = 1.78·ΔG⁺ / (ΔG⁺ + k)
    discovered:  production(ΔG, b) = 0.1817·ΔG⁺ / (b²·(ΔG⁺ + 5.507) + 2.99)

with ΔG⁺ = relu(ΔG).  Each is the analytic head of a ``CPeptideModel`` with
one scalar per individual.  The fits re-estimate (k, σ) or (b, σ) of every
individual by one batched, box-bounded L-BFGS over the cohort, every
individual a row, on the Gaussian σ-NLL.  No epsilon guards the
production: at ΔG = 0 and k = 0 it is NaN, as in the JAX package, and the
loss of that solve is ``inf``.
"""

from __future__ import annotations

import torch

from conditional_ude_tpu_torch.fit.losses import sse_sigma
from conditional_ude_tpu_torch.models.cpeptide import Cohort, CPeptideModel
from conditional_ude_tpu_torch.ops.lbfgs import lbfgs_minimize


def symbolic_production(dg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """1.78·ΔG/(ΔG + k) gated to ΔG ≥ 0 (``c-peptide/03-symreg.jl:37``)."""
    dgp = torch.relu(dg)
    return 1.78 * dgp / (dgp + k)


def discovered_production(dg: torch.Tensor,
                          beta_exp: torch.Tensor) -> torch.Tensor:
    """0.1817·ΔG/(b²·(ΔG + 5.507) + 2.99) gated to ΔG ≥ 0, with b on the
    network-input scale e^β (``results/symbolic_regression_result.csv``,
    the c = 14 row)."""
    dgp = torch.relu(dg)
    b2 = beta_exp * beta_exp
    return 0.1817 * dgp / (b2 * (dgp + 5.507) + 2.99)


def beta_to_k(beta_exp: torch.Tensor) -> torch.Tensor:
    """k = 167·b³ + 21.8, with b = e^β (``c-peptide/03-symreg.jl:55``)."""
    return 167.0 * beta_exp**3 + 21.8


def symbolic_model() -> CPeptideModel:
    """The symbolic head; its lanes are each individual's k."""
    return CPeptideModel(None, "analytic", analytic_fn=symbolic_production)


def discovered_model() -> CPeptideModel:
    """The discovered head; its lanes are each individual's b."""
    return CPeptideModel(None, "analytic", analytic_fn=discovered_production)


def _fit_scalar_sigma(model: CPeptideModel, cohort: Cohort, initial, lower,
                      upper, lbfgs_iters: int, solver: str, max_steps: int):
    """(θ, σ) of every individual: box-bounded L-BFGS on the σ-NLL from
    ``initial``, every individual a row; ``(θ[N], σ[N], objective[N])``."""
    f32 = dict(dtype=torch.float32, device=cohort.device)
    x0 = torch.tensor(initial, **f32).expand(cohort.n, 2).contiguous()

    def loss(x):
        return sse_sigma(model, None, x[:, 0], x[:, 1], cohort,
                         solver=solver, max_steps=max_steps)

    res = lbfgs_minimize(loss, x0, lower=torch.tensor(lower, **f32),
                         upper=torch.tensor(upper, **f32),
                         max_iters=lbfgs_iters)
    return res.x[:, 0], res.x[:, 1], res.fval


def fit_k_sigma(cohort: Cohort, lbfgs_iters: int = 1000,
                initial_k: float = 40.0, initial_sigma: float = 1.0,
                bounds: tuple[float, float] = (0.0, 1000.0),
                solver: str = "rk4", solver_max_steps: int = 256):
    """(k, σ) of every individual of the symbolic model
    (``c-peptide/03-symreg.jl:95-107``); ``bounds`` box both k and σ, as
    the reference does.  Returns ``(ks[N], sigmas[N], objectives[N])``."""
    lb, ub = bounds
    return _fit_scalar_sigma(symbolic_model(), cohort,
                             [initial_k, initial_sigma], [lb, lb], [ub, ub],
                             lbfgs_iters, solver, solver_max_steps)


def fit_b_sigma(cohort: Cohort, lbfgs_iters: int = 1000,
                initial_b: float = 0.7, initial_sigma: float = 1.0,
                b_bounds: tuple[float, float] = (1e-3, 50.0),
                sigma_bounds: tuple[float, float] = (1e-6, 1e3),
                solver: str = "rk4", solver_max_steps: int = 256):
    """(b, σ) of every individual of the discovered model, each in its own
    box.  Returns ``(bs[N], sigmas[N], objectives[N])``."""
    return _fit_scalar_sigma(discovered_model(), cohort,
                             [initial_b, initial_sigma],
                             [b_bounds[0], sigma_bounds[0]],
                             [b_bounds[1], sigma_bounds[1]],
                             lbfgs_iters, solver, solver_max_steps)
