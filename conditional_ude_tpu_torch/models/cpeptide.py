"""C-peptide kinetics with the conditional production head
(counterpart of ``conditional_ude_tpu/models/cpeptide.py``).

ODE (van Cauter two-compartment kinetics):
    du1 = -(k0 + k2)·u1 + k1·u2 + k0·c0 + production
    du2 = -k1·u2 + k2·u1
    production = NN([ΔG(t), e^β]) − NN([0, e^β])
with ΔG(t) = glucose(t) − glucose(0) from linear interpolation of the
measured glucose, and the steady state u0 = [c0, (k2/k1)·c0].  The
covariate model (``kind="conditional_covariate"``, experiment 07) feeds each
individual's age as a third input: NN([ΔG, e^β, age]) − NN([0, e^β, age]).

A cohort is a set of tensors with the individual axis last; β may carry
leading batch axes (candidate networks, profile grid points) in front of it.
The port has the conditional and covariate heads; the analytic and UDE
heads come with later slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from conditional_ude_tpu_torch.nn import MLP
from conditional_ude_tpu_torch.ops.interp import LinearInterp, linspace
from conditional_ude_tpu_torch.ops.rk4 import SolveResult, solve_rk4, stage_times
from conditional_ude_tpu_torch.ops.tsit5 import solve_tsit5

LN2 = float(np.log(2.0))


def van_cauter_parameters(age: torch.Tensor, t2dm: torch.Tensor):
    """Kinetic constants (k0, k1, k2) from age and T2DM status (van Cauter
    et al. 1992): short half-life 4.52 (T2DM) / 4.95 min, fraction
    0.78 / 0.76, long half-life 0.14·age + 29.2 min."""
    t2dm = t2dm.to(torch.bool)
    short_hl = torch.where(t2dm, 4.52, 4.95).to(age.dtype)
    fraction = torch.where(t2dm, 0.78, 0.76).to(age.dtype)
    long_hl = 0.14 * age + 29.2

    k1 = fraction * (LN2 / long_hl) + (1.0 - fraction) * (LN2 / short_hl)
    k0 = (LN2 / short_hl) * (LN2 / long_hl) / k1
    k2 = (LN2 / short_hl) + (LN2 / long_hl) - k0 - k1
    return k0, k1, k2


@dataclasses.dataclass(frozen=True)
class Cohort:
    """Stacked individuals and their observations.

    ``timepoints`` is the shared measurement grid (host float32): glucose and
    c-peptide are both sampled on it, and the solvers step on it in lockstep.
    """

    glucose: torch.Tensor      # [N, T] mmol/L
    cpeptide: torch.Tensor     # [N, T] nmol/L
    timepoints: np.ndarray     # [T] minutes
    age: torch.Tensor          # [N]
    k0: torch.Tensor           # [N]
    k1: torch.Tensor
    k2: torch.Tensor
    c0: torch.Tensor           # [N] basal c-peptide (first sample)

    @property
    def n(self) -> int:
        return self.cpeptide.shape[0]

    @property
    def device(self) -> torch.device:
        return self.cpeptide.device

    @property
    def u0(self) -> torch.Tensor:
        """[N, 2] steady-state initial condition."""
        return torch.stack([self.c0, (self.k2 / self.k1) * self.c0], dim=-1)

    def kinetics(self, with_age: bool = False) -> torch.Tensor:
        """Rows ``[N, 4]`` (k0, k1, k2, c0), plus age as a 5th column."""
        cols = [self.k0, self.k1, self.k2, self.c0]
        if with_age:
            cols.append(self.age)
        return torch.stack(cols, dim=-1)


def build_cohort(glucose, timepoints, cpeptide, ages, t2dm,
                 device: torch.device | str) -> Cohort:
    """Cohort tensors on ``device`` from raw arrays: ``glucose[N, T]`` and
    ``cpeptide[N, T]`` on ``timepoints[T]``, ``c0`` the first c-peptide
    sample."""
    f32 = dict(dtype=torch.float32, device=device)
    glucose = torch.as_tensor(np.asarray(glucose), **f32)
    cpeptide = torch.as_tensor(np.asarray(cpeptide), **f32)
    ages = torch.as_tensor(np.asarray(ages), **f32)
    t2dm = torch.as_tensor(np.asarray(t2dm, bool), device=device)
    k0, k1, k2 = van_cauter_parameters(ages, t2dm)
    return Cohort(glucose=glucose, cpeptide=cpeptide,
                  timepoints=np.asarray(timepoints, np.float32), age=ages,
                  k0=k0, k1=k1, k2=k2, c0=cpeptide[:, 0].clone())


# the network's input count of each production head
KINDS = {"conditional": 2, "conditional_covariate": 3}


@dataclasses.dataclass(frozen=True)
class CPeptideModel:
    """Kinetics plus a conditional production head: ``net([ΔG, e^β])``
    (``kind="conditional"``) or ``net([ΔG, e^β, age])``
    (``kind="conditional_covariate"``)."""

    net: MLP
    kind: str = "conditional"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {sorted(KINDS)}, got "
                             f"{self.kind!r}")
        if self.net.input_dims != KINDS[self.kind]:
            raise ValueError(
                f"a {self.kind!r} model needs a {KINDS[self.kind]}-input "
                f"network, got input_dims={self.net.input_dims}")

    @property
    def with_age(self) -> bool:
        """Whether the network takes the age as its third input."""
        return self.kind == "conditional_covariate"

    def production(self, nn_params: torch.Tensor, betas: torch.Tensor,
                   age=None):
        """``prod(dg)`` = NN([ΔG, e^β(, age)]) − NN([0, e^β(, age)]); the
        baseline and e^β are computed once, outside the time loop.  ``age``
        (broadcast against ``betas``) is required by the covariate model and
        ignored otherwise."""
        eb = torch.exp(betas)
        extra = []
        if self.with_age:
            if age is None:
                raise ValueError("the covariate model needs the age")
            extra = [torch.as_tensor(age, dtype=eb.dtype, device=eb.device)]

        def net(dg: torch.Tensor) -> torch.Tensor:
            x = torch.broadcast_tensors(dg, eb, *extra)
            return self.net.scalar(nn_params, torch.stack(x, dim=-1))

        base = net(torch.zeros_like(eb))

        def prod(dg: torch.Tensor) -> torch.Tensor:
            return net(dg) - base

        return prod

    def vector_field(self, nn_params: torch.Tensor, betas: torch.Tensor,
                     cohort: Cohort, times):
        """``f(t, y[..., N, 2])`` for ``betas[..., N]`` and network
        ``nn_params[..., P]`` (broadcast against ``[..., N, P]``).

        ``times`` lists every time ``f`` will be called at.  The production
        term depends on t and β but not on the state, so it is evaluated at
        all of them in one network sweep, and each call of ``f`` is linear
        tensor work.
        """
        times = np.unique(np.asarray(times, np.float32))
        row = {float(t): i for i, t in enumerate(times)}
        glucose = LinearInterp(cohort.timepoints, cohort.glucose)
        # ΔG is measured from absolute t = 0, not from the first knot
        dg = glucose(times) - glucose(0.0)[:, None]          # [N, U]
        dg = dg.T.reshape(len(times), *[1] * (betas.ndim - 1), cohort.n)
        table = self.production(nn_params, betas, cohort.age)(dg)  # [U, ..., N]
        decay = -(cohort.k0 + cohort.k2)
        inflow = cohort.k0 * cohort.c0
        k1, k2, neg_k1 = cohort.k1, cohort.k2, -cohort.k1

        def f(t, y: torch.Tensor) -> torch.Tensor:
            u1, u2 = y[..., 0], y[..., 1]
            du1 = decay * u1 + k1 * u2 + inflow + table[row[float(t)]]
            du2 = neg_k1 * u2 + k2 * u1
            return torch.stack([du1, du2], dim=-1)

        return f

    def vector_field_lanes(self, nn_params: torch.Tensor,
                           betas: torch.Tensor, cohort: Cohort):
        """``f(t[..., N], y[..., N, 2])`` with a time of its own for every
        lane (the adaptive solver's trajectories do not step in lockstep);
        ΔG from the glucose interpolant at each lane's time."""
        glucose = LinearInterp(cohort.timepoints, cohort.glucose)
        g0 = glucose(0.0)
        prod = self.production(nn_params, betas, cohort.age)
        decay = -(cohort.k0 + cohort.k2)
        inflow = cohort.k0 * cohort.c0
        k1, k2, neg_k1 = cohort.k1, cohort.k2, -cohort.k1

        def f(t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
            u1, u2 = y[..., 0], y[..., 1]
            du1 = decay * u1 + k1 * u2 + inflow + prod(glucose.at(t) - g0)
            du2 = neg_k1 * u2 + k2 * u1
            return torch.stack([du1, du2], dim=-1)

        return f

    def rhs(self, t, y, nn_params, betas, cohort: Cohort) -> torch.Tensor:
        """One evaluation of the right-hand side at time ``t``."""
        return self.vector_field(nn_params, betas, cohort, [t])(t, y)


def simulate_cohort(model: CPeptideModel, nn_params: torch.Tensor,
                    betas: torch.Tensor, cohort: Cohort, saveat=None,
                    substeps: int = 16, solver: str = "rk4",
                    max_steps: int = 256) -> SolveResult:
    """Every lane from ``timepoints[0]``: fixed-step RK4 (``substeps`` per
    save segment) or adaptive Tsit5 (``solver="tsit5"``, at most
    ``max_steps`` steps, rtol 1e-3, atol 1e-6); ``ys[..., N, T, 2]``."""
    saveat = cohort.timepoints if saveat is None else saveat
    betas = torch.as_tensor(betas, dtype=torch.float32, device=cohort.device)
    t0 = cohort.timepoints[0]
    batch = torch.broadcast_shapes(betas.shape, (cohort.n,))
    y0 = cohort.u0.expand(*batch, 2)
    if solver == "tsit5":
        f = model.vector_field_lanes(nn_params, betas, cohort)
        res = solve_tsit5(f, y0, t0, np.asarray(saveat)[-1], saveat,
                          max_steps=max_steps)
        return SolveResult(ys=res.ys, success=res.success)
    if solver != "rk4":
        raise ValueError(f"unknown solver {solver!r}")
    f = model.vector_field(nn_params, betas, cohort,
                           stage_times(saveat, t0, substeps))
    return solve_rk4(f, y0, saveat, t0=t0, substeps=substeps)


def production_orientations(model: CPeptideModel, nn_params: torch.Tensor,
                            beta_range=(-2.5, 0.5), dg_range=(0.5, 10.0),
                            age=50.0, steps: int = 13) -> torch.Tensor:
    """Canonical ±1 gauge of trained conditional axes ``nn_params[..., P]``,
    one per network: +1 when production decreases in β over the
    physiological (β, ΔG) box, −1 when the trained gauge is mirrored.  β
    analyses use ``orientation * β``.  ``age`` feeds the covariate model's
    third input (use the cohort's mean age) and is ignored otherwise."""
    dev = nn_params.device
    bs = torch.as_tensor(linspace(*beta_range, steps), device=dev)
    dgs = torch.as_tensor(linspace(*dg_range, 8), device=dev)
    dg, b = torch.broadcast_tensors(dgs[None, :], bs[:, None])   # [steps, 8]
    surf = model.production(nn_params[..., None, None, :], b, age)(dg)
    slope = torch.mean(surf[..., 1:, :] - surf[..., :-1, :], dim=(-2, -1))
    return torch.where(slope <= 0, 1.0, -1.0)


def production_orientation(model: CPeptideModel, nn_params: torch.Tensor,
                           **kwargs) -> float:
    """:func:`production_orientations` of one network ``nn_params[P]``, as a
    Python float."""
    return float(production_orientations(model, nn_params, **kwargs))
