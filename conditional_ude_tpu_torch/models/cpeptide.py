"""C-peptide kinetics and its four production heads (counterpart of
``conditional_ude_tpu/models/cpeptide.py``).

ODE (van Cauter two-compartment kinetics):
    du1 = -(k0 + k2)·u1 + k1·u2 + k0·c0 + production
    du2 = -k1·u2 + k2·u1
with ΔG(t) = glucose(t) − glucose(0) from linear interpolation of the
measured glucose, and the steady state u0 = [c0, (k2/k1)·c0].  The heads:

* ``"conditional"``: NN([ΔG, e^β]) − NN([0, e^β]), one β per individual;
  with k conditional parameters NN([ΔG, e^β₁…e^β_k]) − NN([0, e^β₁…e^β_k]);
* ``"conditional_covariate"`` (experiment 07): the age as the last input,
  NN([ΔG, e^β, age]) − NN([0, e^β, age]) (k β's as above);
* ``"ude"`` (experiment 01): NN([ΔG]) − NN([0]), nothing per individual;
* ``"analytic"`` (the symbolic refits): ``fn(ΔG, θ)``, one scalar θ per
  individual (the Michaelis constant k, the gate b).

A cohort is a set of tensors with the individual axis last.  The lane
tensor of a head (β, or θ) may carry leading batch axes (candidate
networks, profile grid points) in front of it; the UDE head's lanes carry
only the batch shape.  With k > 1 conditional parameters the β's of a lane
are a trailing axis, ``betas[..., N, k]``; at k = 1 the lanes are
``betas[..., N]``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

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
    An individual built from a curve (:func:`build_individual`) has no
    c-peptide observations (``cpeptide`` is None) until a caller sets them.
    """

    glucose: torch.Tensor      # [N, T] mmol/L
    cpeptide: torch.Tensor | None   # [N, T] nmol/L
    timepoints: np.ndarray     # [T] minutes
    age: torch.Tensor          # [N]
    k0: torch.Tensor           # [N]
    k1: torch.Tensor
    k2: torch.Tensor
    c0: torch.Tensor           # [N] basal c-peptide

    @property
    def n(self) -> int:
        return self.glucose.shape[0]

    @property
    def device(self) -> torch.device:
        return self.glucose.device

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


def build_individual(glucose, glucose_t, age, c0, t2dm,
                     device: torch.device | str) -> Cohort:
    """A one-row cohort from one glucose curve ``glucose[T]`` on
    ``glucose_t[T]``, with basal c-peptide ``c0`` as given (a mean curve or
    a type-average individual has no c-peptide row of its own) and no
    observations (``cpeptide`` None)."""
    f32 = dict(dtype=torch.float32, device=device)
    ages = torch.as_tensor(np.float32(age), **f32).reshape(1)
    k0, k1, k2 = van_cauter_parameters(
        ages, torch.as_tensor([bool(t2dm)], device=device))
    return Cohort(glucose=torch.as_tensor(np.asarray(glucose), **f32)[None],
                  cpeptide=None,
                  timepoints=np.asarray(glucose_t, np.float32), age=ages,
                  k0=k0, k1=k1, k2=k2,
                  c0=torch.as_tensor(np.float32(c0), **f32).reshape(1))


# the network's input count of each production head at one conditional
# parameter (the analytic head has no network); a conditional head with k
# reads k − 1 more, one e^β each
KINDS = {"analytic": 0, "ude": 1, "conditional": 2,
         "conditional_covariate": 3}


@dataclasses.dataclass(frozen=True)
class CPeptideModel:
    """Kinetics plus a production head: ``net([ΔG, e^β₁…e^β_k])``
    (``kind="conditional"``, a 1 + k-input network), ``net([ΔG,
    e^β₁…e^β_k, age])`` (``kind="conditional_covariate"``, 2 + k inputs),
    ``net([ΔG])`` (``kind="ude"``) or ``analytic_fn(ΔG, θ)``
    (``kind="analytic"``, no network)."""

    net: MLP | None
    kind: str = "conditional"
    analytic_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None \
        = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {sorted(KINDS)}, got "
                             f"{self.kind!r}")
        if self.kind == "analytic":
            if self.analytic_fn is None or self.net is not None:
                raise ValueError("the analytic head takes analytic_fn and "
                                 "no network")
        else:
            need = KINDS[self.kind]
            got = None if self.net is None else self.net.input_dims
            if self.kind == "ude" and got != need:
                raise ValueError(f"a 'ude' model needs a 1-input network, "
                                 f"got {got}")
            if got is None or got < need:
                raise ValueError(
                    f"a {self.kind!r} model needs a network of at least "
                    f"{need} inputs, got {got}")

    @property
    def with_age(self) -> bool:
        """Whether the network takes the age as its last input."""
        return self.kind == "conditional_covariate"

    @property
    def n_conditional(self) -> int:
        """k, the conditional parameters of an individual (the e^β inputs
        of the network); 0 for the UDE and analytic heads."""
        if self.kind in ("ude", "analytic"):
            return 0
        return self.net.input_dims - KINDS[self.kind] + 1

    def lane_shape(self, betas: torch.Tensor) -> torch.Size:
        """The lanes' shape ``[..., N]`` of ``betas``: without the trailing
        axis of k > 1 conditional parameters."""
        return betas.shape[:-1] if self.n_conditional > 1 else betas.shape

    def production(self, nn_params: torch.Tensor | None, betas: torch.Tensor,
                   age=None):
        """``prod(dg)`` of the head for the lanes ``betas[..., N]`` (or
        ``[..., N, k]``): NN([ΔG, e^β(, age)]) − NN([0, e^β(, age)]),
        NN([ΔG]) − NN([0]) (the UDE head reads only the lanes' shape) or
        ``analytic_fn(ΔG, θ)`` with θ the lanes.  The baseline and e^β are
        computed once, outside the time loop.  ``age`` (broadcast against
        the lanes) is required by the covariate model and ignored
        otherwise."""
        if self.kind == "analytic":
            return lambda dg: self.analytic_fn(dg, betas)
        extra = []
        if self.kind != "ude":
            extra = [torch.exp(betas)]
        if self.with_age:
            if age is None:
                raise ValueError("the covariate model needs the age")
            extra.append(torch.as_tensor(age, dtype=betas.dtype,
                                         device=betas.device))
        k = self.n_conditional
        lane_shape = self.lane_shape(betas)

        def net(dg: torch.Tensor) -> torch.Tensor:
            if k <= 1:
                dg, _, *x = torch.broadcast_tensors(dg, betas, *extra)
                return self.net.scalar(nn_params,
                                       torch.stack([dg, *x], dim=-1))
            # the k e^β's are a trailing axis of their own
            shape = torch.broadcast_shapes(dg.shape, lane_shape,
                                           *(a.shape for a in extra[1:]))
            cols = [dg.expand(shape)[..., None], extra[0].expand(*shape, k),
                    *(a.expand(shape)[..., None] for a in extra[1:])]
            return self.net.scalar(nn_params, torch.cat(cols, dim=-1))

        base = net(betas.new_zeros(lane_shape))

        def prod(dg: torch.Tensor) -> torch.Tensor:
            return net(dg) - base

        return prod

    def vector_field(self, nn_params: torch.Tensor, betas: torch.Tensor,
                     cohort: Cohort, times):
        """``f(t, y[..., N, 2])`` for ``betas[..., N]`` (or ``[..., N, k]``)
        and network
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
        dg = dg.T.reshape(len(times), *[1] * (len(self.lane_shape(betas))
                                              - 1), cohort.n)
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


def lanes(nn_params: torch.Tensor | None, betas, cohort: Cohort) -> torch.Tensor:
    """The lane tensor ``[..., N]`` of a solve on ``cohort``: β or θ in the
    network's dtype (float32 for the analytic head unless θ is a tensor of
    another), or, for the UDE head (``betas`` None), zeros of the batch
    shape of ``nn_params[..., P]`` against the cohort."""
    if betas is None:
        shape = torch.broadcast_shapes(nn_params.shape[:-1], (cohort.n,))
        return torch.zeros(shape, dtype=nn_params.dtype, device=cohort.device)
    if nn_params is not None:
        dtype = nn_params.dtype
    else:
        dtype = betas.dtype if isinstance(betas, torch.Tensor) \
            else torch.float32
    return torch.as_tensor(betas, dtype=dtype, device=cohort.device)


def simulate_cohort(model: CPeptideModel, nn_params: torch.Tensor | None,
                    betas, cohort: Cohort, saveat=None,
                    substeps: int = 16, solver: str = "rk4",
                    max_steps: int = 256, rtol: float = 1e-3,
                    atol: float = 1e-6) -> SolveResult:
    """Every lane from ``timepoints[0]``: fixed-step RK4 (``substeps`` per
    save segment) or adaptive Tsit5 (``solver="tsit5"``, at most
    ``max_steps`` steps, tolerances ``rtol``, ``atol``); ``ys[..., N, T,
    2]`` in the lanes' dtype (:func:`lanes`: β, θ, or None for the UDE
    head; ``nn_params`` None for the analytic head).

    The JAX package's ``simulate_cohort`` defaults to Tsit5; this one to
    RK4, so a caller that follows a JAX default names ``solver="tsit5"``.
    """
    saveat = cohort.timepoints if saveat is None else saveat
    betas = lanes(nn_params, betas, cohort)
    t0 = cohort.timepoints[0]
    batch = torch.broadcast_shapes(model.lane_shape(betas), (cohort.n,))
    y0 = cohort.u0.to(betas.dtype).expand(*batch, 2)
    if solver == "tsit5":
        f = model.vector_field_lanes(nn_params, betas, cohort)
        res = solve_tsit5(f, y0, t0, np.asarray(saveat)[-1], saveat,
                          max_steps=max_steps, rtol=rtol, atol=atol)
        return SolveResult(ys=res.ys, success=res.success)
    if solver != "rk4":
        raise ValueError(f"unknown solver {solver!r}")
    f = model.vector_field(nn_params, betas, cohort,
                           stage_times(saveat, t0, substeps))
    return solve_rk4(f, y0, saveat, t0=t0, substeps=substeps)


def simulate(model: CPeptideModel, nn_params: torch.Tensor | None, betas,
             individual: Cohort, saveat, solver: str = "tsit5",
             **solver_kwargs) -> SolveResult:
    """One individual's trajectories at ``saveat`` for the lanes
    ``betas[...]`` (None for the UDE head): ``ys[..., T, 2]``, with the JAX
    package's ``simulate`` default solver (Tsit5)."""
    if individual.n != 1:
        raise ValueError(f"simulate takes one individual, got {individual.n}")
    if betas is not None:
        # the individual axis goes in front of the k β's (k > 1)
        betas = lanes(nn_params, betas, individual).unsqueeze(
            -2 if model.n_conditional > 1 else -1)
    res = simulate_cohort(model, nn_params, betas, individual, saveat,
                          solver=solver, **solver_kwargs)
    return SolveResult(ys=res.ys[..., 0, :, :], success=res.success[..., 0])


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
