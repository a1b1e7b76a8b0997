"""SAEM mixed-effects estimator (counterpart of
``conditional_ude_tpu/fit/saem.py``): random effects β_i ~ N(η, Ω), the
network (or one scalar population parameter) and σ as fixed effects.

The JAX package runs SAEM as three ``lax.scan``s (the Adam population
update, the MCMC steps, the iterations); here they are torch loops, each
step batched over the population axis.  Quirks of the reference, kept:

* Ω is the *scale* of the N(η, Ω) prior but is updated by blending the
  *variance* of the random effects (``omega_as_variance=False``); on real
  data the update can collapse Ω, and the collapse is the reference's
  behaviour.  ``omega_as_variance=True`` is the consistent variant,
  Ω² ← (1 − lr)·Ω² + lr·var(rand);
* σ is overwritten by the population update; the fixed effects are
  γ-blended;
* the proposal std adapts only after burn-in;
* the Adam state of the population update starts anew every iteration,
  and non-finite gradient entries are zeroed;
* a NaN log-ratio rejects, the SA blend runs on every active step, and the
  acceptance rate is acc / (N · steps of the iteration);
* a failed solve gives the log-likelihood −inf.

Random draws come from a ``torch.Generator``, or are injected (``draws``)
in the JAX package's layout: normals and uniforms ``[iterations,
mcmc_steps_max, N]`` for SAEM, the inactive steps of the burn-in included,
and ``[n_steps, N]`` for the posterior chains.

The likelihood of a cohort (:class:`CohortLogLik`) of the canonical cUDE
with fixed-step RK4 takes the kernels: its values come from K4
(``ops/rk4_cohort.py``; a step's proposals and current states in one
launch of 2N lanes) and the population gradient from K2
(``ops/lane_grad.py``, one restart) plus σ's closed form.  Every other
configuration (Tsit5, the analytic heads) runs the plain solvers, as the
JAX package's XLA path does; the route is named in the result.  The MAP and
MLE fits take autograd through the plain RK4.  On a cohort split over a
mesh (``parallel.mesh.shard_cohort``) each shard's lanes run on its device
and the per-individual results gather in order before any sum, so the run
is the unsharded one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from conditional_ude_tpu_torch.fit.losses import sse
from conditional_ude_tpu_torch.fit.optim import adam_minimize
from conditional_ude_tpu_torch.models.cpeptide import (
    Cohort,
    CPeptideModel,
    simulate_cohort,
)
from conditional_ude_tpu_torch.ops import lane_grad, rk4_cohort
from conditional_ude_tpu_torch.ops.lbfgs import lbfgs_minimize
from conditional_ude_tpu_torch.parallel.mesh import ShardedCohort, gather

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SAEMConfig:
    """Defaults mirror ``src/saem.jl:134-152`` / ``saem-symreg.jl:134-151``."""

    sigma: float = 1.0
    prior_eta: float = 0.0
    prior_omega: float = 1.0
    iterations: int = 500
    burnin: int = 100
    proposal_std: float = 0.1
    proposal_bounds: tuple[float, float] = (1e-3, 1.0)
    alpha: float = 0.7
    n_mcmc_steps: int = 1
    initial_mcmc_steps: int | None = None   # defaults to n_mcmc_steps
    target_acceptance: float = 0.25
    initial_temperature: float = 10.0
    temperature_decay: float = 0.05
    omega_lr: float = 0.04
    pop_update_lbfgs: bool = False          # cUDE: Adam(1e-2); symbolic: L-BFGS
    pop_update_iters: int = 5
    pop_adam_lr: float = 1e-2
    update_prior_mean: bool = True          # cUDE yes, symbolic no
    omega_as_variance: bool = False         # False: the reference's quirk

    @property
    def burnin_steps(self) -> int:
        return (self.initial_mcmc_steps if self.initial_mcmc_steps is not None
                else self.n_mcmc_steps)

    @property
    def mcmc_steps_max(self) -> int:
        return max(self.burnin_steps, self.n_mcmc_steps)


class SAEMResult(NamedTuple):
    theta: torch.Tensor              # fixed effects: network [P] or scalar
    random_effects: torch.Tensor     # [N] final β_i / η_i
    omega: torch.Tensor
    sigma: torch.Tensor
    eta: torch.Tensor                # prior mean (prior_eta when not updated)
    nll_trace: torch.Tensor          # [iterations]
    acceptance_trace: torch.Tensor   # [iterations]
    proposal_std_trace: torch.Tensor  # [iterations]
    route: str                       # the likelihood's route (LogLik.route)


def _normal_logpdf(x, mean, scale):
    scale2 = scale**2
    return -0.5 * (torch.log(2.0 * math.pi * scale2) + (x - mean) ** 2 / scale2)


def _gaussian(err: torch.Tensor, sigma: torch.Tensor, n_t: int):
    """−(n/2)·log σ² − SSE/(2σ²), −inf where the SSE is not finite."""
    val = -(n_t / 2.0) * torch.log(sigma**2) - err / (2.0 * sigma**2)
    return torch.where(torch.isfinite(err), val, -torch.inf)


class LogLik:
    """Per-individual log-likelihoods ``ll[..., N]`` of random effects
    ``rand[..., N]`` (leading axes are independent batches of the cohort)
    at fixed effects ``theta`` and ``sigma``; −inf where a solve fails.

    A subclass defines ``n``, ``device`` and ``__call__``, which autograd
    differentiates; :meth:`values` (no gradient) and :meth:`nll_and_grad`
    take it unless the subclass has faster routes."""

    n: int
    device: torch.device
    route = "plain"

    def __call__(self, theta, sigma, rand) -> torch.Tensor:
        raise NotImplementedError

    def values(self, theta, sigma, rand) -> torch.Tensor:
        with torch.no_grad():
            return self(theta, sigma, rand)

    def nll_and_grad(self, theta, sigma, rand):
        """``(f, ∂f/∂θ, ∂f/∂σ)`` of the total NLL f = −Σ_i ll_i."""
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            s = sigma.detach().requires_grad_(True)
            f = -self(th, s, rand).sum()
            g_th, g_s = torch.autograd.grad(f, (th, s))
        return f.detach(), g_th, g_s


class CohortLogLik(LogLik):
    """The Gaussian log-likelihood of every individual of ``cohort``
    (``src/saem.jl:55-66``, ``src/saem-symreg.jl:51-66``): for a network
    head θ is the network and the random effects are the β's; for an
    analytic head θ is the population parameter and the individual's is
    θ·e^{rand_i}.

    The canonical 2- or 3-input cUDE with ``solver="rk4"`` takes the
    kernels: K4 for :meth:`values`, K2 for :meth:`nll_and_grad` (CUDA
    tensors launch them, CPU tensors run their plain versions).  Everything
    else, and ``__call__`` (the MAP and MLE fits), runs the plain solvers.
    A ``ShardedCohort`` gives one likelihood a shard (``parts``), whose
    kernels run on the shard's device.
    """

    def __init__(self, model: CPeptideModel, cohort: Cohort | ShardedCohort,
                 solver: str = "rk4", substeps: int = 8,
                 max_steps: int = 256):
        self.model, self.cohort = model, cohort
        self.solver, self.substeps, self.max_steps = solver, substeps, max_steps
        self.n, self.device = cohort.n, cohort.device
        self.n_t = cohort.timepoints.shape[0]
        self.parts = None
        self.kernels = (solver == "rk4" and model.kind in (
            "conditional", "conditional_covariate")
            and 1 <= substeps <= lane_grad.MAX_SUBSTEPS)
        if self.kernels:
            try:
                rk4_cohort.check_net_canonical(model.net)
            except ValueError:
                self.kernels = False
        if self.kernels:
            dev = "cuda" if self.device.type == "cuda" else "plain"
            self.route = f"{dev}_k4_k2"
        if isinstance(cohort, ShardedCohort):
            self.parts = [CohortLogLik(model, c, solver, substeps, max_steps)
                          for c in cohort.shards]
            self.route += f"+mesh{len(self.parts)}"
        elif self.kernels:
            self.tp = tuple(float(t) for t in cohort.timepoints)
            self.rows = (cohort.glucose, cohort.cpeptide,
                         cohort.kinetics(with_age=model.with_age))
            self._lanes = {1: self.rows}

    def _head(self, theta, rand):
        """The network and the lanes of the head."""
        if self.model.kind == "analytic":
            return None, theta * torch.exp(rand)
        return theta, rand

    def sse(self, theta, rand) -> torch.Tensor:
        nn, lanes = self._head(theta, rand)
        return sse(self.model, nn, lanes, self.cohort, substeps=self.substeps,
                   solver=self.solver, max_steps=self.max_steps)

    def __call__(self, theta, sigma, rand) -> torch.Tensor:
        return _gaussian(self.sse(theta, rand), sigma, self.n_t)

    def values(self, theta, sigma, rand) -> torch.Tensor:
        if not self.kernels:
            return super().values(theta, sigma, rand)
        return _gaussian(self._kernel_sse(theta, rand), sigma, self.n_t)

    def _kernel_sse(self, theta, rand) -> torch.Tensor:
        """K4's SSE of the lanes ``rand[..., N]``, one launch (a shard)."""
        if self.parts is not None:
            outs = [p._kernel_sse(theta.to(p.device), r) for p, r in
                    zip(self.parts, self.cohort.split(rand, -1))]
            return gather(outs, self.device, dim=-1)
        lanes = rand.reshape(-1).contiguous()
        m = lanes.shape[0] // self.n
        if m not in self._lanes:
            self._lanes[m] = tuple(t.repeat(m, 1) for t in self.rows)
        nn = theta.reshape(1, -1).contiguous().expand(lanes.shape[0], -1)
        err = rk4_cohort.cohort_sse(self.model.net, nn, lanes, *self._lanes[m],
                                    self.tp, self.substeps)
        return err.reshape(rand.shape)

    def _lane_grads(self, theta, rand):
        """K2's SSE ``[N]`` and ∇nn ``[N, P]`` at one restart, gathered
        over the shards."""
        if self.parts is not None:
            outs = [p._lane_grads(theta.to(p.device), r) for p, r in
                    zip(self.parts, self.cohort.split(rand, -1))]
            return tuple(gather([o[i] for o in outs], self.device)
                         for i in range(2))
        err, gnn, _ = lane_grad.lane_sse_and_grad(
            self.model.net, theta.reshape(1, -1).contiguous(),
            rand.reshape(1, -1).contiguous(), *self.rows, self.tp,
            self.substeps)
        return err[0], gnn[0]

    def nll_and_grad(self, theta, sigma, rand):
        """K2's per-lane SSE and ∇nn at one restart, summed over the lanes,
        and σ's derivative in closed form.

        JAX differentiates through ``where(isfinite(err), val, −inf)``, so a
        lane whose SSE is not finite enters with cotangent 0: its θ
        gradient is 0 where its residuals are finite (the SSE overflowed)
        and NaN where they are not, and its σ derivative is NaN (0 · inf);
        the caller zeroes what is not finite.  K2's own gradient of such a
        lane may overflow, so it is not used."""
        if not self.kernels:
            return super().nll_and_grad(theta, sigma, rand)
        err, gnn = self._lane_grads(theta, rand)
        fail = ~torch.isfinite(err)
        f = -_gaussian(err, sigma, self.n_t).sum()
        g_th = (torch.where(fail[:, None], 0.0, gnn)
                / (2.0 * sigma**2)).sum(0)
        g_s = (torch.where(fail, 0.0, 1.0)
               * (self.n_t / sigma - err / sigma**3)).sum()
        if bool(fail.any()) and not bool(
                self._residuals_finite(theta, rand, fail).all()):
            g_th = g_th + torch.nan
        return f, g_th, g_s

    def _residuals_finite(self, theta, rand, lanes) -> torch.Tensor:
        """Whether the residuals of the individuals ``lanes`` are finite:
        their trajectories by the plain RK4 (no gradient)."""
        idx = torch.nonzero(lanes)[:, 0]
        cohort = (self.cohort.whole() if self.parts is not None
                  else self.cohort)
        sub = dataclasses.replace(cohort, **{
            f.name: getattr(cohort, f.name)[idx]
            for f in dataclasses.fields(cohort)
            if f.name != "timepoints"})
        with torch.no_grad():
            ys = simulate_cohort(self.model, theta, rand[idx], sub,
                                 substeps=self.substeps).ys
        return torch.isfinite(ys[..., 0] - sub.cpeptide).all(-1)


def cude_loglik(model: CPeptideModel, cohort: Cohort, solver: str = "rk4",
                substeps: int = 8, max_steps: int = 256) -> CohortLogLik:
    """The conditional UDE's log-likelihood on ``cohort``
    (``src/saem.jl:55-66``); fixed-step RK4 at 8 substeps by default."""
    return CohortLogLik(model, cohort, solver, substeps, max_steps)


def _lognormal_scalar_loglik(model: CPeptideModel, cohort: Cohort,
                             solver: str, substeps: int,
                             max_steps: int) -> CohortLogLik:
    """An analytic head with one scalar population parameter and the
    log-normal individual map θ_i = θ_pop·e^{η_i}
    (``src/saem-symreg.jl:51-66``)."""
    if model.kind != "analytic":
        raise ValueError(f"the log-normal map takes an analytic head, got "
                         f"{model.kind!r}")
    return CohortLogLik(model, cohort, solver, substeps, max_steps)


def symbolic_loglik(cohort: Cohort, solver: str = "rk4", substeps: int = 8,
                    max_steps: int = 256) -> CohortLogLik:
    """kM_i = kM_pop·e^{η_i} on the symbolic head."""
    # deferred import: models.symbolic imports fit.losses, as this does
    from conditional_ude_tpu_torch.models.symbolic import symbolic_model
    return _lognormal_scalar_loglik(symbolic_model(), cohort, solver,
                                    substeps, max_steps)


def discovered_loglik(cohort: Cohort, solver: str = "rk4", substeps: int = 8,
                      max_steps: int = 256) -> CohortLogLik:
    """b_i = b_pop·e^{η_i} on the in-repo discovered equation."""
    from conditional_ude_tpu_torch.models.symbolic import discovered_model
    return _lognormal_scalar_loglik(discovered_model(), cohort, solver,
                                    substeps, max_steps)


def _draws(draws, shape, generator, device):
    """Injected ``(normals, uniforms)`` of ``shape``, or new ones from
    ``generator``."""
    if draws is None:
        if generator is None:
            raise ValueError("give a torch.Generator or the draws")
        return (torch.randn(shape, generator=generator, dtype=F32,
                            device=device),
                torch.rand(shape, generator=generator, dtype=F32,
                           device=device))
    out = tuple(torch.as_tensor(np.array(d, np.float32), device=device)
                for d in draws)
    for d in out:
        if tuple(d.shape) != tuple(shape):
            raise ValueError(f"draws must have shape {tuple(shape)}, got "
                             f"{tuple(d.shape)}")
    return out


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(x), device=device)


def _pop_update(loglik: LogLik, cfg: SAEMConfig):
    """The population (fixed-effect and σ) update on the total NLL:
    ``pop_update_iters`` steps of L-BFGS over [θ, σ] as one row, or of a
    new Adam (``src/saem.jl:193-201``)."""
    if cfg.pop_update_lbfgs:
        def update(theta, sigma, rand):
            p = theta.numel()

            def fun(x):
                return -loglik(x[0, :p].reshape(theta.shape), x[0, p],
                               rand).sum().reshape(1)

            x0 = torch.cat([theta.reshape(-1), sigma.reshape(1)])[None]
            x = lbfgs_minimize(fun, x0, max_iters=cfg.pop_update_iters).x[0]
            return x[:p].reshape(theta.shape), x[p]
        return update

    def update(theta, sigma, rand):
        def vg(x):
            f, g_th, g_s = loglik.nll_and_grad(x[0].reshape(theta.shape),
                                               x[1][0], rand)
            return f.reshape(1), (g_th.reshape(1, -1), g_s.reshape(1))

        res = adam_minimize(None, (theta.reshape(1, -1), sigma.reshape(1)),
                            iters=cfg.pop_update_iters, lr=cfg.pop_adam_lr,
                            fun_and_grad=vg)
        return res.x[0].reshape(theta.shape), res.x[1][0]
    return update


def run_saem(loglik: LogLik, theta0, config: SAEMConfig = SAEMConfig(),
             generator: torch.Generator | None = None,
             draws=None) -> SAEMResult:
    """SAEM of the fixed effects ``theta0`` (a network ``[P]`` or a scalar)
    and σ, with one random effect per individual of ``loglik``.

    The random draws come from ``generator`` (on the likelihood's device)
    unless ``draws = (normals, uniforms)``, each ``[iterations,
    mcmc_steps_max, N]``, are given."""
    cfg = config
    n, dev = loglik.n, loglik.device
    steps_max = cfg.mcmc_steps_max
    normals, uniforms = _draws(draws, (cfg.iterations, steps_max, n),
                               generator, dev)
    pop_update = _pop_update(loglik, cfg)
    rand = torch.full((n,), cfg.prior_eta, dtype=F32, device=dev)
    theta = torch.as_tensor(theta0, dtype=F32, device=dev).clone()
    sigma, omega, eta, proposal_std = (
        _f32(v, dev) for v in (cfg.sigma, cfg.prior_omega, cfg.prior_eta,
                               cfg.proposal_std))
    lr, lo, hi = cfg.omega_lr, *cfg.proposal_bounds
    nll, acc_trace, pstd = [], [], []
    for it in range(1, cfg.iterations + 1):
        burn = it <= cfg.burnin
        gamma = 1.0 if burn else float(np.float32(1.0) / (
            np.float32(max(it - cfg.burnin, 1)) ** np.float32(cfg.alpha)))
        temperature = _f32(max(np.float32(1.0), np.float32(
            cfg.initial_temperature) * np.exp(np.float32(
                -cfg.temperature_decay) * np.float32(it))), dev)
        n_steps = cfg.burnin_steps if burn else cfg.n_mcmc_steps

        # -- MCMC: the steps past n_steps are inactive, their draws unused
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for j in range(n_steps):
            prop = rand + normals[it - 1, j] * proposal_std
            prior_ratio = (_normal_logpdf(prop, eta, omega)
                           - _normal_logpdf(rand, eta, omega))
            ll_new, ll_cur = loglik.values(theta, sigma,
                                           torch.stack([prop, rand]))
            log_ratio = prior_ratio + (ll_new - ll_cur) / temperature
            # a NaN log-ratio rejects
            accept = torch.log(uniforms[it - 1, j]) < log_ratio
            new = torch.where(accept, prop, rand)
            rand = (1 - gamma) * rand + gamma * new
            acc = acc + accept.sum()
        ll_total = loglik.values(theta, sigma, rand).sum()

        # -- population update: θ blended, σ overwritten ----------------------
        theta_new, sigma = pop_update(theta, sigma, rand)
        theta = (1 - gamma) * theta + gamma * theta_new

        # -- Ω, η stochastic updates -----------------------------------------
        var_r = torch.var(rand, correction=1)
        if cfg.omega_as_variance:
            omega = torch.sqrt((1 - lr) * omega**2 + lr * var_r)
        else:
            omega = (1 - lr) * omega + lr * var_r
        if cfg.update_prior_mean:
            eta = (1 - lr) * eta + lr * rand.mean()

        # -- proposal-std adaptation, after burn-in ---------------------------
        acc_rate = acc / (n * n_steps)
        if not burn:
            log_std = torch.log(proposal_std) + gamma * (
                acc_rate - cfg.target_acceptance)
            proposal_std = torch.clamp(torch.exp(log_std), lo, hi)
        nll.append(-ll_total)
        acc_trace.append(acc_rate)
        pstd.append(proposal_std)
    return SAEMResult(theta=theta, random_effects=rand, omega=omega,
                      sigma=sigma, eta=eta, nll_trace=torch.stack(nll),
                      acceptance_trace=torch.stack(acc_trace),
                      proposal_std_trace=torch.stack(pstd),
                      route=loglik.route)


def saem_cude(model: CPeptideModel, cohort: Cohort,
              initial_nn_params: torch.Tensor,
              generator: torch.Generator | None = None,
              config: SAEMConfig | None = None, draws=None) -> SAEMResult:
    """SAEM on the conditional UDE: β_i random effects, network and σ fixed
    effects (``src/saem.jl:134-237``)."""
    return run_saem(cude_loglik(model, cohort), initial_nn_params,
                    config or SAEMConfig(), generator, draws)


def saem_symbolic(cohort: Cohort, initial_km: float,
                  generator: torch.Generator | None = None,
                  config: SAEMConfig | None = None, draws=None) -> SAEMResult:
    """SAEM on the symbolic model (``src/saem-symreg.jl:134-229``): η_i
    random effects with prior mean 0, (kM_pop, σ) fixed effects by
    5-iteration L-BFGS."""
    cfg = config or SAEMConfig(pop_update_lbfgs=True, update_prior_mean=False)
    return run_saem(symbolic_loglik(cohort), initial_km, cfg, generator,
                    draws)


def saem_discovered(cohort: Cohort, initial_b: float,
                    generator: torch.Generator | None = None,
                    config: SAEMConfig | None = None,
                    draws=None) -> SAEMResult:
    """``saem_symbolic`` on the in-repo discovered equation: (b_pop, σ)
    fixed effects, b_i = b_pop·e^{η_i}."""
    cfg = config or SAEMConfig(pop_update_lbfgs=True, update_prior_mean=False)
    return run_saem(discovered_loglik(cohort), initial_b, cfg, generator,
                    draws)


# -- post-hoc per-individual estimators (06-saem.jl:102-135) --------------------

def posterior_chains(loglik: LogLik, theta, sigma, init: torch.Tensor, eta,
                     omega, n_steps: int = 3000,
                     proposal_std: float | None = None,
                     target_acceptance: float = 0.3,
                     warmup: int | None = None,
                     generator: torch.Generator | None = None, draws=None):
    """Per-individual Metropolis chains at temperature 1 with the fixed
    effects frozen: ``(samples[N, n_steps], acceptance_rate[N])``.

    The proposal scale starts at max(Ω, 1e-3) (or ``proposal_std``) and
    adapts per individual toward ``target_acceptance`` (Robbins–Monro on the
    log-scale) during the first ``warmup`` steps (default ``n_steps // 3``),
    then freezes; the acceptance rate is that of the steps after.  The
    current state's log-likelihood is carried, so a step solves the
    proposals only.  ``draws = (normals, uniforms)``, each ``[n_steps,
    N]``, replace ``generator``'s."""
    n, dev = loglik.n, loglik.device
    if warmup is None:
        warmup = n_steps // 3
    theta = torch.as_tensor(theta, dtype=F32, device=dev)
    sigma, eta, omega = (torch.as_tensor(v, dtype=F32, device=dev)
                         for v in (sigma, eta, omega))
    scale0 = (torch.clamp_min(omega, 1e-3) if proposal_std is None
              else _f32(proposal_std, dev))
    normals, uniforms = _draws(draws, (n_steps, n), generator, dev)
    rand = torch.as_tensor(init, dtype=F32, device=dev)
    ll_cur = loglik.values(theta, sigma, rand)
    log_std = torch.log(scale0).expand(n)
    acc = torch.zeros(n, dtype=torch.int64, device=dev)
    samples = torch.empty(n_steps, n, dtype=F32, device=dev)
    for t in range(n_steps):
        prop = rand + normals[t] * torch.exp(log_std)
        ll_prop = loglik.values(theta, sigma, prop)
        log_ratio = (_normal_logpdf(prop, eta, omega)
                     - _normal_logpdf(rand, eta, omega) + ll_prop - ll_cur)
        accept = torch.log(uniforms[t]) < log_ratio
        rand = torch.where(accept, prop, rand)
        ll_cur = torch.where(accept, ll_prop, ll_cur)
        if t < warmup:
            rate = float(np.float32(1.0) / (np.float32(1.0 + t)
                                            ** np.float32(0.6)))
            log_std = log_std + rate * (accept.to(F32) - target_acceptance)
        else:
            acc = acc + accept
        samples[t] = rand
    return samples.T, acc / max(n_steps - warmup, 1)


def individual_maps(loglik: LogLik, theta, sigma, init: torch.Tensor, eta,
                    omega, max_iters: int = 100) -> torch.Tensor:
    """Per-individual MAP estimates argmin −(ll + log N(η, Ω))
    (``src/saem.jl:68-84``): one batched L-BFGS, every individual a row,
    gradients by autograd through the plain solver."""
    dev = loglik.device
    theta, sigma, eta, omega = (torch.as_tensor(v, dtype=F32, device=dev)
                                for v in (theta, sigma, eta, omega))

    def obj(x):
        return -(loglik(theta, sigma, x[:, 0])
                 + _normal_logpdf(x[:, 0], eta, omega))

    x0 = torch.as_tensor(init, dtype=F32, device=dev)[:, None]
    return lbfgs_minimize(obj, x0, max_iters=max_iters).x[:, 0]


def individual_mles(loglik: LogLik, theta, sigma, init: torch.Tensor,
                    max_iters: int = 100) -> torch.Tensor:
    """Per-individual maximum-likelihood estimates (no prior), batched."""
    dev = loglik.device
    theta, sigma = (torch.as_tensor(v, dtype=F32, device=dev)
                    for v in (theta, sigma))
    x0 = torch.as_tensor(init, dtype=F32, device=dev)[:, None]
    return lbfgs_minimize(lambda x: -loglik(theta, sigma, x[:, 0]), x0,
                          max_iters=max_iters).x[:, 0]
