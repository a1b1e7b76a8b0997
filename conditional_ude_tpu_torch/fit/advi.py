"""Mean-field Gaussian ADVI for the cUDE (counterpart of
``conditional_ude_tpu/fit/advi.py``): q = N(μ, diag e^{2ρ}) by the
reparameterization trick, the ELBO maximized by Adam with a cosine-decayed
step size, and the Monte-Carlo samples and the batch (restarts or
subjects) leading tensor axes where the JAX package ``vmap``s.

* :func:`advi`: generic ADVI on ``init_mean[B, D]``, given a batched
  ``(lp, ∂lp/∂z)`` function (:func:`autograd_value_and_grad` makes one from
  a log-joint);
* :func:`advi_betas`: per-subject q(β, log σ) with the network frozen;
* :func:`advi_joint`: q over (network, every β, log σ), one batch row a
  restart.

Both ELBOs integrate by RK4 at ``substeps`` (exp_advi's 4).  The
2- or 3-input cUDE the kernels take (``kernel_route``) takes K2
(``ops/lane_grad.py``): for one
sample the ELBO's gradient is −1/(2σ²) times each lane's SSE gradient,
which K2 returns per lane, and the σ terms and the priors have closed
forms.  A step is one launch: ``n_samples`` rows of the network over the
subjects (:func:`advi_betas`), or ``B·n_samples`` rows over the fit
subjects (:func:`advi_joint`).  CUDA tensors launch the kernel, CPU
tensors run its plain version.  Every other network runs autograd through
``fit/losses.py::sse``.

The draws ε are either passed in (``normals[steps, B, n_samples, D]``, e.g.
the JAX package's, split as its ``advi`` splits its key) or drawn from a
``torch.Generator`` on the generator's device and moved to the mean's.  A
sample whose log-joint or gradient is not finite is dropped from the
step's average, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from conditional_ude_tpu_torch.analysis.profiles import fused_kernel_eligible
from conditional_ude_tpu_torch.fit.losses import sse
from conditional_ude_tpu_torch.fit.optim import (
    adam_init,
    adam_step,
    cosine_decay,
)
from conditional_ude_tpu_torch.models.cpeptide import Cohort, CPeptideModel
from conditional_ude_tpu_torch.ops import lane_grad
from conditional_ude_tpu_torch.ops.tsit5 import f32

F32 = torch.float32
LOG2PI = f32(np.log(np.float32(2.0 * np.pi)))
# a coordinate's entropy less its ρ: ½(log 2π + 1)
ENTROPY_CONST = f32(0.5 * f32(LOG2PI + 1.0))
ALPHA = 0.02            # the cosine schedule's floor, a fraction of lr

ValueAndGrad = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


class ADVIResult(NamedTuple):
    mean: torch.Tensor        # [B, D] posterior mean
    log_std: torch.Tensor     # [B, D] posterior log-std
    elbo_trace: torch.Tensor  # [B, steps] ELBO estimate after each step


class BetaPosterior(NamedTuple):
    beta_mean: torch.Tensor       # [N]
    beta_std: torch.Tensor        # [N]
    log_sigma_mean: torch.Tensor  # [N]
    log_sigma_std: torch.Tensor   # [N]
    elbo_trace: torch.Tensor      # [N, steps]


class JointPosterior(NamedTuple):
    nn_mean: torch.Tensor         # [R, P]
    nn_std: torch.Tensor          # [R, P]
    beta_mean: torch.Tensor       # [R, N]
    beta_std: torch.Tensor        # [R, N]
    log_sigma_mean: torch.Tensor  # [R]
    log_sigma_std: torch.Tensor   # [R]
    elbo_trace: torch.Tensor      # [R, steps]


def autograd_value_and_grad(log_joint: Callable[[torch.Tensor],
                                                torch.Tensor]) -> ValueAndGrad:
    """``zs[..., D] -> (lp[...], ∂lp/∂z[..., D])`` of a batched log-joint
    ``log_joint(zs[..., D]) -> lp[...]`` whose entries depend each on its
    own z, by autograd."""
    def vg(zs):
        with torch.enable_grad():
            z = zs.detach().requires_grad_(True)
            lp = log_joint(z)
            (gz,) = torch.autograd.grad(lp.sum(), z)
        return lp.detach(), gz
    return vg


def _draw_normals(normals, generator: torch.Generator | None, shape,
                 device) -> torch.Tensor:
    """``normals`` (of ``shape``) on ``device``, or new ones from
    ``generator`` drawn on its own device and moved there."""
    if normals is None:
        if generator is None:
            raise ValueError("give a torch.Generator or the normals")
        return torch.randn(shape, generator=generator, dtype=F32,
                           device=generator.device).to(device)
    out = torch.as_tensor(np.array(normals, np.float32), device=device)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"normals must have shape {tuple(shape)}, got "
                         f"{tuple(out.shape)}")
    return out


def advi(value_and_grad: ValueAndGrad, init_mean: torch.Tensor,
         steps: int = 1000, n_samples: int = 8, lr: float = 1e-2,
         init_log_std: float = -2.0, normals=None,
         generator: torch.Generator | None = None) -> ADVIResult:
    """Mean-field Gaussian ADVI on ``init_mean[B, D]``, every row its own
    problem.

    ``value_and_grad(zs[B, S, D]) -> (lp[B, S], gz[B, S, D])`` gives each
    sample's log-joint and its gradient.  Each step, as
    ``conditional_ude_tpu/fit/advi.py:75-90``: z = μ + e^ρ·ε; the samples
    whose lp and gradient are finite (``ok``) weigh w = ok / max(Σok, 1);
    ∂/∂μ = −Σ w·gz, ∂/∂ρ = −Σ w·gz·ε · e^ρ − 1; one Adam update at the
    cosine-decayed step size (floor 0.02·lr); the ELBO is
    Σ w·lp + Σ(ρ + ½(log 2π + 1)) with the updated ρ.  ``normals[steps, B,
    S, D]`` are the ε, else drawn from ``generator``.
    """
    mu = torch.as_tensor(init_mean, dtype=F32)
    rho = torch.full_like(mu, init_log_std)
    eps_all = _draw_normals(normals, generator,
                            (steps, mu.shape[0], n_samples, mu.shape[1]),
                            mu.device)
    schedule = cosine_decay(lr, steps, ALPHA)
    state = adam_init((mu, rho))
    elbos = []
    for t in range(steps):
        eps = eps_all[t]
        zs = mu[:, None] + torch.exp(rho)[:, None] * eps
        lp, gz = value_and_grad(zs)
        ok = torch.isfinite(lp) & torch.isfinite(gz).all(-1)
        w = ok.to(F32)
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1.0)
        gz = torch.where(ok[..., None], gz, 0.0)
        g_mu = -(w[..., None] * gz).sum(-2)
        g_rho = -(w[..., None] * (gz * eps)).sum(-2) * torch.exp(rho) - 1.0
        (mu, rho), state = adam_step((mu, rho), (g_mu, g_rho), state,
                                     schedule(state.count))
        entropy = (rho + ENTROPY_CONST).sum(-1)
        elbos.append((w * torch.where(ok, lp, 0.0)).sum(-1) + entropy)
    trace = torch.stack(elbos, -1) if elbos else mu.new_zeros(mu.shape[0], 0)
    return ADVIResult(mu, rho, trace)


def _gaussian_loglik(err: torch.Tensor, sigma: torch.Tensor,
                     n_obs: int) -> torch.Tensor:
    """The full Gaussian log-likelihood of an SSE, 2π constant kept
    (``fit/advi.py:98-104``)."""
    s2 = sigma**2
    return -0.5 * n_obs * (LOG2PI + torch.log(s2)) - err / (2.0 * s2)


def _log_normal_prior(x: torch.Tensor, prior: tuple[float, float]):
    """The log N(m, s) prior less its constant, and its derivative."""
    m, s = prior
    u = (x - m) / s
    return -0.5 * u**2, -u / s


def kernel_route(model: CPeptideModel, substeps: int) -> bool:
    """Whether K2 computes this model's SSE gradients: a conditional (or
    covariate) network the kernels take (``fused_kernel_eligible``), at
    any ``substeps`` the RK4 takes."""
    return fused_kernel_eligible(model, {"substeps": substeps})


def _lane_rows(model: CPeptideModel, cohort: Cohort):
    return (cohort.glucose, cohort.cpeptide,
            cohort.kinetics(with_age=model.with_age),
            tuple(float(t) for t in cohort.timepoints))


def advi_betas(model: CPeptideModel, nn_params: torch.Tensor,
               cohort: Cohort,
               prior_beta: tuple[float, float] = (-2.0, 2.0),
               prior_log_sigma: tuple[float, float] = (0.0, 2.0),
               initial_beta: float = -2.0, steps: int = 1000,
               n_samples: int = 8, lr: float = 1e-2, normals=None,
               generator: torch.Generator | None = None,
               substeps: int = 4) -> BetaPosterior:
    """Per-subject q(β, log σ) with the network ``nn_params[P]`` frozen
    (``fit/advi.py:115-159``): one batch row a subject, z = (β, log σ)
    from (``initial_beta``, 0), Gaussian priors on both.

    ``normals[steps, N, n_samples, 2]``.  RK4 at ``substeps``, as
    exp_advi calls the JAX function (whose default, without solver
    keywords, is Tsit5)."""
    n_obs = cohort.timepoints.shape[0]
    nn_params = torch.as_tensor(nn_params, dtype=F32, device=cohort.device)

    def priors(beta, log_sigma):
        lp_b, g_b = _log_normal_prior(beta, prior_beta)
        lp_s, g_s = _log_normal_prior(log_sigma, prior_log_sigma)
        return lp_b + lp_s, g_b, g_s

    if kernel_route(model, substeps):
        rows = _lane_rows(model, cohort)
        # one row of the network a sample: K2's restart axis
        nn_rows = nn_params.reshape(1, -1).expand(n_samples, -1).contiguous()

        def vg(zs):                                  # [N, S, 2]
            beta, log_sigma = zs[..., 0], zs[..., 1]
            err, _, gb = lane_grad.lane_sse_and_grad(
                model.net, nn_rows, beta.T.contiguous(), *rows, substeps)
            err, gb = err.T, gb.T                    # [N, S]
            sigma = torch.exp(log_sigma)
            s2 = sigma**2
            lp_prior, g_b, g_s = priors(beta, log_sigma)
            lp = _gaussian_loglik(err, sigma, n_obs) + lp_prior
            g_beta = -gb / (2.0 * s2) + g_b
            g_ls = -float(n_obs) + err / s2 + g_s
            return lp, torch.stack([g_beta, g_ls], -1)
    else:
        def log_joint(zs):
            beta, log_sigma = zs[..., 0], zs[..., 1]
            err = sse(model, nn_params, beta.T, cohort,
                      substeps=substeps).T
            return (_gaussian_loglik(err, torch.exp(log_sigma), n_obs)
                    + priors(beta, log_sigma)[0])
        vg = autograd_value_and_grad(log_joint)

    z0 = torch.tensor([initial_beta, 0.0], dtype=F32, device=cohort.device)
    res = advi(vg, z0.expand(cohort.n, 2), steps=steps, n_samples=n_samples,
               lr=lr, normals=normals, generator=generator)
    std = torch.exp(res.log_std)
    return BetaPosterior(beta_mean=res.mean[:, 0], beta_std=std[:, 0],
                         log_sigma_mean=res.mean[:, 1],
                         log_sigma_std=std[:, 1], elbo_trace=res.elbo_trace)


def advi_joint(model: CPeptideModel, cohort: Cohort,
               init_nn: torch.Tensor, init_betas: torch.Tensor | None = None,
               prior_nn_std: float = 10.0,
               prior_beta: tuple[float, float] = (-2.0, 2.0),
               prior_log_sigma: tuple[float, float] = (0.0, 2.0),
               steps: int = 2000, n_samples: int = 4, lr: float = 1e-2,
               normals=None, generator: torch.Generator | None = None,
               substeps: int = 4) -> JointPosterior:
    """q over z = (network, β of every subject, log σ) for each restart
    ``init_nn[R, P]``, from ``init_betas[R, N]`` (default −2) and
    log σ = 0 (``fit/advi.py:172-227``; the JAX experiment script
    ``vmap``s the restarts).  The log-joint sums each subject's Gaussian
    log-likelihood at one σ a sample, and adds −½Σ(nn/``prior_nn_std``)²
    and the Gaussian priors of the β's and log σ.

    ``normals[steps, R, n_samples, P + N + 1]``.  On K2 a step is one
    launch over the R·n_samples rows and the N subjects."""
    dev, n, n_obs = cohort.device, cohort.n, cohort.timepoints.shape[0]
    nn0 = torch.as_tensor(init_nn, dtype=F32, device=dev)
    r, p = nn0.shape
    b0 = (torch.full((r, n), -2.0, dtype=F32, device=dev)
          if init_betas is None else
          torch.as_tensor(init_betas, dtype=F32, device=dev))

    def priors(nn, betas, log_sigma):
        u = nn / prior_nn_std
        lp_nn, g_nn = -0.5 * (u**2).sum(-1), -u / prior_nn_std
        lp_b, g_b = _log_normal_prior(betas, prior_beta)
        lp_s, g_s = _log_normal_prior(log_sigma, prior_log_sigma)
        return lp_nn + lp_b.sum(-1) + lp_s, g_nn, g_b, g_s

    if kernel_route(model, substeps):
        rows = _lane_rows(model, cohort)

        def vg(zs):                                  # [R, S, D]
            flat = zs.reshape(-1, zs.shape[-1])      # K2's restart rows
            nn = flat[:, :p].contiguous()
            betas = flat[:, p:p + n].contiguous()
            log_sigma = flat[:, -1]
            err, gnn, gb = lane_grad.lane_sse_and_grad(
                model.net, nn, betas, *rows, substeps)
            sigma = torch.exp(log_sigma)[:, None]
            s2 = sigma**2
            lp_prior, g_nn, g_b, g_s = priors(nn, betas, log_sigma)
            # the lanes summed over the subjects, as jnp.sum(vmap(one))
            lp = _gaussian_loglik(err, sigma, n_obs).sum(-1) + lp_prior
            ct = -1.0 / (2.0 * s2)                   # ∂ll/∂SSE of a lane
            g = torch.cat([(ct[..., None] * gnn).sum(1) + g_nn,
                           ct * gb + g_b,
                           ((-float(n_obs) + err / s2).sum(-1)
                            + g_s)[:, None]], -1)
            return lp.reshape(zs.shape[:-1]), g.reshape(zs.shape)
    else:
        def log_joint(zs):
            nn, betas = zs[..., :p], zs[..., p:p + n]
            log_sigma = zs[..., -1]
            err = sse(model, nn[..., None, :], betas, cohort,
                      substeps=substeps)
            ll = _gaussian_loglik(err, torch.exp(log_sigma)[..., None],
                                  n_obs).sum(-1)
            return ll + priors(nn, betas, log_sigma)[0]
        vg = autograd_value_and_grad(log_joint)

    z0 = torch.cat([nn0, b0, torch.zeros(r, 1, dtype=F32, device=dev)], -1)
    res = advi(vg, z0, steps=steps, n_samples=n_samples, lr=lr,
               normals=normals, generator=generator)
    std = torch.exp(res.log_std)
    return JointPosterior(
        nn_mean=res.mean[:, :p], nn_std=std[:, :p],
        beta_mean=res.mean[:, p:p + n], beta_std=std[:, p:p + n],
        log_sigma_mean=res.mean[:, -1], log_sigma_std=std[:, -1],
        elbo_trace=res.elbo_trace)
