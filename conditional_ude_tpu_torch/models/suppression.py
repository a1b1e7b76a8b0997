"""The simulated suppression-model cUDE (counterpart of
``conditional_ude_tpu/models/suppression.py``).

A 3-state ODE whose suppression flux ``p2·u2/(1 + p4·u3)`` is replaced by a
network of the state and a per-individual conditional exp(θᵢ).  Training
fits the network and every θ jointly over a synthetic population with known
p4, so the rank correlation of θ̂ with the true p4 measures how well the
method recovers it.

Everything is batched over a leading axis of rows: networks ``[B, P]``, θ
``[B, N]``, λ one value a row.  A row's network drives ``N`` individuals
(the lanes); the frozen-network screens put a group of candidate θ's on
each row as well, so one call evaluates every (row, candidate) pair.  The
network's layers run as batched products (``torch.baddbmm``) over the
lanes of each row.  No CUDA kernel serves this model: the JAX package has
no Pallas kernel here, and the solves are PyTorch on the device of the
tensors they are given.  On a card each fit's value+grad is captured once
as a CUDA graph and replayed (``fit.optim.graphed_vg``), so the loss makes
its constants on the device and never synchronises with the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from conditional_ude_tpu_torch.fit.optim import adam_minimize, graphed_vg
from conditional_ude_tpu_torch.nn import ACTIVATIONS, MLP, chain
from conditional_ude_tpu_torch.ops.lbfgs import lbfgs_minimize
from conditional_ude_tpu_torch.ops.rk4 import solve_rk4
from conditional_ude_tpu_torch.ops.tsit5 import solve_tsit5
from conditional_ude_tpu_torch.parallel import mesh as pmesh

P_TRUE = (0.4, 0.9, 0.3)    # group-mean kinetic parameters (p1, p2, p3)
U0 = (10.0, 0.0, 0.0)
LANES_CHUNK = 1 << 22       # lanes a screening solve takes at once


def suppression_net(depth: int = 5, width: int = 3) -> MLP:
    """``depth`` tanh layers of ``width``, a softplus head, 4 inputs: the 3
    states and the conditional (``suppression/suppression.jl:13-18``)."""
    return chain(width, depth, "tanh", input_dims=4)


def lsup_rhs(t, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The ground-truth ODE (``suppression/src/suppression_model.jl:16-20``)
    on ``u[..., 3]`` with parameters ``p[..., 4]``."""
    p1, p2, p3, p4 = p.unbind(-1)
    flux = p2 * u[..., 1] / (1.0 + p4 * u[..., 2])
    return torch.stack([-p1 * u[..., 0], p1 * u[..., 0] - flux,
                        flux - p3 * u[..., 2]], -1)


def sample_group_parameters(mu_sup: float, n: int,
                            rng: np.random.Generator) -> np.ndarray:
    """N(μ, σ) individual parameters clipped ≥ 0.05, σ_sup = μ_sup/8
    (reference :33-37). Shape [n, 4]."""
    mu = np.array([*P_TRUE, mu_sup])
    std = np.array([0.1, 0.1, 0.1, mu_sup / 8.0])
    return np.maximum(mu + std * rng.standard_normal((n, 4)), 0.05)


def generate_data(group_means, group_sizes, timepoints,
                  noise_multiplicative: float = 0.0,
                  noise_additive: float = 0.0,
                  rng: np.random.Generator | None = None,
                  device: torch.device | str = "cpu"):
    """A synthetic population: ``(data[N, 3, T], gt_p4[N])``, float32 numpy.

    The draws come in the JAX package's order: each group's parameters,
    then the additive and the multiplicative noise, both drawn even when
    their multiplier is 0.  The individuals are solved together on
    ``device`` by Tsit5 at rtol 1e-6, atol 1e-8 (reference :39-63).
    """
    rng = rng or np.random.default_rng(232705)
    tp = np.asarray(timepoints, dtype=np.float32)
    params = np.concatenate([
        sample_group_parameters(gm, gs, rng)
        for gm, gs in zip(group_means, group_sizes)])      # [N, 4]
    p = torch.as_tensor(params, dtype=torch.float32, device=device)
    u0 = torch.tensor(U0, dtype=torch.float32,
                      device=device).expand(len(params), 3)
    res = solve_tsit5(lambda t, u: lsup_rhs(t, u, p), u0, tp[0], tp[-1], tp,
                      max_steps=1024, rtol=1e-6, atol=1e-8)
    sols = np.swapaxes(res.ys.cpu().numpy(), 1, 2)         # [N, 3, T]
    noise = (noise_additive * rng.standard_normal(sols.shape)
             + noise_multiplicative * sols * rng.standard_normal(sols.shape))
    data = np.maximum(sols + noise, 0.0)
    return data.astype(np.float32), params[:, 3].astype(np.float32)


def _layers(net: MLP, nn_params: torch.Tensor):
    """Each layer's ``(Wᵀ[B, fi, fo], b[B, 1, fo])`` for ``baddbmm``."""
    return [(w.transpose(-1, -2).contiguous(), b.unsqueeze(-2).contiguous())
            for w, b in net.unflatten(nn_params)]


def make_ude_rhs(net: MLP, nn_params: torch.Tensor, thetas: torch.Tensor):
    """The UDE (reference :88-95): ``f(t, u[B, M, 3])`` with the flux
    ``net([u; exp(θ)])``, row b's network ``nn_params[b]`` on its lanes'
    ``thetas[b, :]``."""
    layers = _layers(net, nn_params)
    acts = [ACTIVATIONS[a] for a in (*net.activations,
                                     net.output_activation)]
    cond = torch.exp(thetas).unsqueeze(-1)                 # [B, M, 1]
    dev = nn_params.device
    # [-p1·u1, p1·u1 - flux, flux - p3·u3] as u @ lin + flux·sign: the
    # products with the zeros of lin are exact, so every entry rounds as
    # the JAX package's expression does, in two operations a stage
    p1, _, p3 = (float(np.float32(p)) for p in P_TRUE)
    lin = torch.zeros(3, 3, device=dev)
    sign = torch.zeros(3, device=dev)
    for a, i, v in ((lin, (0, 0), -p1), (lin, (0, 1), p1),
                    (lin, (2, 2), -p3), (sign, 1, -1.0), (sign, 2, 1.0)):
        a[i].fill_(v)

    def rhs(t, u):
        h = torch.cat([u, cond], -1)
        for (wt, b), act in zip(layers, acts):
            h = act(torch.baddbmm(b, h, wt))
        return torch.addcmul(u @ lin, h, sign)

    return rhs


def simulate_population(net: MLP, nn_params: torch.Tensor,
                        thetas: torch.Tensor, u0s: torch.Tensor, timepoints,
                        max_steps: int = 512, solver: str = "rk4",
                        substeps: int = 8):
    """The UDE from ``u0s[B, M, 3]``, row b's network on its M lanes
    (reference :97-115).  Returns ``ys[B, M, T, 3]`` and ``success[B, M]``.

    RK4 at ``substeps`` by default (the training path); ``solver="tsit5"``
    is the adaptive path at the JAX package's default tolerances.
    """
    rhs = make_ude_rhs(net, nn_params, thetas)
    tp = np.asarray(timepoints, np.float32)
    if solver == "rk4":
        return solve_rk4(rhs, u0s, tp, t0=tp[0], substeps=substeps)
    if solver == "tsit5":
        return solve_tsit5(rhs, u0s, tp[0], tp[-1], tp, max_steps=max_steps)
    raise ValueError(f"solver must be 'rk4' or 'tsit5', got {solver!r}")


def _solve_groups(net, nn_params, thetas, data, timepoints, **solve):
    """Trajectories ``[B, K, N, 3, T]`` and ``ok[B, K]`` (every individual
    of the group solved) for ``thetas[B, K, N]``: K groups of θ a row, each
    over the N individuals of ``data[B or 1, N, 3, T]``."""
    b, k, n = thetas.shape
    u0 = data[..., 0].unsqueeze(-3).expand(b, k, n, 3)
    res = simulate_population(net, nn_params, thetas.reshape(b, k * n),
                              u0.reshape(b, k * n, 3), timepoints, **solve)
    sims = res.ys.reshape(b, k, n, *res.ys.shape[-2:]).transpose(-1, -2)
    return sims, res.success.reshape(b, k, n).all(-1)


def _as_data(data, dev) -> torch.Tensor:
    data = torch.as_tensor(data, dtype=torch.float32, device=dev)
    return data if data.ndim == 4 else data[None]


def _group_loss(net, nn_params, thetas, data, timepoints, lam, **solve):
    """``suppression_loss`` of every group: ``[B, K]``."""
    sims, ok = _solve_groups(net, nn_params, thetas, data, timepoints,
                             **solve)
    # scale[3]: mean over individuals of each state's maximum over time
    scale = data.amax(-1).mean(-2)[:, None, None, :, None]
    err = (((sims - data.unsqueeze(1)) / scale) ** 2).sum((-3, -2, -1))
    err = torch.where(ok, err, torch.inf)
    n = torch.full((), float(data.shape[-3]), device=err.device)
    if not torch.is_tensor(lam):
        lam = torch.full((), float(lam), device=err.device)
    pen = (nn_params ** 2).sum(-1)
    return err / n + (lam * pen)[..., None]


def suppression_loss(net: MLP, nn_params: torch.Tensor, thetas: torch.Tensor,
                     data, timepoints, lam=0.0, max_steps: int = 512,
                     solver: str = "rk4", substeps: int = 8) -> torch.Tensor:
    """Scale-normalised population SSE / N + λ‖NN‖² of every row
    (reference :117-130): ``[B]`` for ``nn_params[B, P]``, ``thetas[B, N]``
    and ``data[N, 3, T]`` (or one dataset a row, ``[B, N, 3, T]``); ``lam``
    a number or one a row.  Initial conditions are each trajectory's first
    sample; a row with a diverged individual has loss ``inf``."""
    data = _as_data(data, nn_params.device)
    return _group_loss(net, nn_params, thetas[:, None], data, timepoints,
                       lam, max_steps=max_steps, solver=solver,
                       substeps=substeps)[:, 0]


@dataclasses.dataclass(frozen=True)
class SuppressionFitConfig:
    """Reference defaults: 10,000 joint inits → best 25 → Adam×2000 +
    L-BFGS×2000 (``suppression/suppression.jl:10-11``, model file :160-168).
    ``screen_chunk`` designs are screened at once.  The fits solve by RK4 at
    8 substeps, so the JAX config's ``max_steps`` (Tsit5's) has no use."""

    initial_space: int = 10_000
    select_best_n: int = 25
    adam_iters: int = 2000
    lbfgs_iters: int = 2000
    adam_lr: float = 1e-3   # Optimisers.Adam() default
    screen_chunk: int = 512


class SuppressionFit(NamedTuple):
    nn_params: torch.Tensor    # [R, P] best first
    thetas: torch.Tensor       # [R, N]
    objectives: torch.Tensor   # [R]
    loss_traces: torch.Tensor  # [R, adam_iters]
    designs: torch.Tensor      # [R] index of each restart's initial design


def initial_designs(net: MLP, n: int, n_individuals: int,
                    generator: torch.Generator):
    """``n`` Glorot networks, then ``n`` standard-normal θ vectors, drawn
    in that order from ``generator`` (the JAX package draws them from the
    two halves of its key)."""
    nn = net.init_batch(n, generator)
    theta = torch.randn(n, n_individuals, generator=generator,
                        device=generator.device)
    return nn, theta


def fit_suppression(net: MLP, data, timepoints, lam: float = 0.0,
                    config: SuppressionFitConfig = SuppressionFitConfig(),
                    device: torch.device | str = "cpu",
                    generator: torch.Generator | None = None,
                    designs=None,
                    mesh: pmesh.Mesh | None = None) -> SuppressionFit:
    """The joint (NN, θ) multi-start fit at one λ (reference
    ``fit_suppression_model``): :func:`fit_suppression_sweep` at ``[lam]``."""
    res = fit_suppression_sweep(net, data, timepoints, [lam], config,
                                device=device, generator=generator,
                                designs=designs, mesh=mesh)
    return SuppressionFit(*(a[0] for a in res))


def fit_suppression_sweep(net: MLP, data, timepoints, lambdas,
                          config: SuppressionFitConfig = (
                              SuppressionFitConfig()),
                          device: torch.device | str = "cpu",
                          generator: torch.Generator | None = None,
                          designs=None,
                          mesh: pmesh.Mesh | None = None) -> SuppressionFit:
    """The whole λ sweep as one batch of (λ × restart) rows.

    One screen gives every design its ``(err, ‖nn‖²)``; each λ keeps the
    ``select_best_n`` designs of least ``err + λ·‖nn‖²`` (a stable sort, so
    ties keep the design order), and every kept (λ, design) pair is a row of
    one Adam and one L-BFGS, λ a value a row.  A row's trajectory depends on
    that row alone, so each λ's result is the fit at that λ alone.

    The designs are ``designs = (nn[G, P], θ[G, N])`` (e.g. the JAX
    package's draws) or :func:`initial_designs` from ``generator`` (a CPU
    generator: the card and the CPU then start from the same numbers), moved
    to ``device``; one of the two must be given.  Every field of the result has a leading λ axis
    (``nn_params[L, R, P]`` …), each λ's restarts sorted best first.

    With ``mesh`` (a ``"restarts"`` axis, ``parallel.make_mesh``) the
    screen's designs and the (λ × restart) rows split over that axis, each
    padded to it with its last entry (JAX ``models/suppression.py:248-315``):
    the padded screen entries are set to inf before the top-k, each shard
    captures its own value+grad graph, the optimizers keep their rows on
    ``device``, and the padded rows are dropped before the (λ, restart)
    axes re-form.
    """
    cfg = config
    dev = torch.device(device)
    data = _as_data(data, dev)
    n_ind = data.shape[-3]
    lambdas = torch.as_tensor(np.asarray(lambdas, np.float32), device=dev)
    if designs is None:
        if generator is None:
            raise ValueError("fit_suppression_sweep needs designs or a "
                             "generator to draw them from")
        designs = initial_designs(net, cfg.initial_space, n_ind, generator)
    nn_inits, theta_inits = (
        (a if torch.is_tensor(a) else torch.as_tensor(np.array(a)))
        .to(dev, torch.float32) for a in designs)

    def loss(nn, th, lam, data=data):
        return suppression_loss(net, nn, th, data, timepoints, lam)

    g_orig = nn_inits.shape[0]
    devices = [dev] if mesh is None else mesh.axis_devices("restarts")
    shards = len(devices)
    nn_inits = pmesh.pad_to_multiple(nn_inits, shards)
    theta_inits = pmesh.pad_to_multiple(theta_inits, shards)
    datas = [data.to(d) for d in devices]

    def screen(nn, th, data):
        chunk = max(1, cfg.screen_chunk)
        return torch.cat([loss(nn[i:i + chunk], th[i:i + chunk], 0.0, data)
                          for i in range(0, nn.shape[0], chunk)])

    with torch.no_grad():
        errs = pmesh.gather([
            screen(nn, th, d) for nn, th, d in zip(
                pmesh.split(nn_inits, devices),
                pmesh.split(theta_inits, devices), datas)], dev)
        errs[g_orig:] = torch.inf       # padded designs repeat the last
        pens = (nn_inits ** 2).sum(-1)
    losses = errs[None, :] + lambdas[:, None] * pens[None, :]      # [L, G]
    losses = torch.where(torch.isfinite(losses), losses, torch.inf)
    r = cfg.select_best_n
    top = torch.argsort(losses, dim=1, stable=True)[:, :r]         # [L, R]

    flat = top.reshape(-1)
    lanes = flat.shape[0]
    flat_pad = pmesh.pad_to_multiple(flat, shards)
    nn_c, th_c = nn_inits[flat_pad], theta_inits[flat_pad]
    lam_lane = pmesh.pad_to_multiple(lambdas.repeat_interleave(r), shards)
    lams = pmesh.split(lam_lane, devices)
    p_nn = nn_c.shape[-1]
    # one loss a shard, on its rows, its data and its λ's
    adam_losses = [lambda x, lam=lam, d=d: loss(x[0], x[1], lam, d)
                   for lam, d in zip(lams, datas)]
    adam_loss = pmesh.shard_value(adam_losses, devices)

    adam = adam_minimize(adam_loss, (nn_c, th_c), iters=cfg.adam_iters,
                         lr=cfg.adam_lr, fun_and_grad=pmesh.shard_value_and_grad(
                             adam_losses, (nn_c, th_c), devices, graphed_vg)
                         if cfg.adam_iters > 0 else None)
    nn_c, th_c = adam.x
    x = torch.cat([nn_c, th_c], -1)
    if cfg.lbfgs_iters > 0:
        x, objs = _lbfgs([lambda x, lam=lam, d=d: loss(
            x[:, :p_nn], x[:, p_nn:], lam, d) for lam, d in zip(lams, datas)],
            x, cfg.lbfgs_iters, devices)
    else:
        objs = adam_loss((nn_c, th_c))
    # the padded rows go before the (λ, restart) axes re-form
    x, objs, flat = x[:lanes], objs[:lanes], flat_pad[:lanes]
    loss_trace = adam.loss_trace[:lanes]

    n_lam = lambdas.shape[0]
    objs = objs.reshape(n_lam, r)
    order = torch.argsort(torch.where(torch.isfinite(objs), objs, torch.inf),
                          dim=1, stable=True)
    idx = (order + r * torch.arange(n_lam, device=dev)[:, None]).reshape(-1)

    def take(a):
        return a[idx].reshape(n_lam, r, *a.shape[1:])

    return SuppressionFit(nn_params=take(x[:, :p_nn]),
                          thetas=take(x[:, p_nn:]),
                          objectives=take(objs.reshape(-1)),
                          loss_traces=take(loss_trace),
                          designs=take(flat))


def _lbfgs(fun, x0: torch.Tensor, iters: int, devices=None):
    """``lbfgs_minimize(fun, x0)``, its value+grad by ``graphed_vg``:
    ``(x, f)``.  With ``devices``, ``fun`` is a list of one function a
    device, and the rows of ``x`` split evenly over them (``parallel.mesh``);
    the optimizer's state stays on ``x0``'s device."""
    funs = [fun] if devices is None else fun
    vg = pmesh.shard_value_and_grad(
        [lambda xs, f=f: f(xs[0]) for f in funs], (x0,),
        devices or [x0.device], graphed_vg)

    def value_and_grad(x):
        f, (g,) = vg((x,))
        return f, g

    res = lbfgs_minimize(None, x0, max_iters=iters,
                         value_and_grad=value_and_grad)
    return res.x, res.fval


def _best_init(group_loss, inits: torch.Tensor, n_rows: int,
               per_lanes: int) -> torch.Tensor:
    """Each row's index of the init of least finite loss (the first on a
    tie), ``group_loss(inits[i:j]) -> [rows, j - i]`` taken in chunks of at
    most ``LANES_CHUNK`` lanes."""
    step = max(1, LANES_CHUNK // max(1, n_rows * per_lanes))
    with torch.no_grad():
        losses = torch.cat([group_loss(inits[i:i + step])
                            for i in range(0, inits.shape[0], step)], 1)
    return torch.where(torch.isfinite(losses), losses, torch.inf).argmin(-1)


def validate_suppression(net: MLP, nn_params: torch.Tensor, data, timepoints,
                         theta_inits, lbfgs_iters: int = 2000):
    """θ-only refit with the network frozen, from the best of the candidate
    θ vectors ``theta_inits[n_init, N]`` (reference
    ``validate_suppression_model``, :179-222).

    ``nn_params`` is one network ``[P]`` or a row each ``[R, P]``; ``data``
    is ``[N, 3, T]`` or one dataset a row (``[R, N, 3, T]``), so several
    λ's and validation sets refit as rows of one L-BFGS.  Returns
    ``(theta, objective)``: ``[N]`` and a scalar for one network, else
    ``[R, N]`` and ``[R]``.
    """
    single = nn_params.ndim == 1
    nn = nn_params[None] if single else nn_params
    dev = nn.device
    data = _as_data(data, dev)
    inits = torch.as_tensor(theta_inits, dtype=torch.float32, device=dev)
    rows, n = nn.shape[0], inits.shape[1]

    def group_loss(th):
        return _group_loss(net, nn, th.expand(rows, *th.shape), data,
                           timepoints, 0.0)

    best = inits[_best_init(group_loss, inits, rows, n)]

    def loss(th):
        return suppression_loss(net, nn, th, data, timepoints)

    if lbfgs_iters > 0:
        theta, obj = _lbfgs(loss, best, lbfgs_iters)
    else:
        with torch.no_grad():
            theta, obj = best, loss(best)
    return (theta[0], obj[0]) if single else (theta, obj)


def _sigma_nll_groups(net, nn_params, thetas, sigmas, data_one, timepoints):
    """Per-state Gaussian NLL of ``thetas[B, K]`` with ``sigmas[B, K, 3]``,
    row b's network on its individual ``data_one[B, 3, T]``: ``[B, K]``."""
    sims, ok = _solve_groups(net, nn_params, thetas[..., None],
                             data_one[:, None], timepoints)
    err = ((sims[:, :, 0] - data_one[:, None]) ** 2).sum(-1)   # [B, K, 3]
    n_t = data_one.shape[-1]
    s2 = sigmas ** 2
    val = ((n_t / 2.0) * torch.log(s2) + err / (2.0 * s2)).sum(-1)
    return torch.where(ok, val, torch.inf)


def sigma_nll(net: MLP, nn_params: torch.Tensor, x: torch.Tensor,
              data_one: torch.Tensor, timepoints) -> torch.Tensor:
    """The per-state Gaussian NLL of each row's ``x = [θ, σ₁..σ₃]`` for its
    one individual ``data_one[B, 3, T]`` and network ``nn_params[B, P]``
    (reference ``validate_suppression_model_sigma``, :224-275): ``[B]``."""
    return _sigma_nll_groups(net, nn_params, x[:, :1], x[:, None, 1:],
                             data_one, timepoints)[:, 0]


def validate_suppression_sigma_batch(net: MLP, nn_params: torch.Tensor,
                                     data, timepoints, theta_inits,
                                     lbfgs_iters: int = 2000):
    """Per-individual (θ, σ₁..σ₃) fits, every individual a row: the best of
    the scalar θ's ``theta_inits[n_init]`` at σ = 1, then L-BFGS
    (``suppression/figures.jl:42-58``).

    ``nn_params`` is one network ``[P]`` (returns ``x[N, 4]``, ``nll[N]``)
    or several ``[K, P]``, each fitted on all of ``data[N, 3, T]`` as rows
    of one L-BFGS (returns ``x[K, N, 4]``, ``nll[K, N]``).
    """
    single = nn_params.ndim == 1
    nn = nn_params[None] if single else nn_params
    dev = nn.device
    data = _as_data(data, dev)[0]
    k, n = nn.shape[0], data.shape[0]
    nn_rows = nn.repeat_interleave(n, 0)
    data_rows = data.repeat(k, 1, 1)
    inits = torch.as_tensor(theta_inits, dtype=torch.float32, device=dev)
    rows = k * n

    def group_loss(th):
        ones = torch.ones(rows, th.shape[0], 3, device=dev)
        return _sigma_nll_groups(net, nn_rows, th.expand(rows, -1), ones,
                                 data_rows, timepoints)

    best = inits[_best_init(group_loss, inits, rows, 1)]
    x0 = torch.cat([best[:, None], torch.ones(rows, 3, device=dev)], -1)

    def nll(x):
        return sigma_nll(net, nn_rows, x, data_rows, timepoints)

    if lbfgs_iters > 0:
        xs, nlls = _lbfgs(nll, x0, lbfgs_iters)
    else:
        with torch.no_grad():
            xs, nlls = x0, nll(x0)
    xs, nlls = xs.reshape(k, n, 4), nlls.reshape(k, n)
    return (xs[0], nlls[0]) if single else (xs, nlls)


def validate_suppression_sigma(net: MLP, nn_params: torch.Tensor, data_one,
                               timepoints, theta_inits,
                               lbfgs_iters: int = 2000):
    """One individual's (θ, σ) fit, ``data_one[3, T]``: ``(x[4], nll)``."""
    data_one = torch.as_tensor(data_one, dtype=torch.float32)
    xs, nlls = validate_suppression_sigma_batch(
        net, nn_params, data_one[None], timepoints, theta_inits, lbfgs_iters)
    return xs[0], nlls[0]
