"""Joint training and frozen-network fits (counterpart of
``conditional_ude_tpu/fit/train.py``).

* ``train_conditional``: joint multi-start training of the shared network
  and k β's per individual, by one of two routes, chosen from the model and
  the config alone (:func:`kernels_compute`, the JAX package's
  ``_pallas_eligible``):

  - the kernel route, for the cUDE on any network of tanh hidden layers
    with a softplus head (the canonical ``chain(4, 2)`` or any other widths
    and depth), one β, trained by RK4: screen every initial design with
    K1 (``ops/rk4_population.py``), keep the best, refine them with Adam
    then L-BFGS on the value and exact gradient of K2 (``ops/lane_grad.py``;
    of K5, ``ops/population_grad.py``, above 131,072 restart × individual
    lanes), and re-rank with adaptive Tsit5, K3 (``ops/tsit5_cohort.py``).
    CUDA tensors launch the kernels; CPU tensors run their plain versions;
  - the generic route, for every other network, k ≥ 1 conditional
    parameters and either solver (the JAX package's ``xla_vmap`` screen and
    ``xla_reverse_ad`` refinement): the same stages on the plain batched
    solvers, the gradients by autograd, the re-rank by the plain Tsit5.  It
    launches no kernel.

  With a ``mesh`` the restarts split over its ``"restarts"`` axis
  (``parallel/mesh.py``) on either route.
* ``train_ude``: the non-conditional UDE on one series (experiment 01): a
  screen of Glorot designs, the best refined by Adam then L-BFGS, every
  restart a row; the plain batched solver with autograd gradients, as the
  JAX package takes them through XLA (no Pallas kernel computes this head).
* ``fit_betas``, ``fit_betas_sigma``, ``evaluate_model``: with the network
  fixed, each individual's β (and σ) is re-estimated by the batched L-BFGS,
  every individual a row.  Gradients go through torch autograd on the plain
  batched solver (RK4, or Tsit5 with ``solver="tsit5"``), as the JAX
  package takes them through XLA autodiff.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from conditional_ude_tpu_torch.analysis.profiles import fused_kernel_eligible
from conditional_ude_tpu_torch.fit.losses import population_sse, sse, sse_sigma
from conditional_ude_tpu_torch.fit.optim import _autograd_vg, adam_minimize
from conditional_ude_tpu_torch.models.cpeptide import (
    Cohort,
    CPeptideModel,
    production_orientations,
)
from conditional_ude_tpu_torch.nn import MLP
from conditional_ude_tpu_torch.ops import lane_grad
from conditional_ude_tpu_torch.ops.lbfgs import lbfgs_minimize
from conditional_ude_tpu_torch.parallel import mesh as pmesh
from conditional_ude_tpu_torch.utils.stats import latin_hypercube

_BIG = 1e30   # the "unbounded" box edge of the JAX package


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyper-parameters of joint training, with the JAX package's defaults
    (the reference's ``src/parameter-estimation.jl:340-348``)."""

    initial_guesses: int = 25_000
    selected_initials: int = 25
    lhs_lower: float = -2.0
    lhs_upper: float = 0.0
    n_conditional: int = 1
    adam_iters: int = 1000
    lbfgs_iters: int = 1000
    adam_lr: float = 1e-2
    # training runs fixed-step RK4 with `substeps` per observation segment
    # (or adaptive Tsit5 of at most `max_steps` steps, solver="tsit5", on
    # the generic route); RK4's final objectives are re-evaluated with
    # adaptive Tsit5
    solver: str = "rk4"
    substeps: int = 8
    max_steps: int = 256
    # designs per screening evaluation on the CPU (bounds its memory); on
    # a card all designs are screened at once
    screen_chunk: int = 4096
    final_eval_tsit5: bool = True
    # stage timers on stderr
    log_timings: bool = False


class TrainResult(NamedTuple):
    """Per-restart trained parameters, best first."""

    nn_params: torch.Tensor      # [R, P]
    betas: torch.Tensor          # [R, N, k]
    objectives: torch.Tensor     # [R]
    screen_losses: torch.Tensor  # [G] losses of all initial designs
    loss_traces: torch.Tensor    # [R, adam_iters]
    # canonical ±1 β gauge per restart (models.cpeptide.production_orientation);
    # None for k > 1 conditional parameters
    orientations: torch.Tensor | None = None
    # {"screen"/"adam"/"lbfgs"/"final_eval": seconds,
    #  "screen_path"/"refine_path": the route that ran}
    timings: dict | None = None


def initial_designs(net: MLP, n: int, generator: torch.Generator,
                    cfg: TrainConfig, seed: int | None = None):
    """Joint initial designs ``(nn_inits[G, P], betas_init[G, N, c])``:
    Glorot-uniform networks from ``generator`` and a Latin hypercube of β in
    [lhs_lower, lhs_upper], every (individual, conditional) pair its own
    dimension.  The LHS is drawn with numpy from ``seed`` (or from a seed
    the generator draws), so with the same seed it equals the JAX
    package's design bit for bit; the networks cannot, as torch and
    ``jax.random`` draw different numbers."""
    g = cfg.initial_guesses
    nn_inits = net.init_batch(g, generator)
    if seed is None:
        seed = int(torch.randint(2**62, (1,), generator=generator,
                                 device=generator.device))
    beta_flat = latin_hypercube(np.random.default_rng(seed), g,
                                n * cfg.n_conditional, cfg.lhs_lower,
                                cfg.lhs_upper)
    betas_init = torch.as_tensor(beta_flat.reshape(g, n, cfg.n_conditional),
                                 dtype=torch.float32, device=nn_inits.device)
    return nn_inits, betas_init


def _check_trainable(model: CPeptideModel, cfg: TrainConfig) -> None:
    """A conditional head whose network reads ``cfg.n_conditional`` β's."""
    if model.kind not in ("conditional", "conditional_covariate"):
        raise ValueError(
            f"train_conditional trains the conditional heads, got "
            f"{model.kind!r} (train_ude fits the 'ude' head)")
    if cfg.n_conditional != model.n_conditional:
        raise ValueError(
            f"n_conditional={cfg.n_conditional}, but the {model.kind!r} "
            f"network's {model.net.input_dims} inputs read "
            f"{model.n_conditional} conditional parameters")


def kernels_compute(model: CPeptideModel, cfg: TrainConfig) -> bool:
    """Whether the kernels compute this training, as the JAX package's
    ``_pallas_eligible`` decides: the cUDE or covariate model on a network
    of tanh hidden layers (any widths and depth) with a softplus head, at
    one conditional parameter, trained by RK4.  Otherwise the generic
    route runs."""
    return (cfg.solver == "rk4" and cfg.n_conditional == 1
            and fused_kernel_eligible(model))


def train_conditional(model: CPeptideModel, cohort: Cohort,
                      config: TrainConfig = TrainConfig(),
                      generator: torch.Generator | None = None,
                      seed: int | None = None,
                      designs=None, mesh: pmesh.Mesh | None = None
                      ) -> TrainResult:
    """Joint training of the shared network and every individual's β's
    (``src/parameter-estimation.jl:340-386``), on ``cohort.device``.

    The designs come from ``generator`` (a ``torch.Generator`` on the
    cohort's device; a fresh one seeded with ``seed`` when absent) and the
    LHS from ``seed``, or are given as ``designs=(nn_inits[G, P],
    betas_init[G, N, k])``, e.g. the JAX package's, for parity.

    The kernels train every model the JAX kernels take
    (:func:`kernels_compute`: tanh hidden layers of any widths and depth,
    a softplus head, k = 1, RK4); any other network, k > 1 or
    ``solver="tsit5"`` takes the generic route, which launches no kernel.
    ``timings`` names the route: ``screen_path`` ``cuda_k1`` / ``plain`` or ``torch_batched``,
    ``refine_path`` ``cuda_k2`` / ``cuda_k5`` / ``plain`` / ``plain_k5`` or
    ``autograd``.

    With ``mesh`` (``parallel.make_mesh``, a ``"restarts"`` axis) every
    evaluation splits its restarts over that axis, the whole cohort on each
    device (the first device of each row of a 2-D mesh), as the JAX
    package's mesh paths (``fit/train.py:263-372``): the designs are
    padded to the axis and the padded screen entries set to inf before the
    top-k; the selected restarts are padded with the last of them, refined,
    and sliced off before ranking; the routes' names end in ``+meshN``.
    The optimizers' state stays on the cohort's device, so a padded row
    never touches a real one.
    """
    cfg = config
    _check_trainable(model, cfg)
    net = model.net
    dev = cohort.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    if designs is None:
        if generator is None:
            generator = torch.Generator(device=dev)
            if seed is None:
                generator.seed()
            else:
                generator.manual_seed(seed)
        nn_inits, betas_init = initial_designs(net, cohort.n, generator, cfg,
                                               seed)
    else:
        nn_inits, betas_init = (torch.as_tensor(np.array(a), dtype=torch.float32)
                                for a in designs)
    nn_inits, betas_init = nn_inits.to(dev), betas_init.to(dev)
    # the lanes' layout: betas[..., N] at k = 1, [..., N, k] above
    if cfg.n_conditional == 1:
        betas_init = betas_init.reshape(*betas_init.shape[:2])
    # unsharded, the whole run is one shard on the cohort's device
    g_orig, k = nn_inits.shape[0], cfg.selected_initials
    devices = [dev] if mesh is None else mesh.axis_devices("restarts")
    shards = len(devices)
    nn_inits = pmesh.pad_to_multiple(nn_inits, shards)
    betas_init = pmesh.pad_to_multiple(betas_init, shards)
    stages = (_kernel_stages if kernels_compute(model, cfg)
              else _generic_stages)(model, cohort, cfg, devices)

    # -- screen every design -------------------------------------------------
    screen = stages.screen(nn_inits, betas_init)
    # padded designs repeat the last one: keep them out of the top-k
    screen[g_orig:] = torch.inf
    sync()
    t1 = time.perf_counter()

    # -- top-k, a stable sort as jnp.argsort's -------------------------------
    top = torch.argsort(torch.where(torch.isfinite(screen), screen, torch.inf),
                        stable=True)[:k]
    nn0 = pmesh.pad_to_multiple(nn_inits[top], shards)
    b0 = pmesh.pad_to_multiple(betas_init[top], shards)

    # -- Adam, then L-BFGS on the flat [nn, β] rows --------------------------
    vg = stages.value_and_grad((nn0, b0))
    adam = adam_minimize(stages.loss, (nn0, b0), iters=cfg.adam_iters,
                         lr=cfg.adam_lr, fun_and_grad=vg)
    nn1, b1 = adam.x
    sync()
    t2 = time.perf_counter()

    p = nn1.shape[1]
    if cfg.lbfgs_iters > 0:
        def value_and_grad(x):
            f, (g_nn, g_b) = vg((x[:, :p], x[:, p:].reshape(b1.shape)))
            return f, torch.cat([g_nn, g_b.flatten(1)], dim=1)

        res = lbfgs_minimize(None, torch.cat([nn1, b1.flatten(1)], dim=1),
                             max_iters=cfg.lbfgs_iters,
                             value_and_grad=value_and_grad)
        nn2, b2, objs = res.x[:, :p], res.x[:, p:].reshape(b1.shape), res.fval
    else:
        # objectives from one evaluation of the training loss
        nn2, b2 = nn1, b1
        objs = stages.value(nn2, b2)
    sync()
    t3 = time.perf_counter()

    # -- re-rank with adaptive Tsit5 ------------------------------------------
    if cfg.final_eval_tsit5 and cfg.solver != "tsit5":
        objs = stages.rerank(nn2, b2)
    sync()
    t4 = time.perf_counter()
    screen_path, refine_path = stages.paths(nn0.shape[0] // shards)
    if mesh is not None:
        screen_path += f"+mesh{shards}"
        refine_path += f"+mesh{shards}"
    # the padded restarts go before ranking
    nn2, b2, objs, screen = nn2[:k], b2[:k], objs[:k], screen[:g_orig]
    loss_trace = adam.loss_trace[:k]
    timings = {"screen": t1 - t0, "adam": t2 - t1, "lbfgs": t3 - t2,
               "final_eval": t4 - t3, "screen_path": screen_path,
               "refine_path": refine_path}
    if cfg.log_timings:
        print(f"[train_conditional] screen={timings['screen']:.1f}s "
              f"adam={timings['adam']:.1f}s lbfgs={timings['lbfgs']:.1f}s "
              f"final_eval={timings['final_eval']:.1f}s "
              f"screen_path={timings['screen_path']} "
              f"refine_path={timings['refine_path']}", file=sys.stderr)

    order = torch.argsort(torch.where(torch.isfinite(objs), objs, torch.inf),
                          stable=True)
    orients = None
    if cfg.n_conditional == 1:
        # the covariate model's gauge is taken at the cohort's mean age
        orients = production_orientations(model, nn2,
                                          age=cohort.age.mean())[order]
    return TrainResult(nn_params=nn2[order],
                       betas=b2[order].reshape(nn2.shape[0], cohort.n, -1),
                       objectives=objs[order], screen_losses=screen,
                       loss_traces=loss_trace[order],
                       orientations=orients, timings=timings)


class _Stages(NamedTuple):
    """A route's evaluations, each over rows split evenly over the
    devices and gathered in order: ``screen(nn[G, P], b[G, N(, k)]) ->
    [G]``; ``value_and_grad(x0)`` -> ``(nn, b) -> (f[R], (∇nn, ∇b))`` at
    the shapes of ``x0``; ``loss((nn, b))``, the training loss after Adam;
    ``value(nn, b)``, the objectives where L-BFGS takes no step;
    ``rerank(nn, b)``, the Tsit5 objectives; ``paths(restarts of a
    shard)``, the route's names."""

    screen: Callable
    value_and_grad: Callable
    loss: Callable
    value: Callable
    rerank: Callable
    paths: Callable


def _kernel_stages(model: CPeptideModel, cohort: Cohort, cfg: TrainConfig,
                   devices) -> _Stages:
    """K1 screens, K2 (K5) refines, K3 re-ranks; each shard on its device
    (``parallel/mesh.py``)."""
    net, cuda = model.net, cohort.device.type == "cuda"
    split = pmesh.make_mesh(("restarts",), devices=devices)
    pop_vg = pmesh.sharded_population_vg(
        net, pmesh.cohort_args(cohort, model.with_age), split,
        substeps=cfg.substeps)

    def screen(nn, b, chunk=None if cuda else cfg.screen_chunk):
        return pmesh.sharded_screen(net, nn, b, cohort, split,
                                    substeps=cfg.substeps, chunk=chunk)

    def vg(x):
        f, g_nn, g_b = pop_vg(*x)
        return f, (g_nn, g_b)

    def paths(restarts):
        # the value+grad kernel that ran: K2 on packed lanes, K5 above its
        # limit, decided by a shard's own restarts
        if lane_grad.takes_restart_kernel(restarts, cohort.n):
            refine = "cuda_k5" if cuda else "plain_k5"
        else:
            refine = "cuda_k2" if cuda else "plain"
        return ("cuda_k1" if cuda else "plain"), refine

    return _Stages(
        screen=screen, value_and_grad=lambda _: vg,
        loss=lambda x: lane_grad.PopulationSSE.apply(*x, pop_vg),
        value=lambda nn, b: screen(nn, b, chunk=None),
        rerank=lambda nn, b: pmesh.sharded_screen_tsit5(
            net, nn, b, cohort, split, max_steps=cfg.max_steps),
        paths=paths)


def _generic_stages(model: CPeptideModel, cohort: Cohort, cfg: TrainConfig,
                    devices) -> _Stages:
    """The plain batched ``population_sse`` at ``cfg.solver`` (the JAX
    package's ``xla_vmap`` screen and ``xla_reverse_ad`` refinement): the
    screen in chunks of ``screen_chunk`` on the CPU, autograd for the
    refinement, the plain Tsit5 for the re-rank; each shard on its device
    with its own copy of the cohort."""
    dev = cohort.device
    cohorts = [cohort if d == dev else pmesh.cohort_to(cohort, d)
               for d in devices]
    train_kw = dict(solver=cfg.solver, substeps=cfg.substeps,
                    max_steps=cfg.max_steps)

    def losses(**kw):
        """``(nn[R, P], b[R, N(, k)]) -> [R]``, one a shard."""
        return [lambda x, c=c: population_sse(model, x[0][:, None, :], x[1],
                                              c, **kw)
                for c in cohorts]

    def values(**kw):
        value = pmesh.shard_value(losses(**kw), devices)
        return lambda nn, b: value((nn, b))

    def screen(nn, b):
        outs = []
        with torch.no_grad():
            for nn_k, b_k, loss in zip(pmesh.split(nn, devices),
                                       pmesh.split(b, devices),
                                       losses(**train_kw)):
                step = (nn_k.shape[0] if dev.type == "cuda"
                        else max(1, cfg.screen_chunk))
                outs.append(torch.cat([
                    loss((nn_k[i:i + step], b_k[i:i + step]))
                    for i in range(0, nn_k.shape[0], step)]))
        return pmesh.gather(outs, dev)

    value = values(**train_kw)
    return _Stages(
        screen=screen,
        value_and_grad=lambda x0: pmesh.shard_value_and_grad(
            losses(**train_kw), x0, devices,
            lambda fun, _: _autograd_vg(fun)),
        loss=lambda x: value(*x), value=value,
        rerank=values(solver="tsit5", max_steps=cfg.max_steps),
        paths=lambda restarts: ("torch_batched", "autograd"))


class UDETrainResult(NamedTuple):
    """``train_ude``'s networks, best first (the JAX function returns the
    first three)."""

    nn_params: torch.Tensor      # [R, P]
    objectives: torch.Tensor     # [R] SSE on the series
    screen_losses: torch.Tensor  # [G] SSE of every design
    timings: dict                # {"screen"/"adam"/"lbfgs": seconds}


def train_ude(model: CPeptideModel, individual: Cohort, data,
              initial_guesses: int = 10_000, selected_initials: int = 10,
              adam_iters: int = 1000, lbfgs_iters: int = 1000,
              adam_lr: float = 1e-2, substeps: int = 8,
              screen_chunk: int = 4096,
              generator: torch.Generator | None = None,
              designs=None, solver: str = "rk4",
              max_steps: int = 256) -> UDETrainResult:
    """The UDE head's network fitted to one series
    (``src/parameter-estimation.jl:211-247``), on ``individual.device``.

    ``individual`` is one row (``build_individual``) and ``data[T]`` its
    c-peptide on ``individual.timepoints``.  ``initial_guesses`` Glorot
    designs from ``generator`` (or ``designs[G, P]``, e.g. the JAX
    package's ``init_batch``) are screened by the SSE at ``solver`` (RK4
    at ``substeps``, or Tsit5 of at most ``max_steps`` steps); the
    ``selected_initials`` best are refined by Adam, then L-BFGS, every
    restart a row.
    """
    if model.kind != "ude":
        raise ValueError(f"train_ude fits the 'ude' head, got {model.kind!r}")
    dev = individual.device
    series = dataclasses.replace(individual, cpeptide=torch.as_tensor(
        np.asarray(data), dtype=torch.float32, device=dev).reshape(1, -1))
    t0 = time.perf_counter()
    if designs is None:
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.seed()
        nn_inits = model.net.init_batch(initial_guesses, generator)
    else:
        nn_inits = torch.as_tensor(np.array(designs), dtype=torch.float32)
    nn_inits = nn_inits.to(dev)

    def loss(nn: torch.Tensor) -> torch.Tensor:
        return sse(model, nn[:, None, :], None, series, substeps=substeps,
                   solver=solver, max_steps=max_steps)[:, 0]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    chunk = nn_inits.shape[0] if dev.type == "cuda" else max(1, screen_chunk)
    with torch.no_grad():
        screen = torch.cat([loss(nn_inits[i:i + chunk])
                            for i in range(0, nn_inits.shape[0], chunk)])
    top = torch.argsort(torch.where(torch.isfinite(screen), screen, torch.inf),
                        stable=True)[:selected_initials]
    sync()
    t1 = time.perf_counter()
    adam = adam_minimize(lambda x: loss(x[0]), (nn_inits[top],),
                         iters=adam_iters, lr=adam_lr)
    sync()
    t2 = time.perf_counter()
    res = lbfgs_minimize(loss, adam.x[0], max_iters=lbfgs_iters)
    sync()
    t3 = time.perf_counter()
    order = torch.argsort(torch.where(torch.isfinite(res.fval), res.fval,
                                      torch.inf), stable=True)
    return UDETrainResult(res.x[order], res.fval[order], screen,
                          {"screen": t1 - t0, "adam": t2 - t1,
                           "lbfgs": t3 - t2})


def _initial(initial_beta, cohort: Cohort) -> torch.Tensor:
    b0 = torch.as_tensor(initial_beta, dtype=torch.float32,
                         device=cohort.device)
    return b0.expand(torch.broadcast_shapes(b0.shape, (cohort.n,)))


def fit_betas(model: CPeptideModel, nn_params: torch.Tensor, cohort: Cohort,
              initial_beta=-2.0, bounds=(-4.0, 1.0), lbfgs_iters: int = 1000,
              substeps: int = 8, solver: str = "rk4", max_steps: int = 256):
    """Per-individual bounded β re-estimation with the network frozen.

    ``nn_params[..., P]`` broadcasts against ``[..., N, P]`` and
    ``initial_beta`` against ``[..., N]``.  The SSE is RK4's at
    ``substeps`` or Tsit5's of at most ``max_steps`` steps
    (``solver="tsit5"``).  Returns ``(betas, objectives)`` of that batch
    shape.
    """
    b0 = _initial(initial_beta, cohort)
    batch = b0.shape
    lb, ub = bounds
    opts = dict(dtype=torch.float32, device=cohort.device)

    def loss(x):
        return sse(model, nn_params, x.reshape(batch), cohort,
                   substeps=substeps, solver=solver,
                   max_steps=max_steps).reshape(-1)

    res = lbfgs_minimize(loss, b0.reshape(-1, 1),
                         lower=torch.tensor([lb], **opts),
                         upper=torch.tensor([ub], **opts),
                         max_iters=lbfgs_iters)
    return res.x[:, 0].reshape(batch), res.fval.reshape(batch)


def fit_betas_sigma(model: CPeptideModel, nn_params: torch.Tensor,
                    cohort: Cohort, initial_beta=-2.0, bounds=(-4.0, 1.0),
                    lbfgs_iters: int = 1000, substeps: int = 8,
                    solver: str = "rk4", max_steps: int = 256):
    """(β, σ) re-estimation by the Gaussian NLL; initial σ 1.0; the solver
    as :func:`fit_betas`'.

    σ is floored at 1e-6: the NLL is even in σ, and the positive floor
    keeps the optimizer on the positive one of two equal minima.  Returns
    ``(betas[N], sigmas[N], objectives[N])``.
    """
    b0 = _initial(initial_beta, cohort)
    lb, ub = bounds
    opts = dict(dtype=torch.float32, device=cohort.device)

    def loss(x):
        return sse_sigma(model, nn_params, x[:, 0], x[:, 1], cohort,
                         substeps=substeps, solver=solver,
                         max_steps=max_steps)

    res = lbfgs_minimize(loss, torch.stack([b0, torch.ones_like(b0)], -1),
                         lower=torch.tensor([lb, 1e-6], **opts),
                         upper=torch.tensor([ub, _BIG], **opts),
                         max_iters=lbfgs_iters)
    return res.x[:, 0], res.x[:, 1], res.fval


def evaluate_model(model: CPeptideModel, candidates_nn: torch.Tensor,
                   betas_train: torch.Tensor, cohort: Cohort,
                   lbfgs_iters: int = 1000, substeps: int = 8,
                   solver: str = "rk4", max_steps: int = 256) -> torch.Tensor:
    """Validation objectives ``[R, N_valid]`` for model selection: for each
    candidate network ``candidates_nn[R, P]``, an unbounded β fit on every
    validation individual (the solver as :func:`fit_betas`'), started from
    the mean of that candidate's training β's (``betas_train[R,
    N_train(, 1)]``)."""
    init = betas_train.reshape(betas_train.shape[0], -1).mean(1)
    _, objectives = fit_betas(
        model, candidates_nn[:, None, :], cohort,
        initial_beta=init[:, None].expand(-1, cohort.n),
        bounds=(-_BIG, _BIG), lbfgs_iters=lbfgs_iters, substeps=substeps,
        solver=solver, max_steps=max_steps)
    return objectives


def select_best(objectives: torch.Tensor) -> int:
    """argmin over candidates of the summed validation objectives."""
    return int(torch.argmin(objectives.sum(1)))
