"""Symbolic regression by genetic programming (counterpart of
``conditional_ude_tpu/analysis/symreg.py``): closed-form equations for the
learned production surface over (β, ΔG) → production samples, with PySR's
operator set (binary ``+``/``*``, unary ``inv``, and ``DIV`` rendered as
``mul∘inv``) and a Pareto front over (complexity, loss).

Programs are complete binary trees of depth ``D`` (2^(D+1) − 1 nodes) held
as an integer op tensor and a constant tensor of one row each.  A
population is evaluated on every sample in one pass a tree level: the
children of a level are the level below at strides ``0::2``/``1::2``, and
each node selects its value from the seven candidates, all computed, as the
JAX package's ``jnp.select`` does.  The select is a chain of
``torch.where``: an unselected candidate receives a zero cotangent, so
``0 · (1/left²)`` at ``left = 0`` (ΔG = 0 samples) is NaN as in JAX, and
the constant optimisation zeroes exactly the gradient entries JAX zeroes.

Every random array the search consumes comes from one ``draws`` object
(:class:`TorchDraws` on the main path: a ``torch.Generator`` on the
device), addressed as the JAX package addresses its keys, so that an
implementation replaying ``jax.random`` reproduces JAX's search step by
step.  No kernel serves the search: selection, variation and evaluation are
batched PyTorch tensors on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple, Protocol

import numpy as np
import torch

from conditional_ude_tpu_torch.fit.optim import adam_init, adam_step
from conditional_ude_tpu_torch.ops.tsit5 import f32

# node opcodes; DIV is protected binary division, counted and rendered as
# PySR's mul∘inv
PASS, CONST, VAR0, VAR1, ADD, MUL, INV, DIV = range(8)
_LEAF_OPS = (CONST, VAR0, VAR1)
_BINARY_OPS = (ADD, MUL, DIV)

# the op pools of the draws and their probabilities
INTERIOR_OPS = (ADD, MUL, INV, DIV, CONST, VAR0, VAR1)
INTERIOR_P = (0.22, 0.22, 0.06, 0.1, 0.1, 0.15, 0.15)
LEAF_P = (0.34, 0.33, 0.33)                     # over _LEAF_OPS
MUTATION_P = (0.2, 0.2, 0.07, 0.09, 0.14, 0.15, 0.15)   # over INTERIOR_OPS
KILL_RANGE = (0.15, 0.8)        # per-program leaf-termination probability
JITTER = 0.3                    # scale of the constants' mutation


def n_nodes(depth: int) -> int:
    return 2 ** (depth + 1) - 1


@dataclasses.dataclass(frozen=True)
class SymRegConfig:
    depth: int = 3                  # complete-tree depth (15 nodes)
    population: int = 2048
    generations: int = 60
    tournament: int = 7
    p_mutate: float = 0.6
    p_crossover: float = 0.4
    const_range: tuple[float, float] = (-5.0, 5.0)
    const_opt_steps: int = 30       # Adam steps on constants of survivors
    const_opt_lr: float = 0.1
    elite: int = 32
    parsimony: float = 1e-5         # complexity penalty ("parsimony" mode)
    # generations a block; between blocks the hall of fame (best-ever
    # program a complexity) is updated, re-optimised and re-injected
    block_gens: int = 20
    const_opt_top: int = 64         # population members const-opted a block
    fresh_frac: float = 0.15        # share replaced by fresh programs a block
    # "pareto": non-domination over (loss, complexity); "parsimony": loss
    # plus ``parsimony`` times complexity
    selection: str = "pareto"
    # share of random programs seeded with the rational template
    template_frac: float = 0.2
    # PySR-style hard size cap; None = uncapped
    max_size: int | None = None

    def __post_init__(self):
        if self.selection not in ("pareto", "parsimony"):
            raise ValueError(
                f"SymRegConfig.selection must be 'pareto' or 'parsimony', "
                f"got {self.selection!r}")


class SymRegResult(NamedTuple):
    ops: torch.Tensor         # [P, M] final population opcodes (+ the hall)
    consts: torch.Tensor      # [P, M] constants
    losses: torch.Tensor      # [P] MSE
    complexity: torch.Tensor  # [P]


class ProgramDraws(NamedTuple):
    """The draws of a batch of ``n`` random programs of ``m`` nodes."""
    interior: torch.Tensor    # [n, m] ops from INTERIOR_OPS at INTERIOR_P
    leaves: torch.Tensor      # [n, m] ops from _LEAF_OPS at LEAF_P
    q: torch.Tensor           # [n, 1] uniform on KILL_RANGE
    kill: torch.Tensor        # [n, m] uniform on [0, 1)
    tmpl: torch.Tensor        # [n] uniform on [0, 1)
    consts: torch.Tensor      # [n, m] uniform on the constants' range


class GenerationDraws(NamedTuple):
    """The draws of one generation of a population ``pop`` (the eight keys
    of the JAX package's ``split(k, 8)``)."""
    t1: torch.Tensor          # [pop, tournament] first parents' entrants
    t2: torch.Tensor          # [pop, tournament] second parents' entrants
    mut_sel: torch.Tensor     # [pop] uniform: mutate this child?
    mut_node: torch.Tensor    # [pop, m] uniform: mutate this node?
    mut_op: torch.Tensor      # [pop, m] ops from INTERIOR_OPS at MUTATION_P
    mut_c: torch.Tensor       # [pop, m] standard normal constants' jitter
    x: torch.Tensor           # [pop] uniform: cross over?
    x_node: torch.Tensor      # [pop] the crossover node, uniform on [0, m)


class Draws(Protocol):
    """The search's source of randomness.  ``blk`` None is the initial
    population (JAX's ``k_init``), else block ``blk``'s fresh programs
    (``fold_in(k_final, blk)``); generation ``g`` of the ``gens`` of block
    ``blk`` is JAX's ``split(fold_in(k_gens, blk), gens)[g]``."""

    def programs(self, blk: int | None, n: int, m: int,
                 const_range: tuple[float, float]) -> ProgramDraws: ...

    def generation(self, blk: int, g: int, gens: int, pop: int, m: int,
                   tournament: int) -> GenerationDraws: ...


class TorchDraws:
    """The main path's draws: one ``torch.Generator`` on ``device``, seeded
    ``seed``, consumed in the search's order.  Each array has the
    distribution of JAX's (the op choices by JAX's inverse-CDF rule)."""

    def __init__(self, seed: int, device: torch.device | str):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def _uniform(self, shape, lo: float = 0.0, hi: float = 1.0):
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return u if (lo, hi) == (0.0, 1.0) else u * f32(hi - lo) + f32(lo)

    def _choice(self, ops, p, shape):
        cum = torch.cumsum(torch.tensor(p, dtype=torch.float32,
                                        device=self.device), 0)
        r = cum[-1] * (1.0 - self._uniform(shape))
        idx = torch.searchsorted(cum, r).clamp_max(len(ops) - 1)
        return torch.tensor(ops, dtype=torch.int32, device=self.device)[idx]

    def _randint(self, hi: int, shape):
        return torch.randint(0, hi, shape, generator=self.gen,
                             device=self.device)

    def programs(self, blk, n, m, const_range):
        return ProgramDraws(
            interior=self._choice(INTERIOR_OPS, INTERIOR_P, (n, m)),
            leaves=self._choice(_LEAF_OPS, LEAF_P, (n, m)),
            q=self._uniform((n, 1), *KILL_RANGE),
            kill=self._uniform((n, m)),
            tmpl=self._uniform((n,)),
            consts=self._uniform((n, m), *const_range))

    def generation(self, blk, g, gens, pop, m, tournament):
        return GenerationDraws(
            t1=self._randint(pop, (pop, tournament)),
            t2=self._randint(pop, (pop, tournament)),
            mut_sel=self._uniform((pop,)),
            mut_node=self._uniform((pop, m)),
            mut_op=self._choice(INTERIOR_OPS, MUTATION_P, (pop, m)),
            mut_c=torch.randn((pop, m), generator=self.gen,
                              device=self.device),
            x=self._uniform((pop,)),
            x_node=self._randint(m, (pop,)))


def _level_slices(depth: int) -> list[tuple[int, int]]:
    """(start, end) node-index ranges per level, root = index 0."""
    return [(2 ** lv - 1, 2 ** (lv + 1) - 1) for lv in range(depth + 1)]


def evaluate(ops: torch.Tensor, consts: torch.Tensor, x: torch.Tensor,
             depth: int) -> torch.Tensor:
    """``ops``/``consts`` ``[..., M]`` on ``x [N, 2]`` → values ``[..., N]``.

    Bottom-up a level at a time; the bottom level's children are NaN, so a
    binary op there (or over PASS children) gives NaN.  Each node's value
    is its op's candidate among all seven, PASS giving 0."""
    n_pts = x.shape[0]
    x0, x1 = x[:, 0], x[:, 1]
    # 1/left as JAX's division, whose cotangent of left is −g·1/left²
    one = torch.ones((), dtype=x.dtype, device=x.device)
    below = None                        # [..., 2^(lv+1), N]
    for lv in range(depth, -1, -1):
        s, e = 2 ** lv - 1, 2 ** (lv + 1) - 1
        op = ops[..., s:e, None]
        c = consts[..., s:e, None]
        shape = op.shape[:-1] + (n_pts,)
        if below is None:
            left = right = torch.full(shape, float("nan"), dtype=x.dtype,
                                      device=x.device)
        else:
            left, right = below[..., 0::2, :], below[..., 1::2, :]
        candidates = ((CONST, c.expand(shape)), (VAR0, x0.expand(shape)),
                      (VAR1, x1.expand(shape)), (ADD, left + right),
                      (MUL, left * right), (INV, torch.div(one, left)),
                      (DIV, left / right))
        value = torch.zeros(shape, dtype=x.dtype, device=x.device)
        for code, cand in reversed(candidates):
            value = torch.where(op == code, cand, value)
        below = value
    return below[..., 0, :]


def complexity_of(ops: torch.Tensor) -> torch.Tensor:
    """Active (non-PASS) nodes, DIV counting 2 (PySR's ``mul(a, inv(b))``),
    int32."""
    return ((ops != PASS).sum(-1) + (ops == DIV).sum(-1)).to(torch.int32)


def _subtree_mask(depth: int) -> np.ndarray:
    """[M, M] bool: mask[i, j] = node j is in the subtree rooted at i."""
    m = n_nodes(depth)
    mask = np.zeros((m, m), bool)
    for i in range(m - 1, -1, -1):
        mask[i, i] = True
        for ch in (2 * i + 1, 2 * i + 2):
            if ch < m:
                mask[i] |= mask[ch]
    return mask


def _structure_ok(ops: torch.Tensor, depth: int) -> torch.Tensor:
    """Validity: binary nodes need both children active, INV its left only,
    leaves and PASS none; the root must be active."""
    m = n_nodes(depth)
    ok = ops[..., 0] != PASS
    for i in range(m):
        op = ops[..., i]
        l_i, r_i = 2 * i + 1, 2 * i + 2
        if l_i < m:
            l_on, r_on = ops[..., l_i] != PASS, ops[..., r_i] != PASS
        else:
            l_on = r_on = torch.zeros_like(op, dtype=torch.bool)
        is_bin = (op == ADD) | (op == MUL) | (op == DIV)
        is_un = op == INV
        ok = ok & torch.where(is_bin, l_on & r_on,
                              torch.where(is_un, l_on & ~r_on,
                                          ~l_on & ~r_on))
    return ok


def repair(ops: torch.Tensor, depth: int) -> torch.Tensor:
    """Valid structures, top-down a level at a time: children of leaves
    and PASS become PASS, INV's right child PASS; a missing child of a
    binary or unary op becomes a VAR1 (left) or VAR0 (right) leaf, and an
    op on the bottom level becomes VAR1."""
    ops = ops.clone()
    for lv in range(depth + 1):
        s, e = 2 ** lv - 1, 2 ** (lv + 1) - 1
        op = ops[..., s:e]
        if lv == depth:
            is_op = (op == ADD) | (op == MUL) | (op == INV) | (op == DIV)
            ops[..., s:e] = torch.where(is_op, VAR1, op)
            continue
        s2, e2 = 2 ** (lv + 1) - 1, 2 ** (lv + 2) - 1
        is_bin = (op == ADD) | (op == MUL) | (op == DIV)
        needs_l = is_bin | (op == INV)
        left, right = ops[..., s2:e2:2], ops[..., s2 + 1:e2:2]
        new_l = torch.where(needs_l & (left == PASS), VAR1,
                            torch.where(~needs_l, PASS, left))
        new_r = torch.where(is_bin & (right == PASS), VAR0,
                            torch.where(~is_bin, PASS, right))
        ops[..., s2:e2:2] = new_l
        ops[..., s2 + 1:e2:2] = new_r
    return ops


def random_programs(draws: Draws, blk: int | None, n: int, depth: int,
                    const_range: tuple[float, float],
                    template_frac: float = 0.0):
    """A grow-style batch of ``n`` random programs from ``draws``: interior
    ops, leaf ops on the bottom level, each program killing interior nodes
    to leaves at its own rate ``q``; ``template_frac`` of them get the
    rational template (root DIV, node 2 ADD, node 6 CONST); then repaired.
    Returns (ops int32, consts float32)."""
    m = n_nodes(depth)
    d = draws.programs(blk, n, m, const_range)
    level = np.zeros(m, np.int32)
    for lv, (s, e) in enumerate(_level_slices(depth)):
        level[s:e] = lv
    is_bottom = torch.as_tensor(level == depth, device=d.interior.device)
    ops = torch.where(is_bottom[None, :], d.leaves, d.interior)
    kill = d.kill < d.q
    ops = torch.where(kill & ~is_bottom[None, :], d.leaves, ops)
    if template_frac > 0.0 and depth >= 2:
        tmpl = d.tmpl < f32(template_frac)
        ops = ops.clone()
        for node, code in ((0, DIV), (2, ADD), (6, CONST)):
            ops[:, node] = torch.where(tmpl, code, ops[:, node])
    return repair(ops.to(torch.int32), depth), d.consts


def _row_mse(ops, consts, x, y, depth):
    d = evaluate(ops, consts, x, depth) - y
    return (d * d).mean(-1)


@torch.no_grad()
def loss_of(ops: torch.Tensor, consts: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor, depth: int,
            max_size: int | None = None) -> torch.Tensor:
    """Each program's MSE on ``(x, y)``: inf where it is not finite or the
    program's complexity exceeds ``max_size``."""
    mse = _row_mse(ops, consts, x, y, depth)
    mse = torch.where(torch.isfinite(mse), mse, float("inf"))
    if max_size is not None:
        mse = torch.where(complexity_of(ops) > max_size, float("inf"), mse)
    return mse


def fitness_of(losses: torch.Tensor, comp: torch.Tensor,
               selection: str = "pareto",
               parsimony: float = 1e-5) -> torch.Tensor:
    """The selection key, least best.  "pareto": how many programs
    dominate a program on (loss, complexity), times P, plus its rank by
    loss then complexity (a stable sort each), in int64; "parsimony": the
    loss plus ``parsimony`` times the complexity."""
    if selection != "pareto":
        return losses + f32(parsimony) * comp.to(torch.float32)
    l_i, l_j = losses[:, None], losses[None, :]
    c_i, c_j = comp[:, None], comp[None, :]
    dom = (l_j <= l_i) & (c_j <= c_i) & ((l_j < l_i) | (c_j < c_i))
    count = dom.sum(1)
    n_p = losses.shape[0]
    by_comp = torch.argsort(comp, stable=True)
    order = by_comp[torch.argsort(losses[by_comp], stable=True)]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n_p, device=order.device)
    return count * n_p + rank


def const_grads(ops: torch.Tensor, consts: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor, depth: int) -> torch.Tensor:
    """The gradient of each program's MSE in its constants, non-finite
    entries as autograd gives them."""
    with torch.enable_grad():
        c = consts.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_row_mse(ops, c, x, y, depth).sum(), c)
    return g


def opt_consts(ops: torch.Tensor, consts: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor, depth: int, steps: int,
               lr: float) -> torch.Tensor:
    """``steps`` Adam steps at ``lr`` on each program's constants (optax's
    update), non-finite gradient entries set to 0; a program keeps its new
    constants only where its MSE fell."""
    c, state = consts, adam_init((consts,))
    for _ in range(steps):
        g = const_grads(ops, c, x, y, depth)
        g = torch.where(torch.isfinite(g), g, 0.0)
        (c,), state = adam_step((c,), (g,), state, lr)
    with torch.no_grad():
        better = _row_mse(ops, c, x, y, depth) \
            < _row_mse(ops, consts, x, y, depth)
    return torch.where(better[:, None], c, consts)


def fit_symbolic(x, y, draws: Draws, device: torch.device | str,
                 config: SymRegConfig = SymRegConfig(),
                 timings: dict | None = None) -> SymRegResult:
    """Evolve a population of equation trees to fit ``y ≈ f(x)`` on
    ``device``, every random array from ``draws``.  ``x [N, 2]`` and
    ``y [N]`` are taken as float32.  With ``timings`` the search
    synchronises with the device around its generations and its constant
    optimisations (the block's best and the hall's) and adds their seconds
    to ``timings["generations"]`` and ``timings["const_opt"]``."""
    cfg = config
    depth, pop, m = cfg.depth, cfg.population, n_nodes(cfg.depth)
    device = torch.device(device)

    @contextlib.contextmanager
    def phase(name):
        if timings is None:
            yield
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)

    def losses_of(ops, consts):
        return loss_of(ops, consts, x, y, depth, cfg.max_size)

    def optimised(ops, consts):
        return opt_consts(ops, consts, x, y, depth, cfg.const_opt_steps,
                          cfg.const_opt_lr)

    sub_mask = torch.as_tensor(_subtree_mask(depth), device=device)
    rows = torch.arange(pop, device=device)
    p_x, p_m = f32(cfg.p_crossover), f32(cfg.p_mutate)
    p_node = f32(2.0 / m)
    jitter = torch.tensor(f32(JITTER), device=device)

    def generation(ops, consts, losses, gd: GenerationDraws):
        fitness = fitness_of(losses, complexity_of(ops), cfg.selection,
                             cfg.parsimony)

        def tournament(idx):
            idx = idx.long()
            return idx[rows, torch.argmin(fitness[idx], dim=1)]

        p1, p2 = tournament(gd.t1), tournament(gd.t2)
        child_ops, child_consts = ops[p1], consts[p1]
        # crossover: the subtree at a random node from the second parent
        x_mask = sub_mask[gd.x_node.long()] & (gd.x < p_x)[:, None]
        child_ops = torch.where(x_mask, ops[p2], child_ops)
        child_consts = torch.where(x_mask, consts[p2], child_consts)
        # point mutation: random ops and jittered constants
        mut_here = (gd.mut_node < p_node) & (gd.mut_sel < p_m)[:, None]
        child_ops = torch.where(mut_here, gd.mut_op, child_ops)
        child_consts = child_consts + torch.where(mut_here,
                                                  jitter * gd.mut_c, 0.0)
        child_ops = repair(child_ops, depth)
        child_losses = losses_of(child_ops, child_consts)
        # elitism: the best ``elite`` of the previous generation
        elite_idx = torch.argsort(fitness, stable=True)[: cfg.elite]
        child_ops[: cfg.elite] = ops[elite_idx]
        child_consts[: cfg.elite] = consts[elite_idx]
        child_losses[: cfg.elite] = losses[elite_idx]
        return child_ops, child_consts, child_losses

    ops, consts = random_programs(draws, None, pop, depth, cfg.const_range,
                                  cfg.template_frac)

    # hall of fame: the best-ever (loss, ops, consts) of each complexity,
    # in insertion order
    hof: dict[int, tuple[float, np.ndarray, np.ndarray]] = {}

    def hof_update(ops_a, consts_a, losses_a):
        comp = complexity_of(ops_a).cpu().numpy()
        losses_np = losses_a.cpu().numpy()
        ops_np, consts_np = ops_a.cpu().numpy(), consts_a.cpu().numpy()
        if cfg.max_size is not None:
            losses_np = np.where(comp > cfg.max_size, np.inf, losses_np)
        for c in np.unique(comp):
            sel = np.flatnonzero(comp == c)
            i = sel[np.argmin(losses_np[sel])]
            if np.isfinite(losses_np[i]) and (
                    int(c) not in hof or losses_np[i] < hof[int(c)][0]):
                hof[int(c)] = (float(losses_np[i]), ops_np[i].copy(),
                               consts_np[i].copy())

    # the hall's fixed working size: max_size, else the largest complexity
    hof_cap = (cfg.max_size if cfg.max_size is not None
               else m + (m - 1) // 2)

    def hof_arrays():
        entries = list(hof.values())
        take = (entries + [entries[0]] * (hof_cap - len(entries)))[:hof_cap]
        return (torch.as_tensor(np.stack([v[1] for v in take]),
                                device=device),
                torch.as_tensor(np.stack([v[2] for v in take]),
                                device=device))

    n_blocks = -(-cfg.generations // cfg.block_gens)
    gens_left = cfg.generations
    losses = losses_of(ops, consts)
    for blk in range(n_blocks):
        gens = min(cfg.block_gens, gens_left)
        gens_left -= gens
        with phase("generations"):
            for g in range(gens):
                ops, consts, losses = generation(
                    ops, consts, losses,
                    draws.generation(blk, g, gens, pop, m, cfg.tournament))

        # constant optimisation of the block's best, then the hall
        with phase("const_opt"):
            top = torch.argsort(losses, stable=True)[
                : max(cfg.elite, cfg.const_opt_top)]
            consts = consts.clone()
            consts[top] = optimised(ops[top], consts[top])
        losses = losses_of(ops, consts)
        hof_update(ops, consts, losses)

        if blk < n_blocks - 1:
            order = torch.argsort(losses, stable=True)
            if hof:
                h_ops, h_consts = hof_arrays()
                with phase("const_opt"):
                    h_consts = optimised(h_ops, h_consts)
                hof_update(h_ops, h_consts, losses_of(h_ops, h_consts))
                # the hall, re-optimised, into the worst slots
                h_ops, h_consts = hof_arrays()
                ops[order[-hof_cap:]] = h_ops
                consts[order[-hof_cap:]] = h_consts
            n_fresh = int(cfg.fresh_frac * pop)
            if n_fresh:
                # fresh programs into the worst slots above the hall's
                f_ops, f_consts = random_programs(
                    draws, blk, n_fresh, depth, cfg.const_range,
                    cfg.template_frac)
                slots = order[-(n_fresh + hof_cap):-hof_cap]
                ops[slots] = f_ops
                consts[slots] = f_consts
            losses = losses_of(ops, consts)

    # the population with the hall appended, so that the front holds the
    # best-ever programs
    if hof:
        h_ops = torch.as_tensor(np.stack([v[1] for v in hof.values()]),
                                device=device)
        h_consts = torch.as_tensor(np.stack([v[2] for v in hof.values()]),
                                   device=device)
        h_losses = torch.as_tensor(np.asarray([v[0] for v in hof.values()],
                                              np.float32), device=device)
        ops = torch.cat([ops, h_ops])
        consts = torch.cat([consts, h_consts])
        losses = torch.cat([losses, h_losses])
    return SymRegResult(ops=ops, consts=consts, losses=losses,
                        complexity=complexity_of(ops))


def to_string(ops: np.ndarray, consts: np.ndarray, node: int = 0) -> str:
    """One program as an infix string, DIV as PySR's ``a * inv(b)``,
    constants ``:.4g``."""
    op = int(ops[node])
    if op == CONST:
        return f"{float(consts[node]):.4g}"
    if op == VAR0:
        return "x0"
    if op == VAR1:
        return "x1"
    left = to_string(ops, consts, 2 * node + 1) if op >= ADD else ""
    right = to_string(ops, consts, 2 * node + 2) \
        if op in _BINARY_OPS else ""
    if op == ADD:
        return f"({left} + {right})"
    if op == MUL:
        return f"({left} * {right})"
    if op == INV:
        return f"inv({left})"
    if op == DIV:
        return f"({left} * inv({right}))"
    return "?"


def pareto_front(result: SymRegResult,
                 with_programs: bool = False) -> list[dict]:
    """PySR-style Pareto table: the best loss at each complexity, kept
    where it beats every smaller complexity.  ``with_programs`` attaches
    each row's ``ops``/``consts`` (numpy) for :func:`evaluate`."""
    losses = result.losses.cpu().numpy()
    comp = result.complexity.cpu().numpy()
    ops = result.ops.cpu().numpy()
    consts = result.consts.cpu().numpy()
    rows = []
    best = np.inf
    for c in sorted(np.unique(comp)):
        sel = np.flatnonzero(comp == c)
        i = sel[np.argmin(losses[sel])]
        if np.isfinite(losses[i]) and losses[i] < best:
            best = losses[i]
            row = {"complexity": int(c), "loss": float(losses[i]),
                   "equation": to_string(ops[i], consts[i])}
            if with_programs:
                row["ops"] = ops[i]
                row["consts"] = consts[i]
            rows.append(row)
    return rows
