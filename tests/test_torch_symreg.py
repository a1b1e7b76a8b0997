"""PyTorch port: the symbolic-regression search (``analysis/symreg.py``)
held against the JAX package's on the CPU.

Programs are injected into both packages (JAX's own fixtures, random op
arrays, programs whose children are 0 or infinite at some samples), and
``evaluate``, ``complexity_of``, ``_structure_ok``, ``repair``,
``to_string`` and ``pareto_front`` must be equal.  The search's randomness
is replayed: :class:`JaxDraws` draws JAX's own arrays from JAX's keys,
addressed as ``conditional_ude_tpu/analysis/symreg.py`` addresses them, and
feeds them to the port's ``draws`` seam, so ``random_programs`` is equal
and a whole ``fit_symbolic`` is held step by step.  Tolerances: the
constant optimisation within rtol 1e-5 after 10 steps (the loss's sums over
the samples run in another order in the two packages), a whole search's
constants and losses within rtol 1e-4 with its ops and front's equations
equal.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conditional_ude_tpu.analysis import symreg as jsr
from conditional_ude_tpu_torch.analysis import symreg as tsr

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the search is thousands of small operations,
    which many threads beside other test processes slow down ~30-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


TINY = np.finfo(np.float32).tiny


def assert_equal_but_subnormals(got, want):
    """Equal, NaN where NaN, except that a float32 subnormal of the port's
    may be JAX's 0 of the same sign: XLA on the CPU flushes subnormal
    results to zero, PyTorch keeps them (``1 / 3e38``)."""
    sub = (got != 0) & (np.abs(got) < TINY)
    np.testing.assert_array_equal(want[sub], 0.0 * got[sub])
    np.testing.assert_array_equal(np.signbit(want[sub]), np.signbit(got[sub]))
    np.testing.assert_array_equal(np.where(sub, 0.0, got),
                                  np.where(sub, 0.0, want))


# the JAX package's functions, compiled once a shape (eager, each of their
# operations compiles alone)
J_EVALUATE = jax.jit(jsr.evaluate, static_argnums=3)
J_REPAIR = jax.jit(jsr.repair, static_argnums=1)
J_STRUCTURE_OK = jax.jit(jsr._structure_ok, static_argnums=1)
J_RANDOM_PROGRAMS = jax.jit(jsr._random_programs, static_argnums=(1, 2, 3, 4))
_OPS7 = (jsr.ADD, jsr.MUL, jsr.INV, jsr.DIV, jsr.CONST, jsr.VAR0, jsr.VAR1)


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _program_draws(key, n, m, lo, hi):
    """``_random_programs``' draws from its key, in its order."""
    k_op, k_leaf, k_const, k_kill, k_tmpl = jax.random.split(key, 5)
    interior = jax.random.choice(
        k_op, jnp.array(_OPS7), (n, m),
        p=jnp.array([0.22, 0.22, 0.06, 0.1, 0.1, 0.15, 0.15]))
    leaves = jax.random.choice(
        k_leaf, jnp.array([jsr.CONST, jsr.VAR0, jsr.VAR1]), (n, m),
        p=jnp.array([0.34, 0.33, 0.33]))
    k_kill, k_q = jax.random.split(k_kill)
    return (interior, leaves,
            jax.random.uniform(k_q, (n, 1), minval=0.15, maxval=0.8),
            jax.random.uniform(k_kill, (n, m)),
            jax.random.uniform(k_tmpl, (n,)),
            jax.random.uniform(k_const, (n, m), jnp.float32, lo, hi))


@partial(jax.jit, static_argnums=(1, 2, 3))
def _generation_draws(k, pop, m, tournament):
    """``fit_symbolic``'s ``generation`` draws from its key, in its
    order."""
    k_t1, k_t2, k_mut_sel, k_mut_node, k_mut_op, k_mut_c, k_x, k_xnode \
        = jax.random.split(k, 8)
    return (jax.random.randint(k_t1, (pop, tournament), 0, pop),
            jax.random.randint(k_t2, (pop, tournament), 0, pop),
            jax.random.uniform(k_mut_sel, (pop,)),
            jax.random.uniform(k_mut_node, (pop, m)),
            jax.random.choice(
                k_mut_op, jnp.array(_OPS7), (pop, m),
                p=jnp.array([0.2, 0.2, 0.07, 0.09, 0.14, 0.15, 0.15])),
            jax.random.normal(k_mut_c, (pop, m)),
            jax.random.uniform(k_x, (pop,)),
            jax.random.randint(k_xnode, (pop,), 0, m))


class JaxDraws:
    """The port's ``draws`` seam fed with JAX's own arrays: the keys of
    ``fit_symbolic(x, y, key, ...)`` split and folded as the JAX package
    does, each array drawn as its ``_random_programs`` and ``generation``
    draw it."""

    def __init__(self, key):
        self.k_init, self.k_gens, self.k_final = jax.random.split(key, 3)

    def programs(self, blk, n, m, const_range):
        key = (self.k_init if blk is None
               else jax.random.fold_in(self.k_final, blk))
        return tsr.ProgramDraws(*(torch.as_tensor(np.array(a)) for a in
                                  _program_draws(key, n, m, *const_range)))

    def generation(self, blk, g, gens, pop, m, tournament):
        k = jax.random.split(jax.random.fold_in(self.k_gens, blk), gens)[g]
        return tsr.GenerationDraws(*(
            torch.as_tensor(np.array(a))
            for a in _generation_draws(k, pop, m, tournament)))


def _program(depth, assignments):
    m = jsr.n_nodes(depth)
    ops = np.full((m,), jsr.PASS, np.int32)
    consts = np.zeros((m,), np.float32)
    for idx, (op, c) in assignments.items():
        ops[idx] = op
        consts[idx] = c
    return ops[None], consts[None]


def _fixtures():
    """(name, depth, ops, consts, x): JAX's own test programs, 256 random
    op arrays at each depth 2-5 (raw and repaired), and programs whose
    children are 0 or infinite at some samples."""
    out = []
    x2 = np.array([[1.0, 4.0], [3.0, 2.0], [2.0, 8.0]], np.float32)
    out.append(("known tree", 2, *_program(2, {
        0: (jsr.MUL, 0), 1: (jsr.ADD, 0), 2: (jsr.INV, 0),
        3: (jsr.VAR0, 0), 4: (jsr.CONST, 2.0), 5: (jsr.VAR1, 0)}), x2))
    out.append(("div tree", 2, *_program(2, {
        0: (jsr.DIV, 0), 1: (jsr.VAR1, 0), 2: (jsr.ADD, 0),
        5: (jsr.VAR0, 0), 6: (jsr.CONST, 2.0)}), x2))
    rng = np.random.default_rng(0)
    for depth in (2, 3, 4, 5):
        m = jsr.n_nodes(depth)
        ops = rng.integers(0, 8, (256, m)).astype(np.int32)
        consts = rng.uniform(-5, 5, (256, m)).astype(np.float32)
        x = rng.uniform(0.0, 3.0, (24, 2)).astype(np.float32)
        x[:4, 1] = 0.0                     # ΔG = 0 rows, as in the data
        x[4:6, 0] = 0.0
        out.append((f"random depth {depth}", depth, ops, consts, x))
        out.append((f"repaired depth {depth}", depth,
                    np.asarray(J_REPAIR(jnp.asarray(ops), depth)), consts,
                    x))
    # children 0 (x1 * 0, x1 at ΔG = 0) and infinite (inv(x1) at ΔG = 0)
    # under every op
    big = np.float32(3e38)
    x = np.array([[0.5, 0.0], [1.5, 2.0], [0.0, 0.0], [2.0, 1e-3]],
                 np.float32)
    for op in (jsr.ADD, jsr.MUL, jsr.DIV, jsr.INV):
        for left, right in (((jsr.MUL, 0), (jsr.INV, 0)),
                            ((jsr.VAR1, 0), (jsr.CONST, 0.0)),
                            ((jsr.INV, 0), (jsr.VAR0, 0)),
                            ((jsr.CONST, big), (jsr.MUL, 0))):
            a = {0: (op, 0), 1: left, 2: right if op != jsr.INV else
                 (jsr.PASS, 0)}
            for child, (cop, _) in ((1, left), (2, right)):
                if op == jsr.INV and child == 2:
                    continue
                if cop == jsr.MUL:
                    a[2 * child + 1] = (jsr.VAR1, 0)
                    a[2 * child + 2] = (jsr.CONST, 1.5)
                elif cop == jsr.INV:
                    a[2 * child + 1] = (jsr.VAR1, 0)
            out.append((f"op {op} over {left[0]}, {right[0]}", 2,
                        *_program(2, a), x))
    return out


FIXTURES = _fixtures()


@pytest.mark.parametrize("name,depth,ops,consts,x", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_programs_equal_jax(name, depth, ops, consts, x):
    """``evaluate`` (NaN and inf where JAX has them; a subnormal value may
    be JAX's flushed 0), ``complexity_of``, ``_structure_ok`` and
    ``repair`` equal JAX's exactly."""
    want = np.asarray(J_EVALUATE(jnp.asarray(ops), jnp.asarray(consts),
                                   jnp.asarray(x), depth))
    got = tsr.evaluate(torch.as_tensor(ops), torch.as_tensor(consts),
                       torch.as_tensor(x), depth).numpy()
    assert_equal_but_subnormals(got, want)
    t_ops = torch.as_tensor(ops)
    np.testing.assert_array_equal(tsr.complexity_of(t_ops).numpy(),
                                  np.asarray(jsr.complexity_of(ops)))
    np.testing.assert_array_equal(tsr._structure_ok(t_ops, depth).numpy(),
                                  np.asarray(J_STRUCTURE_OK(
                                      jnp.asarray(ops), depth)))
    np.testing.assert_array_equal(tsr.repair(t_ops, depth).numpy(),
                                  np.asarray(J_REPAIR(jnp.asarray(ops),
                                                        depth)))
    np.testing.assert_array_equal(tsr._subtree_mask(depth),
                                  jsr._subtree_mask(depth))


def test_known_programs_render_and_count():
    """JAX's own known-tree and DIV fixtures: values, complexity and
    strings in the port."""
    (_, _, ops, consts, x), (_, _, d_ops, d_consts, _) = FIXTURES[:2]
    out = tsr.evaluate(torch.as_tensor(ops), torch.as_tensor(consts),
                       torch.as_tensor(x[:2]), 2)
    np.testing.assert_allclose(out[0].numpy(), [(1 + 2) / 4, (3 + 2) / 2],
                               rtol=1e-6)
    assert int(tsr.complexity_of(torch.as_tensor(ops))[0]) == 6
    assert tsr.to_string(ops[0], consts[0]) == "((x0 + 2) * inv(x1))"
    assert int(tsr.complexity_of(torch.as_tensor(d_ops))[0]) == 6
    assert tsr.to_string(d_ops[0], d_consts[0]) == "(x1 * inv((x0 + 2)))"


def test_to_string_and_pareto_front_equal_jax():
    """Strings of every repaired random program, and the Pareto rows
    (``with_programs`` too) of a population with ties, inf losses and
    repeated complexities, equal JAX's."""
    rng = np.random.default_rng(3)
    depth, n = 3, 400
    ops = np.asarray(J_REPAIR(jnp.asarray(
        rng.integers(1, 8, (n, jsr.n_nodes(depth))).astype(np.int32)),
        depth))
    consts = rng.normal(0, 20, ops.shape).astype(np.float32)
    for i in range(n):
        assert tsr.to_string(ops[i], consts[i]) == jsr.to_string(ops[i],
                                                                 consts[i])
    comp = np.asarray(jsr.complexity_of(ops))
    losses = (np.exp(-0.3 * comp) * rng.uniform(0.5, 1.5, n)).astype(
        np.float32)
    losses[::7] = np.inf
    losses[1::11] = losses[3]                       # ties
    jres = jsr.SymRegResult(jnp.asarray(ops), jnp.asarray(consts),
                            jnp.asarray(losses), jnp.asarray(comp))
    tres = tsr.SymRegResult(torch.as_tensor(ops), torch.as_tensor(consts),
                            torch.as_tensor(losses),
                            tsr.complexity_of(torch.as_tensor(ops)))
    assert tsr.pareto_front(tres) == jsr.pareto_front(jres)
    got = tsr.pareto_front(tres, with_programs=True)
    want = jsr.pareto_front(jres, with_programs=True)
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        for k in ("ops", "consts"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))


@pytest.mark.parametrize("depth,frac", [(2, 0.2), (4, 0.5), (5, 0.0),
                                        (1, 0.2)])
def test_random_programs_from_jax_draws(depth, frac):
    """``random_programs`` on JAX's replayed draws: ops and constants equal
    ``_random_programs`` of the same key."""
    key = jax.random.key(11)
    j_ops, j_consts = J_RANDOM_PROGRAMS(key, 300, depth, (-5.0, 5.0),
                                           template_frac=frac)
    draws = JaxDraws(jax.random.key(0))
    draws.k_init = key
    t_ops, t_consts = tsr.random_programs(draws, None, 300, depth,
                                          (-5.0, 5.0), template_frac=frac)
    np.testing.assert_array_equal(t_ops.numpy(), np.asarray(j_ops))
    np.testing.assert_array_equal(t_consts.numpy(), np.asarray(j_consts))
    assert t_ops.dtype == torch.int32


def _jax_opt_consts(ops, consts, x, y, depth, steps, lr):
    """``fit_symbolic``'s inner ``opt_consts`` of the JAX package
    (``conditional_ude_tpu/analysis/symreg.py:328-350``), line for line."""
    opt = optax.adam(lr)

    def one(op_row, c_row):
        state = opt.init(c_row)

        def step(carry, _):
            c, s = carry
            g = jax.grad(lambda cc: jnp.mean(
                (jsr.evaluate(op_row, cc, x, depth) - y) ** 2))(c)
            g = jnp.where(jnp.isfinite(g), g, 0.0)
            upd, s = opt.update(g, s, c)
            return (optax.apply_updates(c, upd), s), None

        (c_fin, _), _ = jax.lax.scan(step, (c_row, state), None,
                                     length=steps)
        better = (jnp.mean((jsr.evaluate(op_row, c_fin, x, depth) - y) ** 2)
                  < jnp.mean((jsr.evaluate(op_row, c_row, x, depth) - y)
                             ** 2))
        return jnp.where(better, c_fin, c_row)

    return jax.vmap(one)(ops, consts)


def _opt_problem():
    """Repaired random programs of depth 3 on data with ΔG = 0 rows (the
    committed samples' first glucose level), and programs built to have
    zero children: ``inv(c·x1)`` and ``c / (x1·c)`` under ADD."""
    rng = np.random.default_rng(5)
    depth, m = 3, jsr.n_nodes(3)
    ops = np.asarray(J_REPAIR(jnp.asarray(
        rng.integers(1, 8, (96, m)).astype(np.int32)), depth))
    ops = np.concatenate([ops, np.asarray(J_RANDOM_PROGRAMS(
        jax.random.key(4), 64, depth, (-5.0, 5.0), 0.5)[0])])
    special = []
    for a in ({0: (jsr.ADD, 0), 1: (jsr.INV, 0), 2: (jsr.CONST, 0),
               3: (jsr.MUL, 0), 7: (jsr.VAR1, 0), 8: (jsr.CONST, 0)},
              {0: (jsr.ADD, 0), 1: (jsr.DIV, 0), 2: (jsr.VAR0, 0),
               3: (jsr.CONST, 0), 4: (jsr.MUL, 0), 9: (jsr.VAR1, 0),
               10: (jsr.CONST, 0)},
              {0: (jsr.MUL, 0), 1: (jsr.ADD, 0), 2: (jsr.MUL, 0),
               3: (jsr.VAR1, 0), 4: (jsr.CONST, 0), 5: (jsr.VAR1, 0),
               6: (jsr.CONST, 0)}):
        special.append(_program(depth, a)[0][0])
    ops = np.concatenate([ops, np.stack(special)]).astype(np.int32)
    consts = rng.uniform(-5, 5, ops.shape).astype(np.float32)
    x = np.stack([rng.uniform(0.05, 1.0, 40),
                  np.repeat(np.linspace(0.0, 28.0, 8), 5)], 1
                 ).astype(np.float32)
    y = (1.78 * x[:, 1] / (21.8 + 166.7 * x[:, 0] ** 3 + x[:, 1])
         ).astype(np.float32)
    return depth, ops, consts, x, y


def test_const_grads_zero_the_entries_jax_zeroes():
    """The gradient of every program's MSE in its constants: non-finite at
    exactly the entries where JAX's is (NaN from the zero cotangents of
    unselected candidates over zero children), the finite ones within
    rtol 1e-5; the built programs do have such entries."""
    depth, ops, consts, x, y = _opt_problem()
    want = np.asarray(jax.jit(jax.vmap(jax.grad(
        lambda o, c: jnp.mean((jsr.evaluate(o, c, jnp.asarray(x), depth)
                               - jnp.asarray(y)) ** 2), argnums=1)))(
        jnp.asarray(ops), jnp.asarray(consts)))
    got = tsr.const_grads(torch.as_tensor(ops), torch.as_tensor(consts),
                          torch.as_tensor(x), torch.as_tensor(y),
                          depth).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert not fin[-3:].all() and not fin.all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)


def test_opt_consts_matches_jax():
    """Ten Adam steps on every program's constants: within rtol 1e-5 of
    JAX's ``opt_consts`` (atol 1e-6 for constants near 0), the programs
    whose constants improved the same."""
    depth, ops, consts, x, y = _opt_problem()
    want = np.asarray(_jax_opt_consts(jnp.asarray(ops), jnp.asarray(consts),
                                      jnp.asarray(x), jnp.asarray(y), depth,
                                      10, 0.1))
    got = tsr.opt_consts(torch.as_tensor(ops), torch.as_tensor(consts),
                         torch.as_tensor(x), torch.as_tensor(y), depth, 10,
                         0.1).numpy()
    np.testing.assert_array_equal((got != consts).any(1),
                                  (want != consts).any(1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _det_data():
    """The data of JAX's ``test_fit_symbolic_is_deterministic``."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0.2, 2.0, (48, 2)).astype(np.float32)
    y = (x[:, 1] / (x[:, 0] + x[:, 1] + 1.0)).astype(np.float32)
    return x, y


SMALL = dict(depth=3, population=128, generations=10, block_gens=5,
             const_opt_steps=5, max_size=12)


def test_fit_symbolic_on_jax_draws_matches_jax():
    """A whole search with two blocks (so the hall's re-optimisation and
    re-injection and the fresh programs run) on JAX's replayed draws: the
    final population's ops equal JAX's, its constants and losses within
    rtol 1e-4, and the Pareto rows' complexities and equations equal."""
    x, y = _det_data()
    key = jax.random.key(3)
    want = jsr.fit_symbolic(jnp.asarray(x), jnp.asarray(y), key,
                            jsr.SymRegConfig(**SMALL))
    got = tsr.fit_symbolic(x, y, JaxDraws(key), CPU,
                           tsr.SymRegConfig(**SMALL))
    np.testing.assert_array_equal(got.ops.numpy(), np.asarray(want.ops))
    np.testing.assert_allclose(got.consts.numpy(), np.asarray(want.consts),
                               rtol=1e-4)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=1e-4)
    np.testing.assert_array_equal(got.complexity.numpy(),
                                  np.asarray(want.complexity))
    g_front, w_front = tsr.pareto_front(got), jsr.pareto_front(want)
    assert [(r["complexity"], r["equation"]) for r in g_front] \
        == [(r["complexity"], r["equation"]) for r in w_front]
    np.testing.assert_allclose([r["loss"] for r in g_front],
                               [r["loss"] for r in w_front], rtol=1e-4)


def test_fitness_of_matches_jax():
    """The Pareto key (domination count × P + the stable lexsort rank) on
    losses with ties and infs, and the parsimony key, equal JAX's."""
    rng = np.random.default_rng(9)
    n = 300
    losses = rng.choice(rng.uniform(0, 1, 40).astype(np.float32), n)
    losses[::13] = np.inf
    comp = rng.integers(1, 19, n).astype(np.int32)
    t_l, t_c = torch.as_tensor(losses), torch.as_tensor(comp)
    # JAX's fitness_of is internal to fit_symbolic: its expression
    l_i, l_j = losses[:, None], losses[None, :]
    c_i, c_j = comp[:, None], comp[None, :]
    dom = (l_j <= l_i) & (c_j <= c_i) & ((l_j < l_i) | (c_j < c_i))
    order = np.asarray(jnp.lexsort((jnp.asarray(comp), jnp.asarray(losses))))
    rank = np.zeros(n, np.int64)
    rank[order] = np.arange(n)
    want = dom.sum(1) * n + rank
    np.testing.assert_array_equal(tsr.fitness_of(t_l, t_c).numpy(), want)
    pars = np.asarray(jnp.asarray(losses) + 1e-5
                      * jnp.asarray(comp).astype(jnp.float32))
    np.testing.assert_array_equal(
        tsr.fitness_of(t_l, t_c, "parsimony").numpy(), pars)


def test_config_rejects_unknown_selection():
    with pytest.raises(ValueError):
        tsr.SymRegConfig(selection="nsga")
    assert tsr.SymRegConfig() == tsr.SymRegConfig(**{
        f.name: getattr(jsr.SymRegConfig(), f.name)
        for f in jsr.SymRegConfig.__dataclass_fields__.values()})


def test_fit_symbolic_is_deterministic():
    """The port's own generator: the same seed gives the same result and
    front (timed by phase or not), another seed another population."""
    x, y = _det_data()
    cfg = tsr.SymRegConfig(**SMALL)
    r1 = tsr.fit_symbolic(x, y, tsr.TorchDraws(3, CPU), CPU, cfg)
    timings = {}
    r2 = tsr.fit_symbolic(x, y, tsr.TorchDraws(3, CPU), CPU, cfg,
                          timings=timings)
    assert set(timings) == {"generations", "const_opt"}
    r3 = tsr.fit_symbolic(x, y, tsr.TorchDraws(4, CPU), CPU, cfg)
    assert torch.equal(r1.ops, r2.ops) and torch.equal(r1.losses, r2.losses)
    assert tsr.pareto_front(r1) == tsr.pareto_front(r2)
    assert not torch.equal(r1.ops, r3.ops)


def test_recovers_product():
    """JAX's ``test_recovers_product`` on the port's own generator."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0.5, 3.0, (64, 2)).astype(np.float32)
    y = x[:, 0] * x[:, 1]
    cfg = tsr.SymRegConfig(depth=2, population=256, generations=25,
                           const_opt_steps=10, elite=16)
    res = tsr.fit_symbolic(x, y, tsr.TorchDraws(0, CPU), CPU, cfg)
    assert float(res.losses.min()) < 1e-3
    front = tsr.pareto_front(res)
    assert front and front[-1]["loss"] < 1e-3
