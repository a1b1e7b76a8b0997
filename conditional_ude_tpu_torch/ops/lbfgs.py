"""Batched L-BFGS with a weak-Wolfe line search and box constraints
(counterpart of ``conditional_ude_tpu/ops/lbfgs.py``).

The JAX optimizer is one ``lax.while_loop`` that callers ``vmap`` over
rows; under ``vmap`` the loop runs while any row's condition holds and a row
whose condition is false keeps its state.  Here the rows are a leading axis
and that is written out: every row carries its own iteration count, line
search counters and curvature history, each loop updates only the rows
still active in it, and each loop ends as soon as no row is active.  Row
``i``'s objective and gradient must depend on row ``i`` alone.

The curvature history is kept newest first (the JAX package keeps a ring
buffer and a head index; the two-loop recursion reads the same pairs in the
same order).  A row's state is then exactly what decides its next
iteration, which allows one shortcut that leaves every result as it is: an
iteration is a deterministic function of the state, so a row whose state
repeats one it had ``p`` iterations before (``p ≤ CYCLE``) is in an orbit
of period ``p`` and its state after ``max_iters`` is known at once.  Such a
row stops there.  In float32 the β/σ fits reach fixed points (``p = 1``) or
short orbits within a few dozen iterations and never pass ``gtol``; the JAX
loop repeats them up to ``max_iters``.  ``num_iters`` counts the iterations
run before the orbit was recognised.

Box constraints use gradient projection.  Objectives may return ``inf`` or
``nan``: such trial points fail the Armijo test, and a row that cannot
make progress stops.  Non-finite gradient entries are zeroed after their
finiteness is recorded, so they can neither pass the convergence test nor
enter the curvature history.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

CYCLE = 8   # longest orbit recognised


class LBFGSResult(NamedTuple):
    x: torch.Tensor           # [R, p]
    fval: torch.Tensor        # [R]
    converged: torch.Tensor   # [R] bool
    num_iters: torch.Tensor   # [R] int64


class _State(NamedTuple):
    x: torch.Tensor       # [R, p]
    f: torch.Tensor       # [R]
    g: torch.Tensor       # [R, p], non-finite entries zeroed
    gfin: torch.Tensor    # [R] the gradient was finite before zeroing
    S: torch.Tensor       # [R, m, p] s-history, newest first
    Y: torch.Tensor       # [R, m, p] y-history
    rho: torch.Tensor     # [R, m]
    valid: torch.Tensor   # [R, m] slot holds a usable pair


def _project(x, lower, upper):
    if lower is not None:
        x = torch.maximum(x, lower)
    if upper is not None:
        x = torch.minimum(x, upper)
    return x


def _dot(a, b):
    return (a * b).sum(-1)


def _value_and_grad(fun, x):
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        f = fun(x)
        (g,) = torch.autograd.grad(f.sum(), x)
    return f.detach(), g


def _finite_grad(g):
    """(gradient with non-finite entries zeroed, row was fully finite)."""
    fin = torch.isfinite(g)
    return torch.where(fin, g, 0.0), fin.all(-1)


_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _same(a: _State, b: _State) -> torch.Tensor:
    """Rows whose two states are equal bit for bit."""
    eq = None
    for u, v in zip(a, b):
        if u.dtype.is_floating_point:
            u, v = u.view(_BITS[u.element_size()]), v.view(_BITS[v.element_size()])
        e = (u == v).reshape(u.shape[0], -1).all(-1)
        eq = e if eq is None else eq & e
    return eq


def _where(mask, a: _State, b: _State) -> _State:
    return _State(*(torch.where(mask.reshape(-1, *[1] * (u.ndim - 1)), u, v)
                    for u, v in zip(a, b)))


def _two_loop(s: _State):
    """H·g by the two-loop recursion over the valid history pairs."""
    m = s.S.shape[1]
    q = s.g
    alphas = []
    for j in range(m):
        a = torch.where(s.valid[:, j], s.rho[:, j] * _dot(s.S[:, j], q), 0.0)
        q = q - a[:, None] * s.Y[:, j]
        alphas.append(a)

    # H0 scaling from the most recent pair
    yy = _dot(s.Y[:, 0], s.Y[:, 0])
    sy = torch.where(s.rho[:, 0] == 0, 1.0, 1.0 / s.rho[:, 0])
    gamma = torch.where(s.valid[:, 0] & (yy > 0),
                        sy / torch.clamp_min(yy, 1e-30), 1.0)
    r = gamma[:, None] * q
    for j in reversed(range(m)):
        b = torch.where(s.valid[:, j], s.rho[:, j] * _dot(s.Y[:, j], r), 0.0)
        r = r + (alphas[j] - b)[:, None] * s.S[:, j]
    return r


def _orbit_end(s: _State, past: list[_State], active, it, max_iters):
    """Rows whose state repeats one of ``past`` (newest last), and the
    state each such row would have after ``max_iters`` iterations."""
    found = torch.zeros_like(active)
    end = s
    for p in range(1, len(past) + 1):
        hit = active & ~found & _same(s, past[-p])
        if not bool(hit.any()):
            continue
        # state n+k equals state n-p+k: after max_iters it is n-p+j
        j = (max_iters - it) % p
        for jj in range(1, p):
            end = _where(hit & (j == jj), past[-(p - jj)], end)
        found = found | hit
    return found, end


def lbfgs_minimize(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    lower: torch.Tensor | None = None,
    upper: torch.Tensor | None = None,
    max_iters: int = 1000,
    history: int = 10,
    gtol: float = 1e-6,
    ftol: float = 0.0,
    max_backtracks: int = 30,
    wolfe_patience: int = 6,
) -> LBFGSResult:
    """Minimize ``fun`` row by row from ``x0[R, p]``.

    ``fun(x[R, p]) -> f[R]``; gradients come from torch autograd.  ``lower``
    and ``upper`` broadcast against ``x0``.  The line search bisects for the
    weak-Wolfe conditions; once an Armijo point exists it spends at most
    ``wolfe_patience`` further evaluations (and never more than
    ``2·wolfe_patience`` in all) on the curvature condition before taking
    the best Armijo point.
    """
    if x0.ndim != 2:
        raise ValueError(f"x0 must be [rows, p], got shape {tuple(x0.shape)}")
    dev, dtype = x0.device, x0.dtype
    n_rows, p = x0.shape
    m = history

    x = _project(x0, lower, upper)
    f, g = _value_and_grad(fun, x)
    g, gfin = _finite_grad(g)
    bad_start = ~torch.isfinite(f)
    s = _State(x=x, f=f, g=g, gfin=gfin,
               S=torch.zeros((n_rows, m, p), dtype=dtype, device=dev),
               Y=torch.zeros((n_rows, m, p), dtype=dtype, device=dev),
               rho=torch.zeros((n_rows, m), dtype=dtype, device=dev),
               valid=torch.zeros((n_rows, m), dtype=torch.bool, device=dev))
    it = torch.zeros(n_rows, dtype=torch.long, device=dev)
    done = bad_start.clone()
    past: list[_State] = []

    while True:
        active = ~done & (it < max_iters)
        orbit, end = _orbit_end(s, past, active, it, max_iters)
        s = end
        done = done | orbit
        active = active & ~orbit
        if not bool(active.any()):
            break
        past = (past + [s])[-CYCLE:]

        d = -_two_loop(s)
        # not a descent direction: fall back to steepest descent
        gd = _dot(s.g, d)
        descent = gd < 0
        d = torch.where(descent[:, None], d, -s.g)
        gd = torch.where(descent, gd, -_dot(s.g, s.g))
        # no curvature history yet: unit sup-norm steepest-descent step
        have_hist = s.valid.any(-1)
        scale0 = 1.0 / torch.clamp_min(d.abs().amax(-1), 1.0)
        d = torch.where(have_hist[:, None], d, d * scale0[:, None])
        gd = torch.where(have_hist, gd, gd * scale0)

        # line search state, per row
        lo = torch.zeros(n_rows, dtype=dtype, device=dev)
        hi = torch.full((n_rows,), torch.inf, dtype=dtype, device=dev)
        alpha = torch.ones(n_rows, dtype=dtype, device=dev)
        lx, lf, lg, lgfin = s.x, s.f, s.g, s.gfin
        bx, bf, bg, bgfin = s.x, s.f, s.g, s.gfin
        b_ok = torch.zeros(n_rows, dtype=torch.bool, device=dev)
        ok = torch.zeros_like(b_ok)
        k = torch.zeros(n_rows, dtype=torch.long, device=dev)
        k_armijo = torch.zeros_like(k)

        while True:
            give_up_wolfe = b_ok & ((k - k_armijo > wolfe_patience)
                                    | (k >= 2 * wolfe_patience))
            ls = active & ~ok & (k < max_backtracks) & ~give_up_wolfe
            if not bool(ls.any()):
                break

            xt = _project(s.x + alpha[:, None] * d, lower, upper)
            ft, gt = _value_and_grad(fun, xt)
            gt, gt_fin = _finite_grad(gt)
            # Armijo on the actual (projected) displacement
            decrease = torch.clamp_max(_dot(s.g, xt - s.x), -1e-30)
            armijo = torch.isfinite(ft) & (ft <= s.f + 1e-4 * decrease)
            curv = _dot(gt, d) >= 0.9 * gd
            ok_t = armijo & curv
            hi_t = torch.where(armijo, hi, alpha)
            lo_t = torch.where(armijo & ~curv, alpha, lo)
            alpha_t = torch.where(
                ok_t, alpha,
                torch.where(~armijo, 0.5 * (lo_t + torch.minimum(hi_t, alpha)),
                            torch.where(torch.isinf(hi_t), 2.0 * alpha,
                                        0.5 * (lo_t + hi_t))))
            better = ls & armijo & (ft < bf)
            k_armijo = torch.where(ls & ~b_ok & armijo, k, k_armijo)

            ls2 = ls[:, None]
            lo = torch.where(ls, lo_t, lo)
            hi = torch.where(ls, hi_t, hi)
            alpha = torch.where(ls, alpha_t, alpha)
            lx = torch.where(ls2, xt, lx)
            lf = torch.where(ls, ft, lf)
            lg = torch.where(ls2, gt, lg)
            lgfin = torch.where(ls, gt_fin, lgfin)
            bx = torch.where(better[:, None], xt, bx)
            bf = torch.where(better, ft, bf)
            bg = torch.where(better[:, None], gt, bg)
            bgfin = torch.where(better, gt_fin, bgfin)
            b_ok = b_ok | (ls & armijo)
            ok = torch.where(ls, ok_t, ok)
            k = k + ls.long()

        ls_ok = ok | b_ok
        x_new = torch.where(ok[:, None], lx,
                            torch.where(b_ok[:, None], bx, s.x))
        f_new = torch.where(ok, lf, torch.where(b_ok, bf, s.f))
        g_new = torch.where(ok[:, None], lg,
                            torch.where(b_ok[:, None], bg, s.g))
        gfin_new = torch.where(ok, lgfin, torch.where(b_ok, bgfin, s.gfin))

        # curvature pair, only from finite gradients at both endpoints
        sk = x_new - s.x
        yk = g_new - s.g
        sy = _dot(sk, yk)
        store = ls_ok & gfin_new & s.gfin & (
            sy > 1e-10 * torch.clamp_min(_dot(sk, sk) * _dot(yk, yk),
                                         1e-30) ** 0.5)
        pushed = _State(
            x=x_new, f=f_new, g=g_new, gfin=gfin_new,
            S=torch.cat([sk[:, None], s.S[:, :-1]], 1),
            Y=torch.cat([yk[:, None], s.Y[:, :-1]], 1),
            rho=torch.cat([(1.0 / torch.where(sy == 0, 1.0, sy))[:, None],
                           s.rho[:, :-1]], 1),
            valid=torch.cat([torch.ones_like(store)[:, None],
                             s.valid[:, :-1]], 1))
        kept = s._replace(x=x_new, f=f_new, g=g_new, gfin=gfin_new)
        new = _where(store, pushed, kept)

        # convergence: projected-gradient sup-norm, f stagnation, stuck
        pg = x_new - _project(x_new - g_new, lower, upper)
        small_g = (pg.abs().amax(-1) < gtol) & gfin_new
        stalled = ls_ok & ((s.f - f_new).abs()
                           <= ftol * torch.clamp_min(s.f.abs(), 1.0))
        done_new = small_g | ~ls_ok | ((ftol > 0) & stalled)

        s = _where(active, new, s)
        done = torch.where(active, done_new, done)
        it = it + active.long()

    pg = s.x - _project(s.x - s.g, lower, upper)
    converged = (pg.abs().amax(-1) < gtol) & s.gfin & ~bad_start
    return LBFGSResult(x=s.x, fval=s.f, converged=converged, num_iters=it)
