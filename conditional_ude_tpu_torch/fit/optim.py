"""Adam over a leading restart axis (counterpart of
``conditional_ude_tpu/fit/optim.py``).

The JAX package runs ``optax.adam`` under ``vmap`` over restarts; Adam is
elementwise, so the batched form here is the same update on every row.  It
follows ``optax.adam`` operation by operation: first and second moments
``(1 − b)·g^k + b·m``, bias corrections ``1 − b^count`` in float32 from an
integer step count, ``m̂ / (sqrt(v̂) + eps)`` scaled by ``−lr``.  Non-finite
gradient entries (diverged solves) are zeroed before the update by
:func:`adam_minimize`.  :func:`adam_step` is one update on explicit state
at a step size of the caller's, for loops that do more than step: ADVI
records its ELBO after each update and reads its step size from
:func:`cosine_decay` (``optax.cosine_decay_schedule``).
"""

from __future__ import annotations

import sys
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from conditional_ude_tpu_torch.ops.tsit5 import f32

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    count: int                      # steps taken
    mu: tuple[torch.Tensor, ...]    # first moments, like x
    nu: tuple[torch.Tensor, ...]    # second moments


class AdamResult(NamedTuple):
    x: tuple[torch.Tensor, ...]
    fval: torch.Tensor | None       # [R] fun at the final x (None: no fun)
    loss_trace: torch.Tensor        # [R, iters] fun before each step
    opt_state: AdamState


def adam_init(x: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(0, tuple(torch.zeros_like(a) for a in x),
                     tuple(torch.zeros_like(a) for a in x))


def cosine_decay(lr: float, steps: int,
                 alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(lr, steps, alpha)``: the step size at
    step count c (read before the update increments it),
    ``lr·((1 − α)·½·(1 + cos(π·min(c, T)/T)) + α)``, computed in float64
    and rounded once to float32.  XLA rewrites the expression (π/T folded
    into one float32 constant, (1 − α)·½ into another) and its float32
    cosine is not correctly rounded, so JAX's values on the CPU are within
    four float32 roundings of lr of these, not equal to them."""
    if steps <= 0:
        raise ValueError(f"the schedule needs positive steps, got {steps}")

    def schedule(count: int) -> float:
        c = min(count, steps)
        decayed = (1.0 - alpha) * 0.5 * (1.0 + np.cos(np.pi * c / steps)) \
            + alpha
        return f32(lr * decayed)
    return schedule


def adam_step(x: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              state: AdamState, lr: float) -> tuple[tuple[torch.Tensor, ...],
                                                    AdamState]:
    """One ``optax.adam`` update of ``x`` by ``grads`` at step size ``lr``
    (a schedule's value at ``state.count``): the new ``x`` and state.  The
    gradients are taken as they are, non-finite entries included."""
    c1, c2 = f32(1.0 - B1), f32(1.0 - B2)
    b1, b2, eps, neg_lr = f32(B1), f32(B2), f32(EPS), f32(-lr)
    count, mu, nu = state
    mu = tuple(c1 * g + b1 * m for g, m in zip(grads, mu))
    nu = tuple(c2 * (g * g) + b2 * v for g, v in zip(grads, nu))
    count += 1
    # as 0-d tensors: PyTorch on the card multiplies by the reciprocal
    # of a Python-number divisor, optax divides
    bc1, bc2 = (torch.tensor(np.float32(1.0) - np.float32(b)
                             ** np.float32(count), device=x[0].device)
                for b in (B1, B2))
    x = tuple(a + ((m / bc1) / (torch.sqrt(v / bc2 + 0.0) + eps)) * neg_lr
              for a, m, v in zip(x, mu, nu))
    return x, AdamState(count, mu, nu)


def _autograd_vg(fun):
    def vg(x):
        with torch.enable_grad():
            xs = [a.detach().requires_grad_(True) for a in x]
            f = fun(tuple(xs))
            grads = torch.autograd.grad(f.sum(), xs)
        return f.detach(), grads
    return vg


def graphed_vg(fun: Callable[[tuple[torch.Tensor, ...]], torch.Tensor],
               x0: Sequence[torch.Tensor]):
    """``x -> (fun(x), grads)`` at the shapes of ``x0``, as autograd gives
    them; on a CUDA device replayed from one CUDA graph of that call.

    A value+grad through an unrolled solve is thousands of small launches
    whose host cost is several times their device time; the graph launches
    them in one call, with the kernels of the eager call.  ``fun`` must not
    synchronise with the host or copy from it (the constants it makes are
    fills on the device).  On the CPU this is plain autograd.
    """
    dev = x0[0].device
    if dev.type != "cuda":
        return _autograd_vg(fun)
    static = [a.detach().clone().requires_grad_(True) for a in x0]
    with torch.cuda.device(dev), torch.enable_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):    # warm-up before capture, as documented
                torch.autograd.grad(fun(tuple(static)).sum(), static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            f = fun(tuple(static))
            grads = torch.autograd.grad(f.sum(), static)
    f = f.detach()

    def vg(x):
        with torch.no_grad():
            for s, a in zip(static, x):
                s.copy_(a)
        graph.replay()
        return f.clone(), tuple(g.clone() for g in grads)

    return vg


def adam_minimize(
    fun: Callable[[tuple[torch.Tensor, ...]], torch.Tensor] | None,
    x0: Sequence[torch.Tensor],
    iters: int = 1000,
    lr: float = 1e-2,
    opt_state: AdamState | None = None,
    fun_and_grad: Callable | None = None,
    log_every: int = 0,
) -> AdamResult:
    """Run ``iters`` Adam steps from ``x0``, a tuple of tensors whose
    leading axis is the restart axis.

    ``fun(x) -> f[R]`` is differentiated by autograd unless ``fun_and_grad``
    (``x -> (f[R], grads like x)``) is given; ``fval`` is ``fun(x)`` at the
    end, or None when there is no ``fun`` (no evaluation after the last
    step).  ``log_every > 0`` prints every row's loss on stderr before
    steps 0, k, 2k, … (the reference's ProgressMeter display); each print
    waits for the device, so the default 0 prints nothing and never waits.
    """
    vg = fun_and_grad if fun_and_grad is not None else _autograd_vg(fun)
    x = tuple(a.detach() for a in x0)
    state = adam_init(x) if opt_state is None else opt_state
    trace = []
    for i in range(iters):
        f, grads = vg(x)
        trace.append(f)
        if log_every > 0 and i % log_every == 0:
            loss = " ".join(f"{v:.6f}" for v in f.reshape(-1).tolist())
            print(f"adam it={i} loss={loss}", file=sys.stderr)
        grads = [torch.where(torch.isfinite(g), g, 0.0) for g in grads]
        x, state = adam_step(x, grads, state, lr)
    fval = None
    if fun is not None:
        with torch.no_grad():
            fval = fun(x)
    dev = x[0].device
    loss_trace = (torch.stack(trace, dim=-1) if trace
                  else torch.zeros(x[0].shape[0], 0, device=dev))
    return AdamResult(x=x, fval=fval, loss_trace=loss_trace,
                      opt_state=state)
