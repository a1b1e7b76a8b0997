"""Profiling helpers (counterpart of ``conditional_ude_tpu/utils/profiling.py``):
wall-clock scopes, device traces and NaN policing.

* ``scope``: a wall-clock scope printed as ``[name] 1.23s``;
* ``device_trace``: a ``torch.profiler`` trace of the enclosed block, with
  the card's kernels when one is in use, written as a Chrome trace;
* ``checked``: the JAX package's ``checkify`` float checks done with a
  ``TorchDispatchMode``: the first aten op that made a NaN its inputs did
  not hold, or divided by zero, is named.
"""

from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

TRACE_FILE = "trace.json"
# ops whose second operand divides the first
_DIVISIONS = ("div", "div_", "floor_divide", "floor_divide_", "remainder",
              "remainder_", "fmod", "fmod_")


@contextlib.contextmanager
def scope(name: str, out=sys.stderr):
    """Wall-clock scope printed as ``[name] 1.23s``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print(f"[{name}] {time.perf_counter() - t0:.2f}s", file=out,
              flush=True)


@contextlib.contextmanager
def device_trace(log_dir: str | Path):
    """A ``torch.profiler`` trace of the enclosed block, written to
    ``log_dir/trace.json`` (Chrome trace format, readable by Perfetto) when
    the block ends; the card's kernels are traced too when CUDA is in use.
    Yields the path of that file.

    Usage::

        with device_trace("runs/trace") as path:
            profile = cohort_beta_profiles(...)
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    path = log_dir / TRACE_FILE
    with profile(activities=activities) as prof:
        yield path
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


class FloatError:
    """What ``checked`` found: ``get()`` is None or the message of the
    first fault; ``throw()`` raises it."""

    def __init__(self, message: str | None = None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def _floats(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _has_nan(tensors) -> bool:
    return any(bool(torch.isnan(t).any()) for t in tensors)


class _FloatChecks(TorchDispatchMode):
    """Records the first aten op that makes a NaN out of NaN-free inputs or
    divides by zero; every op still runs as it would."""

    def __init__(self):
        super().__init__()
        self.message = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.message is None:
            name = func.overloadpacket.__name__
            if name in _DIVISIONS and len(args) > 1:
                divisor = args[1]
                zero = (bool((divisor == 0).any())
                        if isinstance(divisor, torch.Tensor) else divisor == 0)
                if zero:
                    self.message = f"division by zero in {func}"
            if self.message is None and _has_nan(_floats(out)) \
                    and not _has_nan(_floats((args, kwargs))):
                self.message = f"nan generated by {func}"
        return out


def checked(fn):
    """``fn`` wrapped to return ``(error, out)``: ``error.throw()`` raises,
    naming the aten op, if an op of ``fn`` made a NaN that its inputs did
    not hold or divided by zero (the JAX package's ``checkify`` float
    checks).  The losses propagate ``inf`` on purpose (a failed solve is an
    ``inf`` objective); this is for finding where a non-finite value first
    appears.  Every op's inputs and outputs are inspected, which syncs the
    card at each op: a debugging tool, not a production path.

    Usage::

        err, loss = checked(lambda b: population_sse(model, nn, b, cohort))(betas)
        err.throw()
    """

    def wrapped(*args, **kwargs):
        mode = _FloatChecks()
        with mode:
            out = fn(*args, **kwargs)
        return FloatError(mode.message), out

    return wrapped
