"""PyTorch port: the port does all the JAX package does, by name.

* Every name in a JAX subpackage's ``__all__`` (``fit``, ``models``,
  ``ops``, ``analysis``, ``data``, ``utils``, ``parallel``) is in the
  port's subpackage of the same name, under its own name or the one in
  ``RENAMED``, unless ``NOT_PORTED`` says why not; and each of its options
  (its parameters with a default and its keyword-only ones; a class's
  fields with a default) is one of the port's, unless
  ``NOT_PORTED_PARAMETER`` or ``PARAMETERS`` says why not.
* Every flag of a JAX experiment script (``experiments/*.py``, with
  ``experiments/common.py``'s for the scripts that take them) is a flag of
  the port's entry point (``python -m conditional_ude_tpu_torch``; the
  replication runner's for ``exp_replicate.py``), or ``FLAGS`` names its
  counterpart there.

Each exception carries its reason; a name, parameter or flag with no
counterpart and no entry fails.
"""

import importlib
import inspect
import re
from pathlib import Path

import pytest
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu_torch import __main__ as entry
from conditional_ude_tpu_torch import replicate

REPO = Path(__file__).resolve().parent.parent
SUBPACKAGES = ("fit", "models", "ops", "analysis", "data", "utils",
               "parallel")
KERNEL = "the JAX Pallas kernel's entry; the port's is its kernel's wrapper"
RENAMED = {
    ("ops", "cohort_sse_pallas"): ("cohort_sse", KERNEL + " (K4)"),
    ("ops", "cohort_sse_tsit5_pallas"): ("cohort_sse_tsit5",
                                         KERNEL + " (K3)"),
    ("ops", "population_sse_pallas"): ("population_sse", KERNEL + " (K1)"),
    ("ops", "screen_population_pallas"): (
        "population_sse", KERNEL + ": the JAX package screens by K4's lanes "
        "or by K1, the port by K1 (the same per-restart mean SSE)"),
    ("parallel", "sharded_screen_pallas"): ("sharded_screen", KERNEL),
}
NOT_PORTED = {
    ("models", "Individual"): "an individual is a Cohort of one "
                              "(build_individual)",
    ("ops", "LBFGSState"): "not ported, on purpose (ROADMAP): the port's "
                           "L-BFGS keeps its state inside one call",
}
# keyword parameters of the JAX package the port has not, and why
NOT_PORTED_PARAMETER = {
    "use_pallas": "the port picks its kernel by itself (fused_kernel_"
                  "eligible: the canonical model, one β, RK4)",
    "interpret": "not ported, on purpose: a CPU tensor takes the kernel's "
                 "plain version",
    "dispatch_chunk": "not ported, on purpose: a CUDA launch has no "
                      "dispatch size to chunk",
    "mode": "not ported, on purpose (the JAX package's checkpoint mode)",
    "remat": "not ported, on purpose (XLA's rematerialisation)",
    "init_state": "not ported, on purpose: LBFGSState is not ported",
}
# (subpackage, name) -> {JAX parameter: reason} beside the above
SOLVER_KW = ("the port's simulate passes **solver_kwargs on to solve_tsit5 "
             "or solve_rk4, which take it")
PARAMETERS = {
    ("models", "simulate"): {"rtol": SOLVER_KW, "atol": SOLVER_KW,
                             "max_steps": SOLVER_KW, "substeps": SOLVER_KW},
    ("ops", "solve_tsit5"): {
        "dt0": "the first step is always the JAX package's default (its "
               "initial-step heuristic): no caller passes dt0"},
    ("ops", "lbfgs_minimize"): {"fun_and_grad": "value_and_grad"},
    ("ops", "LBFGSResult"): {"state": "an LBFGSState, not ported on "
                                      "purpose"},
}
# flags of the JAX scripts whose counterpart has another name
FLAGS = {
    "--cpu": ("--device", "--device cpu"),
    "--tpu": ("--device", "--device cuda, the card (the default)"),
    "--results": ("--out", "the outputs' directory, --smoke's in "
                           "DIR/smoke"),
    "--script": ("--experiment", "the replication runner's experiment"),
    "--scratch": ("--out", "the runner's seeds go to DIR/seeds"),
}


def _public(pkg: str) -> list[tuple[str, str]]:
    jax_pkg = importlib.import_module(f"conditional_ude_tpu.{pkg}")
    return [(pkg, name) for name in jax_pkg.__all__]


def _keywords(obj) -> list[str]:
    """The options of ``obj``: its parameters with a default, and its
    keyword-only ones (the data it takes first are laid out otherwise in
    the port: a ``Cohort`` holds an individual's inputs, timepoints and
    data)."""
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return []
    return [n for n, p in sig.parameters.items()
            if p.kind == p.KEYWORD_ONLY
            or (p.kind == p.POSITIONAL_OR_KEYWORD
                and p.default is not p.empty)]


def _parameters(obj) -> set[str]:
    try:
        return set(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return set()


NAMES = [item for pkg in SUBPACKAGES for item in _public(pkg)]


def _missing(pkg: str, name: str) -> str | None:
    """What ``pkg.name`` of the JAX package lacks in the port, if any."""
    if (pkg, name) in NOT_PORTED:
        return None
    port_name = RENAMED.get((pkg, name), (name,))[0]
    port = importlib.import_module(f"conditional_ude_tpu_torch.{pkg}")
    if port_name not in port.__all__:
        return f"{pkg}.{name}: no {port_name}"
    ours = getattr(port, port_name)
    theirs = getattr(importlib.import_module(f"conditional_ude_tpu.{pkg}"),
                     name)
    if (pkg, name) in RENAMED or not callable(theirs):
        # a kernel's wrapper takes the cohort's tensors; a constant has no
        # parameters
        return None
    missing = [k for k in _keywords(theirs)
               if k not in _parameters(ours)
               and k not in NOT_PORTED_PARAMETER
               and k not in PARAMETERS.get((pkg, name), {})]
    return f"{pkg}.{name}: no parameter {missing}" if missing else None


@pytest.mark.parametrize("pkg", SUBPACKAGES)
def test_every_public_name_has_a_counterpart(pkg):
    names = [name for p, name in NAMES if p == pkg]
    assert names
    missing = [m for m in (_missing(pkg, n) for n in names) if m]
    assert not missing, missing


def _script_flags(path: Path) -> set[str]:
    text = path.read_text()
    flags = set(re.findall(r'add_argument\(\s*"(--[a-z-]+)"', text))
    if "make_parser(" in text and path.name != "common.py":
        flags |= _script_flags(REPO / "experiments" / "common.py")
    return flags


SCRIPTS = sorted((REPO / "experiments").glob("exp*.py"))


def test_every_script_flag_has_a_counterpart():
    missing = []
    for script in SCRIPTS:
        parser = (replicate.parser() if script.stem == "exp_replicate"
                  else entry.parser())
        ours = set(parser._option_string_actions)
        missing += [f"{script.name} {flag}: no {FLAGS.get(flag, (flag,))[0]}"
                    for flag in sorted(_script_flags(script))
                    if FLAGS.get(flag, (flag,))[0] not in ours]
    assert len(SCRIPTS) == 19 and not missing, missing


def test_every_exception_is_used():
    """No entry of the tables outlives what it explains."""
    names = set(NAMES)
    assert set(RENAMED) <= names and set(NOT_PORTED) <= names
    assert set(PARAMETERS) <= names
    used = {k for pkg, name in NAMES if (pkg, name) not in NOT_PORTED
            for k in _keywords(getattr(importlib.import_module(
                f"conditional_ude_tpu.{pkg}"), name))}
    assert set(NOT_PORTED_PARAMETER) <= used
    flags = set().union(*map(_script_flags, SCRIPTS))
    assert set(FLAGS) <= flags
