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

* The top-level module ``nn`` (which has no ``__all__``): every public
  name it defines, and every public method and property of its ``MLP``, is
  the port's, with the same options; ``MLP.init`` draws the JAX package's
  Glorot layout and ``chain`` takes a callable activation.
* The package's own ``__all__`` is the JAX package's eight subpackages, each
  imported at its first use.

Each exception carries its reason; a name, parameter or flag with no
counterpart and no entry fails.
"""

import ast
import importlib
import inspect
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
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


def _nn_public() -> list[str]:
    """The public names the JAX ``nn`` module defines at its top level."""
    tree = ast.parse((REPO / "conditional_ude_tpu" / "nn.py").read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_")]


def test_nn_public_names_have_counterparts():
    """``Activation``, ``resolve_activation``, ``MLP`` (its methods and
    properties) and ``chain``, each with the JAX package's options."""
    from conditional_ude_tpu import nn as jnn
    from conditional_ude_tpu_torch import nn as pnn

    names = _nn_public()
    assert {"Activation", "resolve_activation", "MLP", "chain"} <= set(names)
    pairs = [(getattr(jnn, n), getattr(pnn, n, None), n) for n in names]
    net = pnn.chain(4, 2)      # fields are the port's instance attributes
    pairs += [(getattr(jnn.MLP, m), getattr(net, m, None), f"MLP.{m}")
              for m in vars(jnn.MLP) if not m.startswith("_")]
    missing = [what for _, ours, what in pairs if ours is None]
    missing += [f"{what}: no parameter {k}" for theirs, ours, what in pairs
                if ours is not None and callable(theirs)
                and not isinstance(theirs, type)
                for k in _keywords(theirs) if k not in _parameters(ours)]
    assert not missing, missing


def test_mlp_init_is_the_glorot_row_of_init_batch():
    """One flat vector in the JAX package's layout (per layer W row-major
    [fan_out][fan_in] in ±sqrt(6 / (fan_in + fan_out)), then a zero
    bias), the row ``init_batch`` draws for n = 1 from the same state."""
    from conditional_ude_tpu.nn import chain as jax_chain
    from conditional_ude_tpu_torch.nn import chain

    for args in ((4, 2), ([6, 3],), (8, 3)):
        net, jnet = chain(*args, input_dims=3), jax_chain(*args, input_dims=3)
        assert net.layer_dims == jnet.layer_dims
        flat = net.init(torch.Generator().manual_seed(5))
        assert flat.shape == (jnet.num_params,) and flat.dtype == torch.float32
        assert torch.equal(flat, net.init_batch(
            1, torch.Generator().manual_seed(5))[0])
        for (w, b), (fi, fo) in zip(net.unflatten(flat), net.layer_dims):
            assert w.shape == (fo, fi) and not bool(b.any())
            bound = math.sqrt(6.0 / (fi + fo))
            assert float(w.abs().max()) <= bound and float(w.std()) > 0
        assert net.init(torch.Generator().manual_seed(5),
                        torch.float64).dtype == torch.float64


def test_chain_takes_a_callable_activation():
    """A callable is stored by its ``__name__``, as JAX stores it, and the
    network computes with it; ``resolve_activation`` maps a name to its
    function and returns a callable as it is."""
    from conditional_ude_tpu.nn import chain as jax_chain
    from conditional_ude_tpu_torch import nn as pnn

    for fn, jfn in ((torch.tanh, "tanh"), (torch.sigmoid, "sigmoid"),
                    (pnn.gelu, "gelu")):
        net = pnn.chain(4, 2, fn)
        assert net.activations == jax_chain(4, 2, jfn).activations
        assert net.activations == pnn.chain(4, 2, fn.__name__).activations
        assert pnn.resolve_activation(net.activations[0]) is \
            pnn.ACTIVATIONS[fn.__name__]
    assert pnn.resolve_activation(torch.relu) is torch.relu
    with pytest.raises(ValueError):
        pnn.resolve_activation("swish")
    x = torch.linspace(-2, 2, 8).reshape(4, 2)
    flat = pnn.chain(4, 2).init(torch.Generator().manual_seed(1))
    assert torch.equal(pnn.chain(4, 2, torch.tanh)(flat, x),
                       pnn.chain(4, 2)(flat, x))


def test_top_level_all_is_the_jax_packages():
    """``conditional_ude_tpu_torch.__all__`` lists the JAX package's eight
    subpackages; importing the package imports none of them (a fresh
    process), and each name gives its subpackage."""
    import conditional_ude_tpu
    import conditional_ude_tpu_torch as port

    assert sorted(port.__all__) == sorted(conditional_ude_tpu.__all__)
    code = ("import sys, conditional_ude_tpu_torch as p; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('conditional_ude_tpu_torch.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, check=True).stdout
    assert out.strip() == "[]"
    for name in port.__all__:
        mod = getattr(port, name)
        assert mod is importlib.import_module(f"conditional_ude_tpu_torch."
                                              f"{name}")
    with pytest.raises(AttributeError):
        port.no_such_subpackage
