"""conditional_ude_tpu_torch — the PyTorch/CUDA port of ``conditional_ude_tpu``.

A second package beside the JAX one, which stays the reference.  It runs
exp02 (frozen candidates or ``--retrain``), its covariate variant exp07 and
its enlarged multi-start exp02_xl, the non-conditional UDE of exp01, and
the symbolic refits of exp03, exp04 and exp_symreg_production
(``python -m conditional_ude_tpu_torch [--experiment NAME]``, on the card
by default).

Conventions:
  * tensors are ``torch.float32`` throughout, as in the JAX package;
  * every function that makes tensors takes an explicit ``device``; nothing
    picks a device by itself;
  * batch axes lead and the individual axis is last (``betas[..., N]``), so
    candidate networks, profile grid points and individuals are one batch;
  * the kernels (``ops/rk4_cohort.py``, ``rk4_population.py``,
    ``lane_grad.py``, ``population_grad.py``, ``tsit5_cohort.py``) are CUDA
    C++ for Hopper, built by ``nvcc`` at first use; a CPU tensor takes
    their plain PyTorch versions.

The package never imports ``jax`` or ``conditional_ude_tpu``.
"""

__version__ = "0.1.0"

# the subpackages, as the JAX package's __all__ lists them; each is imported
# at its first use (__getattr__), so importing the package imports none
__all__ = ["nn", "ops", "models", "fit", "analysis", "data", "parallel",
           "utils"]


def __getattr__(name: str):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return importlib.import_module(f"{__name__}.{name}")


def __dir__():
    return sorted([*globals(), *__all__])


def lazy_exports(package: str, modules: dict[str, list[str]]):
    """``(__all__, __getattr__, __dir__)`` of a subpackage whose public
    names live in its ``modules`` (module → names) and are imported at
    their first use, so that the subpackages, which import one another's
    modules, import in any order."""
    import importlib

    where = {name: mod for mod, names in modules.items() for name in names}
    names = sorted(where, key=str.lower)

    def __getattr__(name: str):
        if name not in where:
            raise AttributeError(f"module {package!r} has no attribute "
                                 f"{name!r}")
        return getattr(importlib.import_module(f"{package}.{where[name]}"),
                       name)

    return names, __getattr__, lambda: names
