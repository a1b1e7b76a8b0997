"""PyTorch port: importing every module of the port loads neither ``jax`` nor
the JAX package, nor ``matplotlib``, ``pandas`` or ``h5py`` (the card's
machine has none of the three: the figure functions import matplotlib and
the JLD2 readers h5py when they run, and the CSV readers need neither)."""

import subprocess
import sys
from pathlib import Path

from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import conditional_ude_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "conditional_ude_tpu",
                                    "matplotlib", "pandas", "h5py"))
print(len(names), bad)
assert not bad, bad
for m in ("fit.optim", "ops.tsit5", "ops.rk4_population", "ops.lane_grad",
          "ops.tsit5_cohort", "ops.population_grad", "ops.cuda_build",
          "seeds", "ablation", "replicate", "fit.saem", "saem_pipeline",
          "fit.advi", "advi_pipeline", "models.suppression",
          "suppression_pipeline", "analysis.symreg", "symreg_pipeline",
          "utils.figures", "utils.profiling", "cli", "figures_pipeline",
          "parallel.mesh", "parallel.dryrun", "data.jld2", "etl_pipeline",
          "parity_pipeline"):
    assert pkg.__name__ + "." + m in names, m
assert "torch" in sys.modules
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 40 and bad.strip() == "[]"
