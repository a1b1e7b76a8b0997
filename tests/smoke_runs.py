"""The port's entry point at ``--smoke`` on the CPU, held to the JAX
experiment scripts' own ``--smoke`` runs (``scripts/smoke_reference.json``,
made by ``scripts/smoke_reference.py``): the same metric keys but the
timers, the draw-free values at the fits' tolerances
(``smoke_reference.check``), the metrics printed as written into
``DIR/smoke``, and no kernel launched (on the CPU every wrapper takes its
plain version).  ``tests/test_torch_smoke_*.py`` use it.
"""

import importlib.util
import json
from pathlib import Path

from conditional_ude_tpu_torch import __main__ as entry

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "smoke_reference", REPO / "scripts" / "smoke_reference.py")
reference = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference)
REFERENCE = json.loads(reference.OUT.read_text())
# the metrics file an experiment writes into DIR/smoke where it is not
# <name>_metrics.json (exp02_seeds: one record a seed, the last printed)
FILES = {"exp02_seeds": "exp02_seed_{seed}.json",
         "exp_symreg_production": "symreg_production_metrics.json"}


def same_json(a, b) -> bool:
    """Equal as JSON (NaN equal to NaN)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def run_smoke(name: str, out: Path, capsys, *extra) -> dict:
    """``--experiment name --smoke --device cpu --out out``: its metrics,
    checked against the JAX run and against what it wrote."""
    entry.main(["--experiment", name, "--smoke", "--device", "cpu",
                "--out", str(out), *extra])
    printed_out, printed_err = capsys.readouterr()
    printed = json.loads(printed_out.strip().splitlines()[-1])
    assert json.loads(printed_err.strip().splitlines()[-1]) \
        == {"launches": {}}
    written = json.loads((out / "smoke" / FILES.get(
        name, f"{name}_metrics.json").format(**printed)).read_text())
    assert same_json(printed, written)
    assert reference.check(name, printed, REFERENCE[name]) == []
    return printed
