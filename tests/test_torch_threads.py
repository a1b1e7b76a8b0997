"""Every test file of the port that runs on the CPU caps torch at one
intra-op thread (``tests/torch_threads.py``): a file without the cap runs
at a thread a core beside the other test processes, and its tests wait on
each other's threads.  ``test_torch_cuda.py`` runs on the card and is the
one exception."""

import ast
from pathlib import Path

from torch_threads import one_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent
ON_THE_CARD = {"test_torch_cuda.py"}


def _imports_the_cap(path: Path) -> bool:
    return any(isinstance(node, ast.ImportFrom)
               and node.module == "torch_threads"
               and any(a.name == "one_thread" and a.asname is None
                       for a in node.names)
               for node in ast.parse(path.read_text()).body)


def test_every_cpu_test_file_of_the_port_caps_torch_threads():
    files = sorted(p for p in TESTS.glob("test_torch_*.py")
                   if p.name not in ON_THE_CARD)
    assert len(files) >= 40
    assert [p.name for p in files if not _imports_the_cap(p)] == []
