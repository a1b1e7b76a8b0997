"""Where the tier-1 suite's time goes, from its JUnit report.

Two uses.  As a pytest plugin it tags every test's JUnit entry with the
xdist worker that ran it (a ``worker`` property); it changes nothing else:

    PYTHONPATH=scripts PYTEST_ADDOPTS="-p tier1_report" <the tier-1 command>

As a script it reads such a report and prints one JSON object: the tests'
count, their summed seconds, each worker's summed seconds and test count,
and the longest tests:

    python scripts/tier1_report.py report.xml [--top 5]
"""

from __future__ import annotations

import argparse
import json
import os
import xml.etree.ElementTree as ET
from collections import defaultdict


def pytest_runtest_setup(item):
    # an item's properties go into each of its reports, and the JUnit file
    # takes them from the last
    item.user_properties.append(
        ("worker", os.environ.get("PYTEST_XDIST_WORKER", "main")))


def summarise(path: str, top: int = 5) -> dict:
    cases = ET.parse(path).getroot().iter("testcase")
    per_worker = defaultdict(lambda: [0.0, 0])
    rows = []
    for case in cases:
        seconds = float(case.get("time", 0.0))
        worker = "untagged"
        for prop in case.iter("property"):
            if prop.get("name") == "worker":
                worker = prop.get("value")
        per_worker[worker][0] += seconds
        per_worker[worker][1] += 1
        rows.append((seconds, f"{case.get('classname')}::{case.get('name')}",
                     worker))
    rows.sort(reverse=True)
    return {
        "tests": len(rows),
        "seconds_summed": sum(r[0] for r in rows),
        "workers": {w: {"seconds": s, "tests": n}
                    for w, (s, n) in sorted(per_worker.items())},
        "longest": [{"test": name, "seconds": s, "worker": w}
                    for s, name, w in rows[:top]],
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("junit", help="the JUnit XML file of a pytest run")
    p.add_argument("--top", type=int, default=5, help="longest tests shown")
    args = p.parse_args()
    print(json.dumps(summarise(args.junit, args.top), indent=1))


if __name__ == "__main__":
    main()
