"""The port's SAEM experiments at full depth on one card, through their
entry points, held against the JAX package's spread and committed results.

    python3 scripts/saem_runs.py [--out DIR]

1. ``python -m conditional_ude_tpu_torch --experiment exp06``, ``exp06a``
   and ``exp06b``, the three side by side;
2. then ``python -m conditional_ude_tpu_torch.replicate --experiment exp06
   --seeds 11 22 33 44 55 -- --retrain`` (each child retrains the
   pre-train, as the JAX runner's empty artifacts directory makes it).

Each command's output goes under DIR (default ``build/saem``); its
wall-clock, exit code, stage seconds and kernel launches (the entry
point's lines on the standard error), the card's name and power limit,
and each metric beside its limit go to ``DIR/summary.json``, which is also
the last line printed.  The limits: exp06, exp06a and exp06b's metrics
inside the spread of the JAX package's own runs on the CPU over 31 key
pairs widened by half its width on each side (``chip_smoke.py``'s
``SAEM_SPREAD`` and ``widen``, from
``scripts/saem_reference.py``), beside the committed
``results/exp06*_metrics.json``; the replicate's per-metric range beside
the committed ``results/replicate_exp06_saem.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import SAEM_SPREAD, card_line, widen  # noqa: E402
from conditional_ude_tpu_torch.replicate import flatten  # noqa: E402

RESULTS = REPO / "results"
ENTRY = [sys.executable, "-m", "conditional_ude_tpu_torch"]
SEEDS = ("11", "22", "33", "44", "55")


def stderr_record(log: Path, key: str):
    """The value of ``key`` in the last JSON line of ``log`` that has it."""
    for line in reversed(log.read_text().splitlines()):
        if line.startswith("{") and f'"{key}"' in line:
            try:
                return json.loads(line)[key]
            except (json.JSONDecodeError, KeyError):
                continue
    return None


def held(name: str, metrics_file: Path) -> dict:
    """Each held metric of ``name`` against the widened JAX spread, with
    the committed TPU-made value beside it."""
    if not metrics_file.exists():
        return {"missing": str(metrics_file)}
    got = flatten(json.loads(metrics_file.read_text()))
    committed = flatten(json.loads(
        (RESULTS / f"{name}_metrics.json").read_text()))
    out = {}
    for key, (lo, hi) in SAEM_SPREAD[name].items():
        lo, hi = widen(lo, hi)
        out[key] = {"port": got.get(key), "limits": [lo, hi],
                    "committed": committed.get(key),
                    "inside": key in got and lo <= got[key] <= hi}
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=REPO / "build" / "saem")
    args = p.parse_args()
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    summary = {"card": card_line(), "runs": {}}
    runs = summary["runs"]
    procs = {}
    t0 = time.perf_counter()
    for name in ("exp06", "exp06a", "exp06b"):
        log = (out / f"{name}.log").open("w")
        procs[name] = (subprocess.Popen(
            [*ENTRY, "--experiment", name, "--out", str(out / name)],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT), log)
    try:
        while len(runs) < len(procs):
            for name, (proc, log) in procs.items():
                if name in runs or proc.poll() is None:
                    continue
                log.close()
                path = out / f"{name}.log"
                runs[name] = {
                    "seconds": time.perf_counter() - t0,
                    "rc": proc.returncode,
                    "stage_seconds": stderr_record(path, "stage_seconds"),
                    "route": stderr_record(path, "route"),
                    "launches": stderr_record(path, "launches")}
                print(json.dumps({name: runs[name]}), flush=True)
            time.sleep(0.5)
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for name in procs:
        summary[name] = held(name, out / name / f"{name}_metrics.json")

    t1 = time.perf_counter()
    log = out / "replicate_exp06.log"
    with log.open("w") as f:
        rc = subprocess.run(
            [sys.executable, "-m", "conditional_ude_tpu_torch.replicate",
             "--experiment", "exp06", "--seeds", *SEEDS, "--out",
             str(out / "replicate"), "--", "--retrain"], cwd=REPO, stdout=f,
            stderr=subprocess.STDOUT).returncode
    runs["replicate_exp06"] = {
        "seconds": time.perf_counter() - t1, "rc": rc,
        "children_stage_seconds": [
            json.loads(line)["stage_seconds"]
            for line in log.read_text().splitlines()
            if line.startswith('{"stage_seconds"')]}
    rep = out / "replicate" / "replicate_exp06.json"
    if rep.exists():
        ours = json.loads(rep.read_text())["aggregate"]
        theirs = json.loads((RESULTS / "replicate_exp06_saem.json")
                            .read_text())["aggregate"]
        summary["replicate_exp06"] = {
            key: {"port": {k: ours[key][k] for k in ("mean", "min", "max")}
                  if key in ours else None,
                  "committed": {k: v[k] for k in ("mean", "min", "max")}}
            for key, v in theirs.items()}
        summary["replicate_exp06"]["keys_only_in_port"] = sorted(
            set(ours) - set(theirs))
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
