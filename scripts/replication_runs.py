"""The port's replication experiments at full size on one card, through their
entry points, held against the JAX package's committed results.

    python3 scripts/replication_runs.py [--out DIR]

1. ``python -m conditional_ude_tpu_torch --experiment exp05`` (5 ablation
   seeds x 10 fractions), started first and run beside 2 and 3;
2. ``--experiment exp02_seeds`` at seeds 11, 22, 33, 44 and 55, then
   ``--merge``;
3. ``python -m conditional_ude_tpu_torch.replicate --experiment exp02
   --seeds 11 22 -- --retrain``.

Each command's output goes under DIR (default ``build/replication``); its
wall-clock, exit code and kernel launches (the entry point's last line on
the standard error), the card's name and power limit, and each result
against its limit go to ``DIR/summary.json``, which is also the last line
printed.  The limits: each seed within exp02's retrain limits (objective
<= 0.30, test SSE mean 0.41-0.64, first-phase Spearman <= -0.77); the
across-seed test SSE mean and Spearman against the range of the committed
per-seed files (``results/exp02_seed_*.json``); each exp05 fraction's
across-seed median of the test-SSE median against the committed five-seed
range (``results/exp05_ablation.csv``) widened by 10 %.
"""

from __future__ import annotations

import argparse
import csv
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
RESULTS = REPO / "results"
SEEDS = (11, 22, 33, 44, 55)
ENTRY = [sys.executable, "-m", "conditional_ude_tpu_torch"]


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def launches(log: Path) -> dict | None:
    """The entry point's record of its kernel launches, from its log."""
    for line in reversed(log.read_text().splitlines()):
        if line.startswith('{"launches"'):
            return json.loads(line)["launches"]
    return None


def run(name: str, cmd: list[str], out: Path, runs: dict) -> None:
    log = out / f"{name}.log"
    t0 = time.perf_counter()
    with log.open("w") as f:
        rc = subprocess.run(cmd, cwd=REPO, stdout=f,
                            stderr=subprocess.STDOUT).returncode
    runs[name] = {"seconds": time.perf_counter() - t0, "rc": rc,
                  "launches": launches(log)}
    print(json.dumps({name: runs[name]}), flush=True)


def check_seeds(out: Path) -> dict:
    committed = [json.loads((RESULTS / f"exp02_seed_{s}.json").read_text())
                 for s in SEEDS]
    per_seed = {}
    for s in SEEDS:
        path = out / f"exp02_seed_{s}.json"
        if not path.exists():
            per_seed[s] = None
            continue
        r = json.loads(path.read_text())
        rho = r["spearman"]["first_phase"]
        per_seed[s] = {
            "objective_best": r["objective_best"],
            "test_sse_mean": r["test_sse_mean"],
            "spearman_first_phase": rho,
            "train_seconds": r["train_seconds"],
            "cude_better_fraction": (r["ude_vs_cude"] or {}).get(
                "cude_better_fraction"),
            "within_limits": (r["objective_best"] <= 0.30
                              and 0.41 <= r["test_sse_mean"] <= 0.64
                              and rho <= -0.77)}
    merged = out / "exp02_seeds_metrics.json"
    across = {}
    if merged.exists():
        m = json.loads(merged.read_text())
        for key, ours in (("test_sse_mean", m["test_sse_mean"]["mean"]),
                          ("spearman.first_phase",
                           m["spearman.first_phase"]["mean"])):
            vals = [c["test_sse_mean"] if key == "test_sse_mean"
                    else c["spearman"]["first_phase"] for c in committed]
            across[key] = {"port_mean": ours, "committed_min": min(vals),
                           "committed_max": max(vals),
                           "inside": min(vals) <= ours <= max(vals)}
        across["beta_orientations"] = m["beta_orientations"]
    return {"per_seed": per_seed, "across_seeds": across}


def check_ablation(out: Path) -> dict:
    with (RESULTS / "exp05_ablation.csv").open() as f:
        committed = list(csv.DictReader(f))
    metrics = out / "exp05_metrics.json"
    ours = json.loads(metrics.read_text())[
        "test_sse_median_across_seeds"] if metrics.exists() else {}
    by_fraction = {}
    for frac in sorted({float(r["fraction"]) for r in committed}):
        vals = [float(r["test_sse_median"]) for r in committed
                if float(r["fraction"]) == frac]
        lo, hi = 0.9 * min(vals), 1.1 * max(vals)
        got = (ours.get(str(frac)) or {}).get("median")
        by_fraction[str(frac)] = {
            "port_median": got, "limits": [lo, hi],
            "committed_median": float(np.median(vals)),
            "inside": got is not None and lo <= got <= hi}
    return by_fraction


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=REPO / "build" / "replication")
    args = p.parse_args()
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    summary = {"card": card(), "runs": {}}
    runs = summary["runs"]
    t0 = time.perf_counter()
    exp05_log = (out / "exp05.log").open("w")
    exp05 = subprocess.Popen(
        [*ENTRY, "--experiment", "exp05", "--out", str(out / "exp05")],
        cwd=REPO, stdout=exp05_log, stderr=subprocess.STDOUT)
    try:
        run("exp02_seeds", [*ENTRY, "--experiment", "exp02_seeds", "--out",
                            str(out / "seeds")], out, runs)
        run("exp02_seeds_merge", [*ENTRY, "--experiment", "exp02_seeds",
                                  "--merge", "--out", str(out / "seeds")],
            out, runs)
        run("replicate_exp02", [
            sys.executable, "-m", "conditional_ude_tpu_torch.replicate",
            "--experiment", "exp02", "--seeds", "11", "22", "--out",
            str(out / "replicate"), "--", "--retrain"], out, runs)
        rc = exp05.wait()
    finally:
        if exp05.poll() is None:
            exp05.kill()
            exp05.wait()
        exp05_log.close()
    runs["exp05"] = {"seconds": time.perf_counter() - t0, "rc": rc,
                     "launches": launches(out / "exp05.log")}
    rep = out / "replicate" / "replicate_exp02.json"
    if rep.exists():
        r = json.loads(rep.read_text())
        runs["replicate_exp02"]["aggregated_keys"] = len(r["aggregate"])
        runs["replicate_exp02"]["test_sse_mean"] = {
            s: m["test_sse_mean"] for s, m in r["per_seed"].items()}
    summary["exp02_seeds"] = check_seeds(out / "seeds")
    summary["exp05"] = check_ablation(out / "exp05")
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
