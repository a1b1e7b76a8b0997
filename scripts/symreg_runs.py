"""The port's exp_symreg_search at full depth on one card, through its entry
point, held to the search's own claims and the committed results.

    python3 scripts/symreg_runs.py [--out DIR] [--only count probe run]
        [--search-seeds N] [--budget SECONDS] [--device DEV]

* ``probe``: one GP run of each of the script's configurations (depth 4 ×
  4096 and depth 5 × 2048, 300 generations) on the card, synchronised
  around its phases (``fit_symbolic(..., timings=...)``): ms a
  generation, seconds a block's constant optimisation (the block's best
  64 and the hall's 18, 80 Adam steps each), and the run's seconds;
* ``count`` (any ``--device``, the CPU too): the aten calls of a
  generation and of a constant-optimisation step, counted by a dispatch
  mode over one block (20 generations) with 80 and with 0 constant steps;
  they do not depend on the population, so the count runs at 256;
* ``run``: ``python -m conditional_ude_tpu_torch --experiment
  exp_symreg_search --search-seeds N --out DIR/run`` (N = 3, the committed
  run's), checked:

  - each search seed's ``best_holdout_mse`` below the reference
    equation's holdout MSE (0.005350), with at least one inv-family row:
    the script's claim that the search re-discovers a rational family
    beating the published equation;
  - the merged front's best holdout MSE (``holdout.best_discovered_mse``)
    at most 1.5 × the committed worst seed's (1.376e-3 → 2.064e-3);
  - ``pareto_size`` 6–16 (committed 11);
  - no kernel launched.

  Beside them, not held: the committed per-seed blocks
  (``results/exp_symreg_metrics.json``) and JAX-CPU at the script's keys
  (``scripts/symreg_spread.json``'s ``script``).

The card's name and power limit, the probe's times, and the run's
wall-clock, exit code, stage seconds, kernel launches and checks go to
``DIR/summary.json``, also the last line printed.
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

from chip_smoke import card_line  # noqa: E402
from conditional_ude_tpu_torch import symreg_pipeline as pipe  # noqa: E402
from conditional_ude_tpu_torch.analysis.symreg import (  # noqa: E402
    TorchDraws,
    fit_symbolic,
)

COMMITTED = json.loads((REPO / "results" / "exp_symreg_metrics.json")
                       .read_text())
SPREAD_FILE = REPO / "scripts" / "symreg_spread.json"
BEST_FACTOR = 1.5
PARETO_SIZE = (6, 16)


def stderr_record(log: Path, key: str):
    """The last JSON object on ``log`` whose only key is ``key``."""
    found = None
    for line in log.read_text().splitlines():
        if line.startswith("{" + json.dumps(key)):
            found = json.loads(line)[key]
    return found


def check(metrics: dict) -> dict:
    """Each limit: the value, the limit, and whether it holds."""
    ref = metrics["holdout"]["reference_equation_mse"]
    worst = max(b["best_holdout_mse"] for b in COMMITTED["seeds"])
    out = {}
    for b in metrics["seeds"]:
        s = b["search_seed"]
        out[f"seed {s} best_holdout_mse < reference"] = {
            "value": b["best_holdout_mse"], "limit": ref,
            "ok": b["best_holdout_mse"] is not None
            and b["best_holdout_mse"] < ref}
        out[f"seed {s} n_inv_family_rows >= 1"] = {
            "value": b["n_inv_family_rows"], "limit": 1,
            "ok": b["n_inv_family_rows"] >= 1}
    best = metrics["holdout"]["best_discovered_mse"]
    out["best_discovered_mse <= 1.5 x committed worst seed"] = {
        "value": best, "limit": BEST_FACTOR * worst,
        "ok": best is not None and best <= BEST_FACTOR * worst}
    out["pareto_size in 6-16"] = {
        "value": metrics["pareto_size"], "limit": list(PARETO_SIZE),
        "ok": PARETO_SIZE[0] <= metrics["pareto_size"] <= PARETO_SIZE[1]}
    return out


def probe(seed: int = 270523) -> dict:
    """Each configuration's phase times on the card, one run each."""
    import torch

    dev = torch.device("cuda")
    x, y = pipe.load_production(REPO / "artifacts")
    _, fit = pipe.holdout_split(len(y), seed)
    out = {}
    for i, (cfg, _) in enumerate(pipe.FULL):
        t, t0 = {}, time.perf_counter()
        fit_symbolic(x[fit], y[fit], TorchDraws(seed + i, dev), dev, cfg,
                     timings=t)
        total = time.perf_counter() - t0
        blocks = -(-cfg.generations // cfg.block_gens)
        out[f"depth {cfg.depth} x {cfg.population}"] = {
            "run_s": total,
            "ms_a_generation": 1e3 * t["generations"] / cfg.generations,
            "const_opt_s_a_block": t["const_opt"] / blocks,
            "rest_s": total - t["generations"] - t["const_opt"]}
    return out


def count(device: str, pop: int = 256) -> dict:
    """aten calls a generation and a constant step at each depth."""
    import dataclasses

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    x, y = pipe.load_production(REPO / "artifacts")
    out = {}
    for cfg, _ in pipe.FULL:
        n = {}
        for steps in (80, 0):
            c = dataclasses.replace(cfg, population=pop, generations=20,
                                    const_opt_steps=steps)
            with Count() as counter:
                fit_symbolic(x, y, TorchDraws(0, device), device, c)
            n[steps] = counter.n
        out[f"depth {cfg.depth}"] = {"a_generation": n[0] / 20,
                                     "a_const_step": (n[80] - n[0]) / 80}
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=REPO / "build" / "symreg")
    p.add_argument("--only", nargs="+", default=["probe", "run"],
                   choices=["count", "probe", "run"])
    p.add_argument("--device", default="cuda", help="the count's device")
    p.add_argument("--search-seeds", type=int, default=3)
    p.add_argument("--budget", type=float, default=None,
                   help="seconds the run may take")
    args = p.parse_args()
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    summary = {"card": card_line() if args.device != "cpu" else None}
    if "count" in args.only:
        summary["aten_calls"] = count(args.device)
        print(json.dumps({"aten_calls": summary["aten_calls"]}), flush=True)
    if "probe" in args.only:
        summary["probe"] = probe()
        print(json.dumps({"probe": summary["probe"]}), flush=True)
    if "run" in args.only:
        summary.update(run(out, args.search_seeds, args.budget))
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))


def run(out: Path, search_seeds: int, budget: float | None) -> dict:
    """The entry point's run under ``out/run``, its log and its checks."""
    run_dir, log = out / "run", out / "run.log"
    t0 = time.perf_counter()
    with log.open("w") as f:
        try:
            rc = subprocess.run(
                [sys.executable, "-m", "conditional_ude_tpu_torch",
                 "--experiment", "exp_symreg_search", "--search-seeds",
                 str(search_seeds), "--out", str(run_dir)], cwd=REPO,
                stdout=f, stderr=subprocess.STDOUT,
                timeout=budget).returncode
        except subprocess.TimeoutExpired:
            rc = None
    mpath = run_dir / "exp_symreg_metrics.json"
    metrics = json.loads(mpath.read_text()) if mpath.exists() else None
    summary = {"seconds": time.perf_counter() - t0,
               "rc": rc, "stage_seconds": stderr_record(log, "stage_seconds"),
               "launches": stderr_record(log, "launches"),
               "check": check(metrics) if metrics else None,
               "metrics": metrics,
               "committed_seeds": COMMITTED["seeds"],
               "jax_cpu_script_keys": (json.loads(SPREAD_FILE.read_text())
                                       .get("script")
                                       if SPREAD_FILE.exists() else None)}
    summary["ok"] = bool(rc == 0 and metrics and summary["launches"] == {}
                         and all(c["ok"] for c in summary["check"].values()))
    return summary


if __name__ == "__main__":
    main()
