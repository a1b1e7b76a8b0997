"""The symbolic-regression search end to end (counterpart of
``experiments/exp_symreg_search.py``): closed-form equations of the learned
network's production surface, held against the reference's published
rational equation on samples the search never saw.

1. The (β, ΔG) → production samples of ``ohashi_production.csv`` (900
   rows, exported by exp02), split by ``numpy.random.default_rng(seed)``
   into 180 held-out and 720 fit samples.
2. For each search seed s, the GP runs of each configuration (by default
   three at depth 4 × population 4096 and two at depth 5 × 2048, 300
   generations each; ``smoke``: one at depth 2 × 256 × 15) at the keys
   ``seed + 1000·s + run``; each run's draws come from ``draws(key)``
   (:class:`~conditional_ude_tpu_torch.analysis.symreg.TorchDraws` on the
   device unless given).  The runs' Pareto fronts merge into the seed's
   front, each row annotated with its holdout and full-set MSE.
3. All seeds' fronts merge into the final front; the metrics hold it beside
   the reference equation's holdout and fit MSE.

No kernel serves the search.  Outputs go only into ``out``, in the JAX
script's formats and file names.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import sys
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from conditional_ude_tpu_torch.analysis.symreg import (
    Draws,
    SymRegConfig,
    TorchDraws,
    evaluate,
    fit_symbolic,
    pareto_front,
)
from conditional_ude_tpu_torch.pipeline import SEED, _Stages

FULL = ((SymRegConfig(depth=4, population=4096, generations=300,
                      const_opt_steps=80, elite=64, max_size=18), 3),
        (SymRegConfig(depth=5, population=2048, generations=300,
                      const_opt_steps=80, elite=48, max_size=18), 2))
SMOKE = ((SymRegConfig(depth=2, population=256, generations=15,
                       const_opt_steps=10, max_size=18), 1),)


def load_production(artifacts_dir: str | Path) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """(x [N, 2] = (β, ΔG), y [N]) float32 from ``ohashi_production.csv``."""
    src = Path(artifacts_dir) / "ohashi_production.csv"
    if not src.exists():
        raise SystemExit(f"{src} not found: exp02 exports it "
                         "(python -m conditional_ude_tpu_torch --out DIR)")
    with src.open() as f:
        rows = list(csv.DictReader(f))
    x = np.array([[float(r["Beta"]), float(r["Glucose"])] for r in rows],
                 np.float32)
    y = np.array([float(r["Production"]) for r in rows], np.float32)
    return x, y


def holdout_split(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(held-out, fit) indices: the first fifth of
    ``default_rng(seed).permutation(n)`` is held out."""
    perm = np.random.default_rng(seed).permutation(n)
    n_hold = n // 5
    return perm[:n_hold], perm[n_hold:]


def reference_equation(xx: np.ndarray) -> np.ndarray:
    """The reference's published PySR complexity-16 equation,
    1.7802945·ΔG / (21.828821 + 166.73781·β³ + ΔG), in float32."""
    b, dg = xx[:, 0], xx[:, 1]
    return 1.7802945 * dg / (21.828821 + 166.73781 * b ** 3 + dg)


def merge_front(rows: list[dict]) -> list[dict]:
    """The best row of each complexity, kept where it beats every smaller
    complexity (the rows themselves, not copies)."""
    merged = {}
    for r in rows:
        c = r["complexity"]
        if c not in merged or r["loss"] < merged[c]["loss"]:
            merged[c] = r
    front, best = [], np.inf
    for c in sorted(merged):
        if merged[c]["loss"] < best:
            best = merged[c]["loss"]
            front.append(merged[c])
    return front


def eval_program(row: dict, xx: np.ndarray,
                 device: torch.device | str) -> np.ndarray:
    """A front row's program on ``xx``, float64; its depth from the length
    of its ops."""
    d = int(np.log2(len(row["ops"]) + 1)) - 1
    out = evaluate(torch.as_tensor(np.asarray(row["ops"]),
                                   device=device)[None],
                   torch.as_tensor(np.asarray(row["consts"]),
                                   device=device)[None],
                   torch.as_tensor(np.asarray(xx, np.float32),
                                   device=device), d)
    return out[0].cpu().numpy().astype(np.float64)


def annotate(front: list[dict], x: np.ndarray, y: np.ndarray,
             x_hold: np.ndarray, y_hold: np.ndarray,
             device: torch.device | str) -> list[dict]:
    """Each row's ``holdout_mse``, ``full_set_mse`` (all samples) and
    ``has_inv``, in place."""
    for row in front:
        row["holdout_mse"] = float(np.mean(
            (eval_program(row, x_hold, device) - y_hold) ** 2))
        row["full_set_mse"] = float(np.mean(
            (eval_program(row, x, device) - y) ** 2))
        row["has_inv"] = int("inv(" in row["equation"])
    return front


def seed_block(sseed: int, front: list[dict]) -> dict:
    """The metrics' block of one search seed."""
    inv = [r for r in front if r["has_inv"]]
    best = min(front, key=lambda r: r["holdout_mse"]) if front else None
    best_inv = min(inv, key=lambda r: r["holdout_mse"]) if inv else None
    return {
        "search_seed": sseed,
        "n_front_rows": len(front),
        "n_inv_family_rows": len(inv),
        "best_holdout_mse": best["holdout_mse"] if best else None,
        "best_equation": best["equation"] if best else None,
        "best_inv_family_holdout_mse": (best_inv["holdout_mse"]
                                        if best_inv else None),
        "best_inv_family_equation": (best_inv["equation"]
                                     if best_inv else None)}


def csv_rows(front: list[dict]) -> list[dict]:
    """Copies of the rows without their programs: the CSV's columns."""
    return [{k: v for k, v in r.items() if k not in ("ops", "consts")}
            for r in front]


def write_csv(path: Path, rows: list[dict]) -> None:
    if not rows:
        return
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


@dataclasses.dataclass
class SymRegSearchRun:
    metrics: dict                # the JAX script's keys and stage_seconds
    front: list[dict]            # the merged front, the CSV's columns
    runs: list[dict]             # each GP run: seed, run, depth, key, front
    seconds: dict


def run_exp_symreg_search(device: torch.device | str,
                          artifacts_dir: str | Path, seed: int = SEED,
                          search_seeds: int = 1, smoke: bool = False,
                          out: Path | None = None,
                          draws: Callable[[int], Draws] | None = None,
                          configs=None) -> SymRegSearchRun:
    """exp_symreg_search on ``device``: ``search_seeds`` seeds of the GP
    runs of ``configs`` (by default the script's: ``SMOKE`` with ``smoke``,
    else ``FULL``), each run's draws from ``draws(key)``.  With ``out`` the
    per-seed CSVs (``search_seeds`` > 1), ``symbolic_regression_result.csv``
    and ``exp_symreg_metrics.json`` are written there."""
    dev = torch.device(device)
    stage = _Stages(dev)
    if draws is None:
        def draws(key):
            return TorchDraws(key, dev)
    if configs is None:
        configs = SMOKE if smoke else FULL
    with stage("data"):
        x, y = load_production(artifacts_dir)
        hold, fit_idx = holdout_split(len(y), seed)
        x_fit, y_fit = x[fit_idx], y[fit_idx]
        x_hold, y_hold = x[hold], y[hold]
    print(f"{len(y)} samples", file=sys.stderr)

    rows_all, blocks, seed_fronts, runs = [], [], [], []
    for sseed in range(search_seeds):
        base = seed + 1000 * sseed
        rows_seed, run_idx = [], 0
        for cfg, n_runs in configs:
            for _ in range(n_runs):
                name = f"seed {sseed} run {run_idx}"
                with stage(name):
                    res = fit_symbolic(x_fit, y_fit, draws(base + run_idx),
                                       dev, cfg)
                    front_r = pareto_front(res, with_programs=True)
                best = (f"({front_r[-1]['complexity']}, "
                        f"{round(front_r[-1]['loss'], 6)})"
                        if front_r else "None")
                print(f"[seed {sseed} run {run_idx}] depth={cfg.depth} "
                      f"pop={cfg.population} {stage.seconds[name]:.0f}s "
                      f"best={best}", file=sys.stderr, flush=True)
                runs.append({"search_seed": sseed, "run": run_idx,
                             "depth": cfg.depth, "key": base + run_idx,
                             "front": front_r})
                rows_seed.append(front_r)
                run_idx += 1
        with stage(f"seed {sseed} annotate"):
            front_seed = annotate(merge_front(
                [r for fr in rows_seed for r in fr]), x, y, x_hold, y_hold,
                dev)
        blocks.append(seed_block(sseed, front_seed))
        seed_fronts.append(csv_rows(front_seed))
        rows_all.extend(r for fr in rows_seed for r in fr)
    for run in runs:
        annotate(run["front"], x, y, x_hold, y_hold, dev)

    front = csv_rows(annotate(merge_front(rows_all), x, y, x_hold, y_hold,
                              dev))
    ref_hold = float(np.mean((reference_equation(x_hold) - y_hold) ** 2))
    ref_fit = float(np.mean((reference_equation(x_fit) - y_fit) ** 2))
    inv_rows = [r for r in front if r["has_inv"]]
    best_inv = min(inv_rows, key=lambda r: r["holdout_mse"]) \
        if inv_rows else None
    best_any = min(front, key=lambda r: r["holdout_mse"]) if front else None
    metrics = {
        "best_loss": front[-1]["loss"] if front else None,
        "best_full_set_mse": front[-1]["full_set_mse"] if front else None,
        "best_equation": front[-1]["equation"] if front else None,
        "pareto_size": len(front),
        "max_complexity": front[-1]["complexity"] if front else None,
        "n_inv_family_rows": len(inv_rows),
        "seeds": blocks,
        "y_variance": float(np.var(y)),
        "holdout": {
            "n_fit": int(len(y_fit)), "n_holdout": int(len(y_hold)),
            "reference_equation_mse": ref_hold,
            "reference_equation_fit_mse": ref_fit,
            "best_discovered_mse": (best_any["holdout_mse"]
                                    if best_any else None),
            "best_discovered_equation": (best_any["equation"]
                                         if best_any else None),
            "best_inv_family_mse": (best_inv["holdout_mse"]
                                    if best_inv else None),
            "best_inv_family_equation": (best_inv["equation"]
                                         if best_inv else None)},
        "stage_seconds": dict(stage.seconds)}
    if out is not None:
        if search_seeds > 1:
            for sseed, rows in enumerate(seed_fronts):
                write_csv(out / f"symbolic_regression_result_seed{sseed}.csv",
                          rows)
        write_csv(out / "symbolic_regression_result.csv", front)
        (out / "exp_symreg_metrics.json").write_text(
            json.dumps(metrics, indent=2, default=float))
    return SymRegSearchRun(metrics, front, runs, dict(stage.seconds))
