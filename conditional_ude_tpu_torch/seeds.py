"""exp02_seeds: the retrain path of exp02 at several seeds, and the merge of
their records into across-seed statistics (counterpart of
``experiments/exp02_seeds.py``).

A seed draws both the fit/validation split of the training subjects and the
training designs.  Each seed runs ``pipeline.run_training_pipeline`` with no
profile scans (the JAX experiment script runs none); its record has that
script's keys and nesting (``results/exp02_seed_<s>.json``), its Spearman
correlations taken on the oriented β, and ``ude_vs_cude`` against exp01's
committed UDE on the test subjects.  ``merge_seeds`` aggregates records as
the script's ``--merge`` does: mean, sd (ddof 1; 0.0 for one seed), min and
max of each metric of ``AGGREGATED``, and one CSV row a seed.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import numpy as np

from conditional_ude_tpu_torch.pipeline import PipelineResult, sse_per_type

DEFAULT_SEEDS = (11, 22, 33, 44, 55)

# scalar metrics aggregated across seeds (dotted = nested lookup)
AGGREGATED = (
    "objective_best", "train_sse_mean", "test_sse_mean", "test_sse_median",
    "spearman.first_phase", "spearman.age", "spearman.insulin_sensitivity",
    "spearman_aligned.first_phase", "spearman_aligned.age",
    "spearman_aligned.insulin_sensitivity",
    "ude_vs_cude.test_mse_cude_mean", "ude_vs_cude.cude_better_fraction",
    "train_seconds",
)
STAGES = ("screen", "adam", "lbfgs", "final_eval")


def seed_record(result: PipelineResult, seed: int) -> dict:
    """The per-seed record of a retrain path's ``result``
    (``experiments/exp02_seeds.py:61-131``)."""
    return {
        "seed": seed,
        "train_seconds": float(result.seconds["train"]),
        "best_model_index": int(result.best),
        "objective_best": float(result.objective_best),
        "train_sse_per_type": sse_per_type(result.types_train,
                                           result.sse_train),
        "test_sse_per_type": sse_per_type(result.types_test, result.sse_test),
        "train_sse_mean": float(result.sse_train.mean()),
        "test_sse_mean": float(result.sse_test.mean()),
        "test_sse_median": float(np.median(result.sse_test)),
        "beta_bounds": [float(b) for b in result.bounds],
        "spearman": dict(result.spearman),
        "library_orientation": float(result.orientation),
        "ude_vs_cude": result.ude_vs_cude,
    }


def training_checkpoint(result: PipelineResult) -> tuple[dict, dict]:
    """``(arrays, metadata)`` of a retrain path's candidates in the JAX
    experiment scripts' checkpoint format
    (``experiments/common.py:164-190``)."""
    tr = result.training
    timings = tr.timings
    return ({"nn_params": tr.nn_params, "betas": tr.betas,
             "objectives": tr.objectives, "idx_fit": result.idx_fit,
             "orientations": tr.orientations,
             "seconds": np.asarray(result.seconds["train"]),
             "stage_seconds": np.asarray([timings[k] for k in STAGES],
                                         np.float64),
             "screen_path": np.asarray(timings["screen_path"]),
             "refine_path": np.asarray(timings["refine_path"])},
            {"kind": "conditional", "input_dims": 2,
             "guesses": tr.screen_losses.numel(),
             "restarts": tr.nn_params.shape[0]})


def _lookup(record: dict, dotted: str):
    cur = record
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def merge_seeds(rows: list[dict]) -> tuple[dict, list[dict]]:
    """The across-seed summary and the CSV rows of per-seed records
    (``experiments/exp02_seeds.py:134-186``).

    ``spearman_aligned`` flips a seed's correlations so that its first-phase
    ρ is negative (``beta_orientation``, −1 or 1): on the oriented β that
    the records carry it should be 1.0 for every seed.
    """
    aligned = []
    for r in rows:
        s = -1.0 if r["spearman"]["first_phase"] > 0 else 1.0
        aligned.append({**r, "beta_orientation": s, "spearman_aligned": {
            k: s * v for k, v in r["spearman"].items()}})
    summary: dict = {"n_seeds": len(aligned),
                     "seeds": [r["seed"] for r in aligned],
                     "beta_orientations": [r["beta_orientation"]
                                           for r in aligned]}
    for key in AGGREGATED:
        vals = [v for v in (_lookup(r, key) for r in aligned) if v is not None]
        if not vals:
            continue
        a = np.asarray(vals, float)
        summary[key] = {"mean": float(a.mean()),
                        "sd": float(a.std(ddof=1)) if len(a) > 1 else 0.0,
                        "min": float(a.min()), "max": float(a.max())}
    table = [{
        "seed": r["seed"],
        "train_seconds": r["train_seconds"],
        "objective_best": r["objective_best"],
        "train_sse_mean": r["train_sse_mean"],
        "test_sse_mean": r["test_sse_mean"],
        "test_sse_median": r["test_sse_median"],
        "spearman_first_phase": r["spearman"]["first_phase"],
        "spearman_age": r["spearman"]["age"],
        "spearman_isi": r["spearman"]["insulin_sensitivity"],
        "cude_better_fraction":
            (r["ude_vs_cude"] or {}).get("cude_better_fraction", ""),
    } for r in aligned]
    return summary, table


def seed_path(out: Path, seed: int) -> Path:
    return Path(out) / f"exp02_seed_{seed}.json"


def merge_directory(out: Path) -> dict:
    """Merge the ``exp02_seed_<s>.json`` records under ``out``, in the order
    of their seeds, into ``exp02_seeds_metrics.json`` and
    ``exp02_seeds.csv`` there; returns the summary."""
    out = Path(out)
    parts = sorted(out.glob("exp02_seed_*.json"),
                   key=lambda q: int(q.stem.rsplit("_", 1)[1]))
    if not parts:
        raise SystemExit(f"no exp02_seed_*.json under {out}: run "
                         "--experiment exp02_seeds --seeds ... first")
    summary, table = merge_seeds([json.loads(q.read_text()) for q in parts])
    (out / "exp02_seeds_metrics.json").write_text(json.dumps(summary,
                                                             indent=2))
    write_csv(out / "exp02_seeds.csv", table)
    return summary


def write_csv(path: Path, rows: list[dict]) -> None:
    """Rows of one dict each under the first row's keys (the JAX experiment
    scripts' ``write_csv``)."""
    if not rows:
        return
    with Path(path).open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
