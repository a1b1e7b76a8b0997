"""exp05: the less-data ablation (counterpart of
``experiments/exp05_less_data.py``, the reference's
``c-peptide/05-performance-less-data.jl``).

The cUDE is trained on fractions 0.1 … 1.0 of the 82 training subjects
(cohorts of 8, 16, 25, 33, 41, 49, 57, 66, 74 and 82) and each fraction's
selected network refit on the 35 test subjects, at several ablation seeds.
Ablation seed ``i`` uses ``seed = base + i`` for the subsets, the designs
and the generator:

* ``subsets``: one ``np.random.default_rng(seed)`` draws every fraction's
  stratified subset in fraction order; the 1.0 fraction draws nothing.  The
  order matters: any other gives other subjects from the second fraction on;
* ``train_fraction``: ``train_conditional`` on the subset, 10,000 designs
  and 10 restarts;
* ``select_and_refit``: the restart with the least validation objective on
  the held-out training subjects (500 L-BFGS steps; restart 0, the best by
  training objective, at 1.0, which holds nothing out), then its (β, σ) fit
  on the test subjects from β = −1 within the default bounds (1000 steps),
  the SSE back-converted from the σ-NLL, and the outliers (above 10× the
  median) counted apart;
* ``aggregate_ablation``: the across-seed median, IQR and mean of each
  fraction's test-SSE median, mean and inlier mean, and the outliers a
  fraction.

The port's one departure from the JAX experiment script: where no seed has
a finite value for a fraction, that fraction's statistics are ``None``
(``null`` in the JSON) with ``n_seeds`` 0, where the JAX experiment script
writes NaN and warns.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
from conditional_ude_tpu_torch.fit.train import (
    TrainConfig,
    TrainResult,
    evaluate_model,
    fit_betas_sigma,
    select_best,
    train_conditional,
)
from conditional_ude_tpu_torch.pipeline import EXP02, _cohort
from conditional_ude_tpu_torch.seeds import write_csv
from conditional_ude_tpu_torch.utils.stats import stratified_split

FRACTIONS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
CONFIG = TrainConfig(initial_guesses=10_000, selected_initials=10)
SELECT_ITERS, REFIT_ITERS = 500, 1000
# --smoke (experiments/exp05_less_data.py:62,69,118-127): two fractions,
# drawn in that order, one ablation seed, a small multi-start
SMOKE_FRACTIONS = (0.2, 0.6)
SMOKE_CONFIG = TrainConfig(initial_guesses=100, selected_initials=2,
                           adam_iters=20, lbfgs_iters=20)
SMOKE_STEPS = dict(select_iters=50, refit_iters=100)
ACROSS = (("test_sse_median_across_seeds", "test_sse_median"),
          ("test_sse_mean_across_seeds", "test_sse_mean"),
          ("test_sse_inlier_mean_across_seeds", "test_sse_mean_inliers"))


def subsets(types: np.ndarray, seed: int, sweep=FRACTIONS
            ) -> dict[float, tuple[np.ndarray, np.ndarray]]:
    """``{fraction: (subset, held out)}`` indices into the training subjects
    for every fraction of the ``sweep``, drawn in that order from one
    generator of ``seed``
    (``experiments/exp05_less_data.py:40-43,129-137``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for frac in sweep:
        if frac >= 1.0:
            out[frac] = (np.arange(len(types)), np.zeros(0, np.int64))
        else:
            out[frac] = stratified_split(rng, types, frac)
    return out


def train_fraction(device: torch.device | str, train: OhashiSplit,
                   idx: np.ndarray, seed: int, config: TrainConfig = CONFIG,
                   designs=None) -> TrainResult:
    """``train_conditional`` on the training subjects ``idx``, its designs
    and generator from ``seed`` (or the ``designs`` given)."""
    dev = torch.device(device)
    return train_conditional(
        EXP02.model(), _cohort(train.subset(idx), dev), config,
        generator=torch.Generator(device=dev).manual_seed(seed), seed=seed,
        designs=designs)


def select_and_refit(trained: TrainResult, train: OhashiSplit,
                     idx_held: np.ndarray, test: OhashiSplit, *, seed_i: int,
                     fraction: float, select_iters: int = SELECT_ITERS,
                     refit_iters: int = REFIT_ITERS) -> dict:
    """The ablation row of one trained fraction (``:44-94`` without its
    ``seconds``): the selected restart, its test refit and its SSE
    statistics; on the trained candidates' device."""
    dev = trained.nn_params.device
    m = EXP02.model()
    if len(idx_held):
        objectives = evaluate_model(m, trained.nn_params, trained.betas,
                                    _cohort(train.subset(idx_held), dev),
                                    lbfgs_iters=select_iters)
        best = select_best(objectives)
    else:
        best = 0
    _, s, o = fit_betas_sigma(m, trained.nn_params[best], _cohort(test, dev),
                              initial_beta=-1.0, lbfgs_iters=refit_iters)
    o, s = o.cpu().numpy(), s.cpu().numpy()
    n_t = test.timepoints.shape[0]
    sse = (o - (n_t / 2) * np.log(s**2)) * (2 * s**2)
    finite = sse[np.isfinite(sse)]
    med = float(np.median(finite)) if finite.size else float("nan")
    # subjects above 10x the cohort median are counted apart, so that the
    # mean of the rest is interpretable
    out_mask = finite > 10.0 * max(med, 1e-12)
    return {
        "seed": seed_i,
        "fraction": fraction,
        "n_train": int(trained.betas.shape[1]),
        "selected_restart": int(best),
        "train_objective": float(trained.objectives[best]),
        "test_sse_mean": float(np.mean(finite)) if finite.size
        else float("nan"),
        "test_sse_mean_inliers": float(np.mean(finite[~out_mask]))
        if (~out_mask).any() else float("nan"),
        "test_sse_median": med,
        "n_outliers": int(out_mask.sum()),
        "n_nonfinite": int(np.sum(~np.isfinite(sse))),
    }


def run_ablation(device: torch.device | str, artifacts_dir: str | Path,
                 seed: int, n_seeds: int = 5,
                 fractions: tuple[float, ...] = FRACTIONS,
                 config: TrainConfig = CONFIG, sweep=FRACTIONS,
                 steps: dict | None = None) -> list[dict]:
    """The rows of ``n_seeds`` ablation seeds from ``seed`` at
    ``fractions``, each fraction's subset as a sweep over ``sweep`` draws
    it; ``steps`` (``select_iters``, ``refit_iters``) replaces
    ``select_and_refit``'s step counts."""
    train, test = load_npz(Path(artifacts_dir) / "ohashi.npz")
    rows = []
    for seed_i in range(n_seeds):
        s = seed + seed_i
        drawn = subsets(train.types, s, sweep)
        for frac in fractions:
            idx, held = drawn[frac]
            t0 = time.perf_counter()
            trained = train_fraction(device, train, idx, s, config)
            t1 = time.perf_counter()
            row = select_and_refit(trained, train, held, test, seed_i=seed_i,
                                   fraction=frac, **(steps or {}))
            t2 = time.perf_counter()
            row["seconds"] = round(t2 - t0, 1)
            # the row, and the stage times that its "seconds" sums
            print(json.dumps({**row, "train": t1 - t0, "select_refit": t2 - t1,
                              "train_timings": trained.timings}),
                  file=sys.stderr, flush=True)
            rows.append(row)
    return rows


def aggregate_ablation(rows: list[dict], fractions) -> dict:
    """``exp05_metrics.json`` of the ablation ``rows``
    (``experiments/exp05_less_data.py:139-168``); ``n_seeds`` is the number
    of ablation seeds in the rows."""

    def across_seeds(key):
        stats = {}
        for frac in fractions:
            vals = np.asarray([r[key] for r in rows
                               if r["fraction"] == frac], float)
            vals = vals[np.isfinite(vals)]
            if not vals.size:
                stats[str(frac)] = {"median": None, "iqr_lo": None,
                                    "iqr_hi": None, "mean": None,
                                    "n_seeds": 0}
                continue
            stats[str(frac)] = {
                "median": float(np.median(vals)),
                "iqr_lo": float(np.percentile(vals, 25)),
                "iqr_hi": float(np.percentile(vals, 75)),
                "mean": float(np.mean(vals)),
                "n_seeds": int(len(vals)),
            }
        return stats

    return {
        "fractions": list(fractions),
        "n_seeds": len({r["seed"] for r in rows}),
        **{name: across_seeds(key) for name, key in ACROSS},
        "outliers_total_by_fraction": {
            str(frac): int(sum(r["n_outliers"] for r in rows
                               if r["fraction"] == frac))
            for frac in fractions},
    }


def write_ablation(out: Path, rows: list[dict], fractions) -> dict:
    """``exp05_ablation.csv`` and ``exp05_metrics.json`` into ``out``;
    returns the metrics."""
    out = Path(out)
    write_csv(out / "exp05_ablation.csv", rows)
    metrics = aggregate_ablation(rows, fractions)
    (out / "exp05_metrics.json").write_text(json.dumps(metrics, indent=2))
    return metrics
