"""Experiment 00, the ETL (counterpart of ``experiments/exp00_prepare_data.py``):
the raw Ohashi and Fujita CSV files into the two cohorts' ``.npz`` files
and ``exp00_metrics.json``, with the Mann-Whitney tests of the age
differences between the types.  It launches no kernel.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from conditional_ude_tpu_torch.data.fujita import FujitaCohort, load_fujita
from conditional_ude_tpu_torch.data.ohashi import (
    OhashiSplit,
    load_ohashi,
    save_npz,
)
from conditional_ude_tpu_torch.pipeline import TYPES
from conditional_ude_tpu_torch.utils.stats import mann_whitney_u


@dataclasses.dataclass
class EtlRun:
    train: OhashiSplit
    test: OhashiSplit
    fujita: FujitaCohort
    metrics: dict           # the JAX script's keys


def run_exp00(data_dir: str | Path) -> EtlRun:
    """Both cohorts from ``data_dir/ohashi_csv`` and ``data_dir/fujita_csv``,
    and the metrics."""
    data_dir = Path(data_dir)
    train, test = load_ohashi(data_dir / "ohashi_csv")
    fujita = load_fujita(data_dir / "fujita_csv")
    ages = np.concatenate([train.ages, test.ages])
    types = np.concatenate([train.types, test.types])
    metrics = {
        "n_subjects": len(train.ages) + len(test.ages),
        "n_train": len(train.ages),
        "n_test": len(test.ages),
        "train_type_counts": {t: int((train.types == t).sum())
                              for t in TYPES},
        "test_type_counts": {t: int((test.types == t).sum()) for t in TYPES},
        "age_mann_whitney_p": {
            f"{a}_vs_{b}": mann_whitney_u(ages[types == a], ages[types == b])
            for a, b in (("NGT", "IGT"), ("NGT", "T2DM"), ("IGT", "T2DM"))},
        "fujita_subjects": int(fujita.glucose.shape[0]),
        "fujita_timepoints": int(fujita.timepoints.shape[0]),
    }
    return EtlRun(train, test, fujita, metrics)


def write_outputs(out: Path, run: EtlRun) -> None:
    """``ohashi.npz``, ``fujita.npz`` and ``exp00_metrics.json`` into
    ``out``, in the JAX script's formats."""
    save_npz(out / "ohashi.npz", run.train, run.test)
    np.savez(out / "fujita.npz", **{
        f.name: getattr(run.fujita, f.name)
        for f in dataclasses.fields(FujitaCohort)})
    (out / "exp00_metrics.json").write_text(json.dumps(run.metrics,
                                                       indent=2))
