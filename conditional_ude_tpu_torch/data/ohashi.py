"""The Ohashi OGTT cohort from its committed ``.npz`` (counterpart of
``conditional_ude_tpu/data/ohashi.py:39,154``).

``artifacts/ohashi.npz`` holds the prepared 82/35 train/test split (117
subjects: glucose in mmol/L, c-peptide in nmol/L on the 0-120 min grid, and
the clamp indices).  Reading it needs numpy only.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class OhashiSplit:
    """One side of the train/test split (plain numpy)."""

    glucose: np.ndarray            # [N, 5] mmol/L
    cpeptide: np.ndarray           # [N, 5] nmol/L
    timepoints: np.ndarray         # [5]
    subject_numbers: np.ndarray    # [N]
    types: np.ndarray              # [N] str: NGT / IGT / T2DM
    ages: np.ndarray               # [N]
    body_weights: np.ndarray       # [N]
    bmis: np.ndarray               # [N]
    disposition_indices: np.ndarray
    first_phase: np.ndarray
    second_phase: np.ndarray
    total_insulin: np.ndarray
    insulin_sensitivity: np.ndarray

    @property
    def t2dm(self) -> np.ndarray:
        return self.types == "T2DM"

    def subset(self, idx) -> "OhashiSplit":
        idx = np.asarray(idx)
        return OhashiSplit(**{
            f.name: (getattr(self, f.name) if f.name == "timepoints"
                     else getattr(self, f.name)[idx])
            for f in dataclasses.fields(self)})

    @staticmethod
    def concatenate(a: "OhashiSplit", b: "OhashiSplit") -> "OhashiSplit":
        """Both splits as one cohort (they share the time grid)."""
        if not np.array_equal(a.timepoints, b.timepoints):
            raise ValueError("splits have different time grids")
        return OhashiSplit(**{
            f.name: (a.timepoints if f.name == "timepoints" else
                     np.concatenate([getattr(a, f.name), getattr(b, f.name)]))
            for f in dataclasses.fields(OhashiSplit)})


def load_npz(path: str | Path) -> tuple[OhashiSplit, OhashiSplit]:
    """(train, test) splits from an ``.npz`` written by the JAX package's
    ``save_npz``."""
    with np.load(path, allow_pickle=False) as data:
        out = []
        for tag in ("train", "test"):
            kw = {f.name: data[f"{tag}_{f.name}"]
                  for f in dataclasses.fields(OhashiSplit)}
            kw["types"] = kw["types"].astype(str)
            out.append(OhashiSplit(**kw))
    return out[0], out[1]
