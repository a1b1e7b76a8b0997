"""The Fujita external-validation cohort from its committed ``.npz``
(the cohort of ``conditional_ude_tpu/data/fujita.py:23-33``).

``artifacts/fujita.npz`` holds 20 subjects on 14 OGTT times (−10, 0, …,
240 min): glucose in mmol/L, c-peptide in nmol/L, ages (all 29).  Every
subject is non-diabetic.  Sampling starts 10 minutes before the glucose
load, so ΔG is measured from absolute t = 0, not from the first knot
(``models/cpeptide.py::CPeptideModel.vector_field``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class FujitaCohort:
    glucose: np.ndarray     # [N, 14] mmol/L
    cpeptide: np.ndarray    # [N, 14] nmol/L
    timepoints: np.ndarray  # [14]
    ages: np.ndarray        # [N], all 29

    @property
    def t2dm(self) -> np.ndarray:
        return np.zeros(len(self.ages), dtype=bool)


def load_fujita_npz(path: str | Path) -> FujitaCohort:
    """The cohort of ``path``; the file stores its tables column-major, so
    they are copied to rows."""
    with np.load(path, allow_pickle=False) as data:
        return FujitaCohort(**{f.name: np.ascontiguousarray(data[f.name])
                               for f in dataclasses.fields(FujitaCohort)})
