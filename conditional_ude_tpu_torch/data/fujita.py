"""The Fujita external-validation cohort (counterpart of
``conditional_ude_tpu/data/fujita.py``).

``artifacts/fujita.npz`` holds 20 subjects on 14 OGTT times (−10, 0, …,
240 min): glucose in mmol/L, c-peptide in nmol/L, ages (all 29).  Every
subject is non-diabetic.  Sampling starts 10 minutes before the glucose
load, so ΔG is measured from absolute t = 0, not from the first knot
(``models/cpeptide.py::CPeptideModel.vector_field``).  :func:`load_fujita_npz`
reads that file; :func:`load_fujita` makes the cohort from the raw
``fujita_ogtt.csv`` (comma-separated, one row a subject and molecule, the
times as the columns between the first two and the last), read as
``data/ohashi.py`` reads a CSV file.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from conditional_ude_tpu_torch.data.ohashi import (
    CPEPTIDE_TO_NMOL_L,
    GLUCOSE_TO_MMOL_L,
    read_table,
)

FUJITA_AGE = 29.0


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


def load_fujita(csv_dir: str | Path) -> FujitaCohort:
    """The cohort of ``csv_dir/fujita_ogtt.csv``: the rows whose
    ``Molecule`` is ``Glucose`` and ``C-peptide``, in the file's order,
    converted to mmol/L and nmol/L."""
    table = read_table(Path(csv_dir) / "fujita_ogtt.csv", sep=",")
    time_cols = range(2, len(table.header) - 1)
    molecule = table.column("Molecule")
    values = np.stack([table.column(j) for j in time_cols], axis=1)
    glucose = values[molecule == "Glucose"].astype(float) * GLUCOSE_TO_MMOL_L
    cpeptide = values[molecule == "C-peptide"].astype(float) \
        * CPEPTIDE_TO_NMOL_L
    return FujitaCohort(
        glucose=glucose, cpeptide=cpeptide,
        timepoints=np.array([float(table.header[j]) for j in time_cols]),
        ages=np.full(glucose.shape[0], FUJITA_AGE))
