"""The Ohashi OGTT cohort (counterpart of ``conditional_ude_tpu/data/ohashi.py``).

``artifacts/ohashi.npz`` holds the prepared 82/35 train/test split (117
subjects: glucose in mmol/L, c-peptide in nmol/L on the 0-120 min grid, and
the clamp indices); :func:`load_npz` reads it.  :func:`load_ohashi` makes
that split from the raw CSV files (the ETL of experiment 00): it drops the
OGTT records with a missing value (120 → 117 subjects), joins the subject
information and the clamp indices by subject number, converts the units
(glucose × 0.0551 → mmol/L, c-peptide × 0.3311 → nmol/L) and splits 70/30
per type from a numpy seed.  :func:`load_clamp_insulin` reads the clamp
test's insulin curves.

The JAX package reads the files with pandas; this module reads them with
the ``csv`` module and numpy, and does what pandas does with them: the
separator ``;``, pandas' default strings for a missing value
(:data:`NA_STRINGS`), a column's type decided over all its rows (integers,
else floats, else strings), columns by position where the JAX package
takes them so, and the decimal comma of ``ohashi_clamp_blood.csv``.
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path

import numpy as np

from conditional_ude_tpu_torch.utils.stats import stratified_split

GLUCOSE_TO_MMOL_L = 0.0551
CPEPTIDE_TO_NMOL_L = 0.3311
TIMEPOINTS = np.array([0.0, 30.0, 60.0, 90.0, 120.0])
CLAMP_INSULIN_TIMEPOINTS = np.array([0.0, 5.0, 10.0, 15.0, 60.0, 75.0, 90.0])
SPLIT_SEED = 270523     # the reference's StableRNG(270523)
# pandas.read_csv's default missing-value strings
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


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


@dataclasses.dataclass
class Table:
    """A CSV file's header and rows of strings, each row as wide as the
    header (a short row is filled with missing values)."""

    header: list[str]
    rows: list[list[str]]
    decimal: str = "."

    def column(self, key: str | int) -> np.ndarray:
        """The column named ``key`` (or at position ``key``), typed as
        pandas types it over every row: int64 where each cell is an integer
        and none is missing, else float64 (NaN where missing), else an
        object array of strings (None where missing)."""
        j = key if isinstance(key, int) else self.header.index(key)
        cells = [r[j] for r in self.rows]
        missing = [c in NA_STRINGS for c in cells]
        if not any(missing):
            try:
                return np.array([int(c) for c in cells], dtype=np.int64)
            except ValueError:
                pass
        try:
            return np.array([np.nan if m else self._number(c)
                             for c, m in zip(cells, missing)])
        except ValueError:
            return np.array([None if m else c
                             for c, m in zip(cells, missing)], dtype=object)

    def _number(self, cell: str) -> float:
        if self.decimal != ".":
            if "." in cell:     # not a number where the decimal is a comma
                raise ValueError(cell)
            cell = cell.replace(self.decimal, ".")
        return float(cell)

    def complete(self) -> np.ndarray:
        """Rows in which no cell is missing (pandas' ``dropna()``)."""
        return np.array([not any(c in NA_STRINGS for c in r)
                         for r in self.rows], dtype=bool)


def read_table(path: str | Path, sep: str = ";",
               decimal: str = ".") -> Table:
    """The CSV file ``path``: its first line the header, blank lines
    skipped; a row wider than the header raises ``ValueError``."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        lines = [r for r in csv.reader(f, delimiter=sep) if r]
    if not lines:
        raise ValueError(f"{path}: no header")
    header, rows = lines[0], lines[1:]
    for i, r in enumerate(rows):
        if len(r) > len(header):
            raise ValueError(f"{path}: row {i + 2} has {len(r)} fields, the "
                             f"header {len(header)}")
        r.extend([""] * (len(header) - len(r)))
    return Table(header, rows, decimal)


def _keyed(table: Table, subject_numbers: np.ndarray) -> Table:
    """The rows of ``table`` in the order of ``subject_numbers``, joined by
    the column ``No``: a duplicated number raises ``ValueError`` and a
    missing one ``KeyError``, so metadata cannot be paired with OGTT rows
    by position."""
    numbers = table.column("No").tolist()
    if len(set(numbers)) != len(numbers):
        raise ValueError("duplicated 'No' values in a data CSV")
    where = {n: i for i, n in enumerate(numbers)}
    missing = [n for n in subject_numbers.tolist() if n not in where]
    if missing:
        raise KeyError(f"subject numbers {missing} not in the 'No' column")
    return Table(table.header,
                 [table.rows[where[n]] for n in subject_numbers.tolist()],
                 table.decimal)


def _floats(table: Table, keys, rows=None) -> np.ndarray:
    """The columns ``keys`` as float64, ``[N, len(keys)]``, of the rows
    ``rows`` (a mask or indices; all by default)."""
    rows = slice(None) if rows is None else rows
    return np.stack([table.column(k)[rows].astype(float) for k in keys],
                    axis=1)


def _complete_ogtt(csv_dir: Path) -> tuple[Table, np.ndarray, np.ndarray]:
    """The OGTT table, its complete rows and their subject numbers."""
    ogtt = read_table(csv_dir / "ohashi_OGTT.csv")
    keep = ogtt.complete()
    return ogtt, keep, ogtt.column("No")[keep]


def load_ohashi(csv_dir: str | Path, f_train: float = 0.70,
                seed: int = SPLIT_SEED) -> tuple[OhashiSplit, OhashiSplit]:
    """(train, test) splits from the raw CSV files in ``csv_dir``
    (``ohashi_OGTT.csv``, ``ohashi_subjectinfo.csv``,
    ``ohashi_clamp_indices.csv``)."""
    csv_dir = Path(csv_dir)
    ogtt, keep, subject_numbers = _complete_ogtt(csv_dir)
    info = _keyed(read_table(csv_dir / "ohashi_subjectinfo.csv"),
                  subject_numbers)
    clamp = _keyed(read_table(csv_dir / "ohashi_clamp_indices.csv"),
                   subject_numbers)
    # columns 2:6 are glucose, 12:16 c-peptide (1-based, as the reference)
    glucose = _floats(ogtt, range(1, 6), keep) * GLUCOSE_TO_MMOL_L
    cpeptide = _floats(ogtt, range(11, 16), keep) * CPEPTIDE_TO_NMOL_L
    first_phase, second_phase = _floats(
        clamp, ["incremental AUC IRI(10)", "incremental AUC IRI(10-90)"]).T
    full = OhashiSplit(
        glucose=glucose, cpeptide=cpeptide, timepoints=TIMEPOINTS.copy(),
        subject_numbers=subject_numbers,
        types=info.column("type").astype(str),
        ages=_floats(info, ["age"])[:, 0],
        body_weights=_floats(info, ["BW"])[:, 0],
        bmis=_floats(info, ["BMI"])[:, 0],
        disposition_indices=_floats(clamp, ["clamp PAI"])[:, 0],
        first_phase=first_phase, second_phase=second_phase,
        total_insulin=first_phase + second_phase,
        insulin_sensitivity=_floats(clamp, ["ISI(GIR/Glu/IRI)"])[:, 0])
    train_idx, test_idx = stratified_split(np.random.default_rng(seed),
                                           full.types, f_train)
    return full.subset(train_idx), full.subset(test_idx)


def load_clamp_insulin(csv_dir: str | Path
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The clamp test's insulin curves of the subjects ``load_ohashi``
    keeps: ``(timepoints[7], insulin[N, 7] mU/L, types[N])``, C-IRI at
    0/5/10/15/60/75/90 min from ``ohashi_clamp_blood.csv`` (decimal
    commas)."""
    csv_dir = Path(csv_dir)
    _, _, subject_numbers = _complete_ogtt(csv_dir)
    info = _keyed(read_table(csv_dir / "ohashi_subjectinfo.csv"),
                  subject_numbers)
    blood = _keyed(read_table(csv_dir / "ohashi_clamp_blood.csv",
                              decimal=","), subject_numbers)
    insulin = _floats(blood, [f"C-IRI({int(t)})"
                              for t in CLAMP_INSULIN_TIMEPOINTS])
    return (CLAMP_INSULIN_TIMEPOINTS.copy(), insulin,
            info.column("type").astype(str))


def save_npz(path: str | Path, train: OhashiSplit, test: OhashiSplit) -> None:
    """Both splits into one ``.npz``, the layout :func:`load_npz` reads."""
    np.savez(path, **{f"{tag}_{f.name}": getattr(split, f.name)
                      for tag, split in (("train", train), ("test", test))
                      for f in dataclasses.fields(OhashiSplit)})
