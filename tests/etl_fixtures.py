"""Raw data files in the reference's layout, written from the committed
npz files, for the tests of the port's readers and ``chip_smoke.py``'s ETL
path (numpy and the port's data modules only: no JAX, no pandas).

``write_ohashi_csvs`` writes the four Ohashi files: the 117 subjects in
ascending subject number, in raw units (glucose ``round(g / 0.0551)``,
c-peptide ``round(c / 0.3311, 1)``, which multiply back to the npz bit for
bit; the JAX package's split of that order is the committed one), three
more OGTT records with a missing value that a reader must drop, the subject
information and the clamp indices in a shuffled order that includes those
three, and the clamp insulin with decimal commas and seeded values.
``write_fujita_csv`` writes the Fujita file, a glucose and a c-peptide row
a subject.
"""

import csv
from pathlib import Path

import numpy as np

from conditional_ude_tpu_torch.data import fujita, ohashi

ART = Path(__file__).resolve().parent.parent / "artifacts"
TIMES = (0, 30, 60, 90, 120)
INFO = ("type", "age", "BW", "BMI")
INFO_FIELDS = ("types", "ages", "body_weights", "bmis")
CLAMP = ("clamp PAI", "incremental AUC IRI(10)",
         "incremental AUC IRI(10-90)", "ISI(GIR/Glu/IRI)")
CLAMP_FIELDS = ("disposition_indices", "first_phase", "second_phase",
                "insulin_sensitivity")
# the three OGTT records the readers drop, each with one missing cell
INCOMPLETE = ("", "NA", "nan")


def _raw_glucose(g):
    return [str(int(v)) for v in np.round(g / ohashi.GLUCOSE_TO_MMOL_L)]


def _raw_cpeptide(c):
    return [repr(float(v)) for v in np.round(c / ohashi.CPEPTIDE_TO_NMOL_L,
                                             1)]


def write_table(path: Path, header, rows, sep=";"):
    with path.open("w", newline="") as f:
        w = csv.writer(f, delimiter=sep, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def write_ohashi_csvs(d: Path, seed: int = 0) -> Path:
    """The four Ohashi CSV files under ``d/ohashi_csv``, from
    ``artifacts/ohashi.npz``; returns that directory."""
    rng = np.random.default_rng(seed)
    train, test = ohashi.load_npz(ART / "ohashi.npz")
    both = ohashi.OhashiSplit.concatenate(train, test)
    order = np.argsort(both.subject_numbers)
    s = both.subset(order)
    gaps = sorted(set(range(1, s.subject_numbers.max() + 1))
                  - set(s.subject_numbers.tolist()))[:len(INCOMPLETE)]
    out = d / "ohashi_csv"
    out.mkdir(parents=True)
    header = (["No"] + [f"Glucose({t})" for t in TIMES]
              + [f"IRI({t})" for t in TIMES] + [f"CPR({t})" for t in TIMES])
    rows = []
    for i, no in enumerate(s.subject_numbers):
        iri = [repr(float(v)) for v in np.round(rng.uniform(2, 150, 5), 1)]
        rows.append([str(no)] + _raw_glucose(s.glucose[i]) + iri
                    + _raw_cpeptide(s.cpeptide[i]))
    extra = []
    for j, (no, na) in enumerate(zip(gaps, INCOMPLETE)):
        row = list(rows[j])
        row[0], row[1 + 5 * j + 2] = str(no), na
        extra.append(row)
    ogtt_rows = rows[:10] + extra[:1] + rows[10:60] + extra[1:] + rows[60:]
    write_table(out / "ohashi_OGTT.csv", header, ogtt_rows)

    numbers = list(s.subject_numbers) + list(gaps)
    shuffle = rng.permutation(len(numbers))

    def table(fields):
        # the three dropped subjects take the first subject's values
        cols = [getattr(s, f) for f in fields]
        return [[str(numbers[k])] + [fmt(c[k if k < len(c) else 0])
                                        for c in cols]
                for k in shuffle]

    def fmt(v):
        return v if isinstance(v, str) else repr(float(v))

    write_table(out / "ohashi_subjectinfo.csv", ["No", *INFO],
                table(INFO_FIELDS))
    write_table(out / "ohashi_clamp_indices.csv", ["No", *CLAMP],
                table(CLAMP_FIELDS))
    insulin = np.round(rng.uniform(1, 300, (len(numbers), 7)), 2)
    write_table(out / "ohashi_clamp_blood.csv",
                ["No"] + [f"C-IRI({int(t)})"
                          for t in ohashi.CLAMP_INSULIN_TIMEPOINTS],
                [[str(numbers[k])] + [fmt(v).replace(".", ",")
                                      for v in insulin[k]] for k in shuffle])
    return out


def write_fujita_csv(d: Path) -> Path:
    """``d/fujita_csv/fujita_ogtt.csv`` from ``artifacts/fujita.npz``: a
    glucose and a c-peptide row a subject; returns that directory."""
    f = fujita.load_fujita_npz(ART / "fujita.npz")
    out = d / "fujita_csv"
    out.mkdir(parents=True)
    rows = []
    for i in range(f.glucose.shape[0]):
        rows.append([f"F{i + 1}", "Glucose", *_raw_glucose(f.glucose[i]),
                     "mg/dL"])
        rows.append([f"F{i + 1}", "C-peptide", *_raw_cpeptide(f.cpeptide[i]),
                     "ng/mL"])
    write_table(out / "fujita_ogtt.csv",
                ["ID", "Molecule", *(str(int(t)) for t in f.timepoints),
                 "unit"], rows, sep=",")
    return out
