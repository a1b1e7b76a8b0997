"""PyTorch port: the raw-data readers (``data/ohashi.py``' ``load_ohashi``
and ``load_clamp_insulin``, ``data/fujita.py::load_fujita``) and exp00, the
ETL, against the JAX package's pandas readers and the committed
``artifacts/ohashi.npz``, ``artifacts/fujita.npz`` and
``results/exp00_metrics.json``, on raw files written from the committed
npz files (``tests/etl_fixtures.py``)."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from etl_fixtures import write_fujita_csv, write_ohashi_csvs, write_table
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.data import fujita as jfujita
from conditional_ude_tpu.data import ohashi as johashi
from conditional_ude_tpu_torch import __main__ as entry
from conditional_ude_tpu_torch import cli
from conditional_ude_tpu_torch import figures_pipeline as fp
from conditional_ude_tpu_torch.data import fujita, ohashi

REPO = Path(__file__).resolve().parent.parent
ART = REPO / "artifacts"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    write_ohashi_csvs(d)
    write_fujita_csv(d)
    return d


def _same(a, b, what):
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_splits(got, want):
    for tag, g, w in zip(("train", "test"), got, want):
        for f in dataclasses.fields(ohashi.OhashiSplit):
            _same(getattr(g, f.name), getattr(w, f.name), f"{tag} {f.name}")


def test_load_ohashi_equals_jax_and_the_committed_split(data_dir):
    port = ohashi.load_ohashi(data_dir / "ohashi_csv")
    _same_splits(port, johashi.load_ohashi(data_dir / "ohashi_csv"))
    _same_splits(port, ohashi.load_npz(ART / "ohashi.npz"))
    assert [len(s.ages) for s in port] == [82, 35]


@pytest.mark.parametrize("fault", ["duplicate", "missing"])
@pytest.mark.parametrize("package", ["jax", "port"])
def test_subject_join_refuses_a_bad_no(data_dir, tmp_path, fault, package):
    d = tmp_path / "ohashi_csv"
    d.mkdir()
    for p in (data_dir / "ohashi_csv").iterdir():
        (d / p.name).write_text(p.read_text())
    lines = (d / "ohashi_clamp_indices.csv").read_text().splitlines()
    if fault == "duplicate":
        lines.append(lines[1])
    else:
        ogtt = (d / "ohashi_OGTT.csv").read_text().splitlines()
        first = ogtt[1].split(";")[0]
        lines = [ln for ln in lines if ln.split(";")[0] != first]
    (d / "ohashi_clamp_indices.csv").write_text("\n".join(lines) + "\n")
    load = johashi.load_ohashi if package == "jax" else ohashi.load_ohashi
    with pytest.raises(ValueError if fault == "duplicate" else KeyError):
        load(d)


def test_load_clamp_insulin_equals_jax(data_dir):
    got = ohashi.load_clamp_insulin(data_dir / "ohashi_csv")
    want = johashi.load_clamp_insulin(data_dir / "ohashi_csv")
    for what, g, w in zip(("timepoints", "insulin", "types"), got, want):
        _same(g, w, what)
    assert got[1].shape == (117, 7)


def test_load_fujita_equals_jax_and_the_committed_cohort(data_dir):
    port = fujita.load_fujita(data_dir / "fujita_csv")
    for want in (jfujita.load_fujita(data_dir / "fujita_csv"),
                 fujita.load_fujita_npz(ART / "fujita.npz")):
        for f in dataclasses.fields(fujita.FujitaCohort):
            _same(getattr(port, f.name), getattr(want, f.name), f.name)


def test_read_table_types_and_drops_as_pandas(tmp_path):
    """pandas' missing-value strings, its column types and its decimal
    comma, against ``pandas.read_csv`` itself."""
    rows = [["1", "2", "x", "0,25", "1.5"], ["2", " 3", "y", "1,5", "2"]]
    rows += [[str(3 + i), "4", "z", "2,0", na]
             for i, na in enumerate(sorted(ohashi.NA_STRINGS))]
    rows.append(["99", "5", "", "3,75", "0.1"])
    rows.append(["100"])
    path = tmp_path / "t.csv"
    write_table(path, ["No", "a", "s", "c", "f"], rows)
    table = ohashi.read_table(path, decimal=",")
    df = pd.read_csv(path, sep=";", decimal=",")
    keep = table.complete()
    np.testing.assert_array_equal(keep, df.notna().all(axis=1).to_numpy())
    for j, name in enumerate(table.header):
        got, want = table.column(j), df[name].to_numpy()
        if want.dtype.kind in "if":
            _same(got, want, name)
        else:
            assert [v for v in got] == [None if pd.isna(v) else v
                                        for v in want], name
    _same(table.column("No")[keep], df.dropna()["No"].to_numpy(), "dropna")


def test_exp00_entry_reproduces_the_committed_outputs(data_dir, tmp_path,
                                                      capsys):
    entry.main(["--experiment", "exp00", "--data-dir", str(data_dir),
                "--out", str(tmp_path / "out")])
    out = tmp_path / "out"
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for name in ("ohashi.npz", "fujita.npz"):
        with np.load(out / name) as got, np.load(ART / name) as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                _same(got[k], want[k], f"{name} {k}")
    metrics = json.loads((out / "exp00_metrics.json").read_text())
    assert metrics == printed
    committed = json.loads((REPO / "results" / "exp00_metrics.json")
                           .read_text())
    got_p, want_p = (m.pop("age_mann_whitney_p") for m in (metrics,
                                                           committed))
    assert metrics == committed
    assert got_p.keys() == want_p.keys()
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=1e-12)


@pytest.mark.parametrize("where", ["artifacts", "results"])
def test_exp00_refuses_the_reference_directories(data_dir, where):
    with pytest.raises(SystemExit, match="reference"):
        entry.main(["--experiment", "exp00", "--data-dir", str(data_dir),
                    "--out", str(REPO / where / "etl")])
    assert not (REPO / where / "etl").exists()


@pytest.mark.parametrize("name, stem", [("00", "exp00_prepare_data"),
                                        ("_par", "exp_parity")])
def test_cli_resolves_the_etl_and_the_parity_check(name, stem):
    assert cli.resolve(name) == stem
    assert cli.EXPERIMENTS[stem][0] is not None


def test_cli_runs_exp00(data_dir, tmp_path, capsys):
    rc = cli.main(["exp", "00", "--data-dir", str(data_dir), "--out",
                   str(tmp_path)])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "n_subjects"] == 117
    assert (tmp_path / "ohashi.npz").exists()




def test_gallery_draws_the_clamp_insulin_from_the_raw_files(data_dir,
                                                            capsys):
    """exp_figures' data section: the clamp insulin from ``--data-dir``'s
    CSV files where they are, JAX's skip note where they are not."""
    g = fp.Gallery("cpu", ART, fp.RESULTS, fp.SMOKE, data_dir)
    got = fp.section_data(g)["clamp_insulin"]
    for a, b in zip(got, ohashi.load_clamp_insulin(data_dir / "ohashi_csv")):
        _same(a, b, "clamp insulin")
    assert "illustration_clamp_insulin.png" in [
        name for name, _ in fp.draw_data(fp.section_data(g))]
    g.data_dir = None
    assert fp.section_data(g)["clamp_insulin"] is None
    assert ("[skip] illustration_clamp_insulin.png: [Errno 2] No such file "
            "or directory") in capsys.readouterr().err
