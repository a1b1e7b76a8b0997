"""PyTorch port: exp_symreg_search end to end (``symreg_pipeline.py``) held
against the JAX package's ``experiments/exp_symreg_search.py`` on the CPU.

The holdout split, the reference equation's MSEs and the sample variance
equal the committed ``results/exp_symreg_metrics.json``; ``merge_front``
and ``annotate`` are held on injected fronts; the ``--smoke`` search at
two search seeds on JAX's replayed draws (``JaxDraws`` of
``tests/test_torch_symreg.py``) gives the JAX script's own ``--smoke``
metrics and CSVs within rtol 1e-4 (equations and counts equal); and
``--smoke`` through the port's entry point on its own generator writes the
committed metrics' keys.
"""

import csv
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.analysis import symreg as jsr
from conditional_ude_tpu_torch import __main__ as entry
from conditional_ude_tpu_torch import symreg_pipeline as pipe

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_symreg import JaxDraws  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ARTIFACTS = REPO / "artifacts"
COMMITTED = json.loads((REPO / "results" / "exp_symreg_metrics.json")
                       .read_text())
CPU = torch.device("cpu")


def test_split_and_reference_equation_equal_committed():
    """The 180/720 split of ``default_rng(270523)``, the reference
    equation's holdout and fit MSE and the samples' variance: equal to the
    committed JAX metrics, the split to the script's own expression."""
    x, y = pipe.load_production(ARTIFACTS)
    assert x.shape == (900, 2) and (x[:, 1] == 0).sum() > 0
    hold, fit = pipe.holdout_split(len(y), 270523)
    perm = np.random.default_rng(270523).permutation(900)
    np.testing.assert_array_equal(hold, perm[:180])
    np.testing.assert_array_equal(fit, perm[180:])
    h = COMMITTED["holdout"]
    assert (len(fit), len(hold)) == (h["n_fit"], h["n_holdout"])
    assert float(np.mean((pipe.reference_equation(x[hold]) - y[hold]) ** 2)) \
        == h["reference_equation_mse"]
    assert float(np.mean((pipe.reference_equation(x[fit]) - y[fit]) ** 2)) \
        == h["reference_equation_fit_mse"]
    assert float(np.var(y)) == COMMITTED["y_variance"]


def _row(depth, assignments, loss, rng):
    m = jsr.n_nodes(depth)
    ops = np.full(m, jsr.PASS, np.int32)
    consts = rng.uniform(0.5, 3.0, m).astype(np.float32)
    for i, op in assignments.items():
        ops[i] = op
    return {"complexity": int(jsr.complexity_of(ops)), "loss": loss,
            "equation": jsr.to_string(ops, consts), "ops": ops,
            "consts": consts}


def test_merge_front_and_annotate_on_injected_fronts():
    """Two fronts with a shared complexity and a dominated row merge into
    the best row a complexity, kept where it beats every smaller one; the
    annotation equals the JAX script's expressions (``evaluate`` of the
    JAX package, float64 MSE), depth 2 and 3 rows alike."""
    rng = np.random.default_rng(2)
    a = [_row(2, {0: jsr.CONST}, 0.04, rng),
         _row(2, {0: jsr.MUL, 1: jsr.VAR1, 2: jsr.CONST}, 0.02, rng),
         _row(2, {0: jsr.DIV, 1: jsr.VAR1, 2: jsr.ADD, 5: jsr.VAR0,
                  6: jsr.CONST}, 0.01, rng)]
    b = [_row(3, {0: jsr.CONST}, 0.039, rng),
         _row(3, {0: jsr.ADD, 1: jsr.VAR0, 2: jsr.CONST}, 0.05, rng),
         _row(3, {0: jsr.DIV, 1: jsr.VAR1, 2: jsr.ADD, 5: jsr.MUL,
                  6: jsr.CONST, 11: jsr.VAR0, 12: jsr.VAR0}, 0.005, rng)]
    front = pipe.merge_front(a + b)
    assert [r["loss"] for r in front] == [0.039, 0.02, 0.01, 0.005]
    assert front[0] is b[0] and front[1] is a[1]

    x, y = pipe.load_production(ARTIFACTS)
    hold, fit = pipe.holdout_split(len(y), 270523)
    pipe.annotate(front, x, y, x[hold], y[hold], CPU)

    def jax_eval(row, xx):
        d = int(np.log2(len(row["ops"]) + 1)) - 1
        out = jsr.evaluate(jnp.asarray(row["ops"])[None],
                           jnp.asarray(row["consts"])[None],
                           jnp.asarray(xx, jnp.float32), d)
        return np.asarray(out[0], np.float64)

    for row in front:
        assert row["holdout_mse"] == float(np.mean(
            (jax_eval(row, x[hold]) - y[hold]) ** 2))
        assert row["full_set_mse"] == float(np.mean((jax_eval(row, x) - y)
                                                    ** 2))
        assert row["has_inv"] == int("inv(" in row["equation"])
    assert [r["has_inv"] for r in front] == [0, 0, 1, 1]
    block = pipe.seed_block(4, front)
    assert block["n_front_rows"] == 4 and block["n_inv_family_rows"] == 2
    assert block["best_holdout_mse"] == min(r["holdout_mse"] for r in front)
    assert pipe.csv_rows(front)[0] == {
        k: front[0][k] for k in ("complexity", "loss", "equation",
                                 "holdout_mse", "full_set_mse", "has_inv")}


def _read_csv(path):
    with path.open() as f:
        return list(csv.DictReader(f))


def _close(got, want, where):
    """Floats within rtol 1e-4, everything else equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-4), where
    else:
        assert got == want, where


def test_smoke_on_jax_draws_matches_jax_script(tmp_path):
    """``--smoke --search-seeds 2``: the port on JAX's replayed draws
    against ``python experiments/exp_symreg_search.py --smoke --cpu
    --search-seeds 2`` (results under a temporary directory): metrics,
    per-seed and merged CSVs within rtol 1e-4, strings and counts equal."""
    art, res = tmp_path / "artifacts", tmp_path / "results"
    (art / "smoke").mkdir(parents=True)
    shutil.copy(ARTIFACTS / "ohashi_production.csv", art / "smoke")
    proc = subprocess.run(
        [sys.executable, str(REPO / "experiments" / "exp_symreg_search.py"),
         "--smoke", "--cpu", "--search-seeds", "2", "--artifacts", str(art),
         "--results", str(res)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads((res / "smoke" / "exp_symreg_metrics.json")
                      .read_text())

    out = tmp_path / "port"
    out.mkdir()
    run = pipe.run_exp_symreg_search(
        CPU, ARTIFACTS, search_seeds=2, smoke=True, out=out,
        draws=lambda key: JaxDraws(jax.random.key(key)))
    got = json.loads((out / "exp_symreg_metrics.json").read_text())
    assert set(got.pop("stage_seconds")) == {
        "data", "seed 0 run 0", "seed 0 annotate", "seed 1 run 0",
        "seed 1 annotate"}
    _close(got, want, "metrics")
    for name in ("symbolic_regression_result.csv",
                 "symbolic_regression_result_seed0.csv",
                 "symbolic_regression_result_seed1.csv"):
        g, w = _read_csv(out / name), _read_csv(res / "smoke" / name)
        assert len(g) == len(w) > 0 and list(g[0]) == list(w[0])
        for gr, wr in zip(g, w):
            for k in wr:
                if k == "equation":
                    assert gr[k] == wr[k]
                else:
                    assert float(gr[k]) == pytest.approx(float(wr[k]),
                                                         rel=1e-4)
    assert [r["equation"] for r in run.front] == [
        r["equation"] for r in _read_csv(res / "smoke" /
                                         "symbolic_regression_result.csv")]


def test_smoke_through_entry_point_writes_committed_keys(tmp_path, capsys):
    """``--experiment exp_symreg_search --smoke --device cpu --out DIR`` on
    the port's own generator: the metrics' keys (and each block's) are the
    committed JSON's beside ``stage_seconds``, printed as written; the
    results directory is refused as ``--out``."""
    entry.main(["--experiment", "exp_symreg_search", "--smoke", "--device",
                "cpu", "--out", str(tmp_path)])
    out = tmp_path / "smoke"
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    written = json.loads((out / "exp_symreg_metrics.json").read_text())
    assert printed == written
    assert set(written) == set(COMMITTED) | {"stage_seconds"}
    assert set(written["holdout"]) == set(COMMITTED["holdout"])
    assert [set(b) for b in written["seeds"]] == [set(COMMITTED["seeds"][0])]
    assert written["holdout"]["reference_equation_mse"] \
        == COMMITTED["holdout"]["reference_equation_mse"]
    header = list(_read_csv(out / "symbolic_regression_result.csv")[0])
    assert header == list(_read_csv(REPO / "results" /
                                    "symbolic_regression_result.csv")[0])
    assert not (out / "symbolic_regression_result_seed0.csv").exists()
    with pytest.raises(SystemExit):
        entry.main(["--experiment", "exp_symreg_search", "--smoke",
                    "--device", "cpu", "--out", str(REPO / "results")])
    with pytest.raises(SystemExit):
        entry.main(["--experiment", "exp00", "--smoke", "--device", "cpu"])
