"""PyTorch port: the SAEM experiments (``saem_pipeline.py``: exp06, exp06a,
exp06b) at the JAX experiment scripts' ``--smoke`` sizes on the CPU, their
outputs in the JAX formats, and the entry points around them.  The
functions they call are held against JAX in ``tests/test_torch_saem.py``
and ``tests/test_torch_saem_symbolic.py``."""

import csv
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest

from conditional_ude_tpu_torch import __main__ as cli
from conditional_ude_tpu_torch import replicate, saem_pipeline

REPO = Path(__file__).resolve().parent.parent
ART = REPO / "artifacts"


def _snapshot():
    return sorted((str(p), p.stat().st_mtime_ns)
                  for d in ("artifacts", "results")
                  for p in (REPO / d).rglob("*"))


def _keys(d: dict, prefix: str = "") -> set[str]:
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}.")
    return out


def test_exp06_smoke_writes_the_jax_outputs(tmp_path):
    """The pre-train retrained at the smoke size, both Ω modes, and every
    output in the JAX experiment script's keys and formats."""
    before = _snapshot()
    run = saem_pipeline.run_exp06("cpu", ART, retrain=True, smoke=True)
    saem_pipeline.write_outputs(tmp_path, "exp06", run)
    committed = json.loads((REPO / "results" / "exp06_metrics.json")
                           .read_text())
    metrics = json.loads((tmp_path / "exp06_metrics.json").read_text())
    # the first 8 subjects of each split are all NGT: a per-type MSE has
    # the types present (experiments/common.py::per_type_mse)
    missing = _keys(committed) - _keys(metrics)
    assert _keys(metrics) <= _keys(committed)
    assert all(k.rsplit(".", 1)[0].endswith("mse_map_per_type")
               for k in missing)
    assert run.route == "plain_k4_k2"
    assert set(run.seconds) >= {"pretrain", "saem", "saem_consistent",
                                "posterior", "maps", "mles", "mse"}

    fit = np.load(tmp_path / "saem_fit.npz")
    ref = np.load(ART / "saem_fit.npz")
    assert set(fit) == set(ref)
    n = 16                                  # 8 training and 8 test subjects
    shapes = {"nn_params": (37,), "beta_map": (n,), "beta_mle": (n,),
              "beta_posterior_mean": (n,), "nll_trace": (6,),
              "acceptance_trace": (6,), "beta_chains": (n, 50)}
    for k, v in fit.items():
        assert v.shape == shapes.get(k, ()), k
        assert np.isfinite(v).all(), k
    assert json.loads((tmp_path / "saem_fit.json").read_text()) == {
        "script": "exp06"}
    pre = np.load(tmp_path / "saem_pretrain.npz")
    assert pre["nn_params"].shape == (2, 37)
    assert np.all(np.diff(pre["objectives"]) >= 0)

    with (tmp_path / "neural_simulations.csv").open() as f:
        rows = list(csv.DictReader(f))
    with (ART / "neural_simulations.csv").open() as f:
        assert list(csv.DictReader(f).fieldnames) == ["Beta", "Glucose",
                                                      "Production"]
    assert len(rows) == 20 * 30
    assert np.isfinite([float(r["Production"]) for r in rows]).all()
    assert _snapshot() == before


@pytest.mark.parametrize("name", ["exp06a", "exp06b"])
def test_lognormal_smoke_has_the_jax_keys(name):
    run = getattr(saem_pipeline, f"run_{name}")("cpu", ART, smoke=True)
    committed = json.loads((REPO / "results" / f"{name}_metrics.json")
                           .read_text())
    assert set(run.metrics) == set(committed)
    assert run.route == "plain" and run.fit is None
    assert np.isfinite(list(run.metrics.values())).all()


def test_cli_refuses_the_reference_directories(tmp_path):
    before = _snapshot()
    for out in ("artifacts", "results", "results/port"):
        with pytest.raises(SystemExit):
            cli.main(["--experiment", "exp06", "--device", "cpu", "--out",
                      out])
    with pytest.raises(SystemExit):
        cli.main(["--experiment", "exp06a", "--retrain", "--device", "cpu"])
    assert _snapshot() == before


def test_replicate_retrains_each_exp06_seed(tmp_path, monkeypatch):
    """With ``-- --retrain`` each seed's child retrains the pre-train in its
    own directory, as the JAX runner's empty artifacts directory makes it."""
    commands = []

    def child(cmd, **kwargs):
        commands.append(cmd)
        out = Path(cmd[cmd.index("--out") + 1])
        out.mkdir(parents=True)
        seed = float(cmd[cmd.index("--seed") + 1])
        (out / "exp06_metrics.json").write_text(json.dumps({"sigma": seed}))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", child)
    replicate.main(["--experiment", "exp06", "--seeds", "11", "22", "--out",
                    str(tmp_path), "--", "--retrain"])
    assert all(c.count("--retrain") == 1 for c in commands)
    assert [c[c.index("--seed") + 1] for c in commands] == ["11", "22"]
    out = json.loads((tmp_path / "replicate_exp06.json").read_text())
    assert out["aggregate"]["sigma"]["min"] == 11.0
