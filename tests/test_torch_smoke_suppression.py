"""PyTorch port: exp_suppression at ``--smoke`` through the entry point,
against the JAX script's own smoke run (``scripts/smoke_reference.json``;
``tests/smoke_runs.py``): training populations of 3, 1, 1, 1, 1, 2
subjects, validation of 2 a group, λ ∈ {0, 0.1},
``SuppressionFitConfig(50, 3, 30, 30)``, 50 validation and 64 test
candidates, the test stage at λ = 0.1 on 12 subjects
(``experiments/exp_suppression.py:131-157,247,274,281``).  The test
stage's λ and size are draw-free and JAX's; the fits on JAX's own designs
are ``tests/test_torch_suppression*.py``'s.
"""

import csv

from torch_threads import one_thread  # noqa: F401

from smoke_runs import run_smoke
from conditional_ude_tpu_torch import suppression_pipeline as sp
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint


def test_exp_suppression_smoke_matches_jax(tmp_path, capsys):
    m = run_smoke("exp_suppression", tmp_path, capsys)
    assert set(m) == {"0.0", "0.1", "test_stage", "stage_seconds"}
    smoke = tmp_path / "smoke"
    with (smoke / "suppression_sweep.csv").open() as f:
        rows = list(csv.DictReader(f))
    assert [(r["lambda"], r["restart"]) for r in rows] == [
        (lam, str(k)) for lam in ("0.0", "0.1") for k in range(3)]
    for lam in sp.SMOKE.lambdas:
        fit, meta = load_checkpoint(smoke / f"suppression_lambda={lam}.npz")
        assert meta == {"lambda": lam, "noise": 0.1}
        assert fit["thetas"].shape == (3, 9)
