"""PyTorch port: exp03 and exp04 at ``--smoke`` through the entry point
(``python -m conditional_ude_tpu_torch --experiment NAME --smoke``): 8
subjects of each Ohashi split (exp04: the first 4 Fujita subjects), 100
L-BFGS steps, 200 profile points, as the JAX scripts run them
(``experiments/exp03_symreg.py:39,49,66``,
``experiments/exp04_symreg_external.py:29,34,64``).  Every metric of both
is draw-free, so every one is held to the JAX script's own smoke run
(``scripts/smoke_reference.json``) at the fits' tolerances of
``tests/test_torch_symbolic.py`` (``tests/smoke_runs.py``); exp04's median
subject of 4 is a tie, which the packages break to different subjects.
"""

import numpy as np
from torch_threads import one_thread  # noqa: F401

from smoke_runs import run_smoke
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint


def test_exp03_smoke_matches_jax(tmp_path, capsys):
    m = run_smoke("exp03", tmp_path, capsys)
    assert sum(m["identifiability_census"].values()) == 16
    fit, meta = load_checkpoint(tmp_path / "smoke" / "symreg_fit.npz")
    assert meta == {"script": "exp03"}
    assert {k: v.shape for k, v in fit.items()} == {
        "ks": (16,), "sigmas": (16,), "objectives": (16,)}


def test_exp04_smoke_matches_jax(tmp_path, capsys):
    m = run_smoke("exp04", tmp_path, capsys)
    assert m["n_subjects"] == 4 and m["all_finite"]
    fit, _ = load_checkpoint(tmp_path / "smoke" / "symreg_external_fit.npz")
    assert fit["ks"].shape == (4,) and np.isfinite(fit["ks"]).all()
