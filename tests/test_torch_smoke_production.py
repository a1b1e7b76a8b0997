"""PyTorch port: exp_symreg_production and exp_advi at ``--smoke`` through
the entry point, against the JAX scripts' own smoke runs
(``scripts/smoke_reference.json``; ``tests/smoke_runs.py``).

* exp_symreg_production (named as the JAX script, ``--experiment
  exp_symreg_production``): 8 subjects of each Ohashi split and the 20 of
  Fujita, 100 L-BFGS steps, 200 profile points
  (``experiments/exp_symreg_production.py:52,62,82``); every metric is
  draw-free and held at ``tests/test_torch_symbolic.py``'s tolerances.
* exp_advi: a clean checkout has no smoke candidates, so the JAX script
  falls back to two Glorot networks at β = −1 on the 8 training subjects
  (``experiments/exp_advi.py:50-58``), 50 + 50 steps and a 200-point
  profile, and skips section 3; the port draws its two networks from a
  generator seeded 0.  Its keys are JAX's but the timers; ``n_restarts`` is
  the one draw-free value.  The stages on JAX's own draws are
  ``tests/test_torch_advi.py``'s.
"""

import json

import numpy as np
from torch_threads import one_thread  # noqa: F401

from smoke_runs import run_smoke
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint


def test_symreg_production_smoke_matches_jax(tmp_path, capsys):
    m = run_smoke("exp_symreg_production", tmp_path, capsys)
    assert m["fujita_external"]["n"] == 20
    fit, _ = load_checkpoint(tmp_path / "smoke" / "discovered_fit.npz")
    assert fit["bs"].shape == (16,) and fit["bs_fujita"].shape == (20,)


def test_exp_advi_smoke_takes_the_scripts_fallback(tmp_path, capsys):
    m = run_smoke("exp_advi", tmp_path, capsys)
    assert m["n_restarts"] == 2
    joint, meta = load_checkpoint(tmp_path / "smoke" /
                                  "advi_cude_results.npz")
    assert meta == {"script": "exp_advi", "restarts": 2, "steps": 50}
    assert joint["beta_mean"].shape == (2, 8)
    test, meta = load_checkpoint(tmp_path / "smoke" /
                                 "advi_test_posteriors.npz")
    assert meta == {"script": "exp_advi", "model_index": 0}
    assert test["beta_mean"].shape == (8,)
    assert np.isfinite(test["beta_mean"]).all()
    # the test stage reads exp02's selection where a smoke exp02 left it
    (tmp_path / "smoke" / "exp02_metrics.json").write_text(
        json.dumps({"best_model_index": 1}))
    run_smoke("exp_advi", tmp_path, capsys)
    assert load_checkpoint(tmp_path / "smoke" / "advi_test_posteriors.npz"
                           )[1]["model_index"] == 1
