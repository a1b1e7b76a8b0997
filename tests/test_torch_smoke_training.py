"""PyTorch port: exp02 and exp07 at ``--smoke`` through the entry point,
against the JAX scripts' own smoke runs (``scripts/smoke_reference.json``;
``tests/smoke_runs.py``).  A clean checkout has no smoke candidates, so
both train: the first 8 subjects of each split cut before the fit/
validation split, 200 designs, 4 restarts, 25 Adam and 25 L-BFGS steps,
then 50 L-BFGS steps of selection and 100 of refit, a 200-point test
profile and (exp02) a 100-point census, 50 band samples, and no UDE
comparison (``experiments/common.py:108-110,198,220``,
``experiments/exp02_conditional.py:45-47,72,94,151``,
``experiments/exp07_covariate.py:38,63``).  Their metrics come from the
port's draws, so the keys are held (exp07's ``spearman_age_note`` equal);
the cut and the step counts on JAX's own trained candidates are
``tests/test_torch_seeds.py``'s.
"""

from torch_threads import one_thread  # noqa: F401

from smoke_runs import run_smoke
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint


def test_exp02_smoke_matches_jax_keys(tmp_path, capsys):
    m = run_smoke("exp02", tmp_path, capsys)
    assert m["ude_vs_cude"] is None
    assert m["train_timings"]["screen_path"] == "plain"
    assert sum(m["identifiability_census_test"].values()) == 8
    assert sum(m["identifiability_census_all"].values()) == 16
    fit, meta = load_checkpoint(tmp_path / "smoke" / "cude_fit.npz")
    assert meta["script"] == "exp02"
    assert fit["profile_values"].shape == (8, 200)
    assert fit["delta_values"].shape == (16, 100)
    assert fit["beta_train"].shape == fit["beta_test"].shape == (8,)
    rows = (tmp_path / "smoke" / "ohashi_production.csv").read_text()
    assert len(rows.strip().splitlines()) == 901


def test_exp07_smoke_matches_jax_keys(tmp_path, capsys):
    m = run_smoke("exp07", tmp_path, capsys)
    assert sum(m["identifiability_census_test"].values()) == 8
    fit, meta = load_checkpoint(tmp_path / "smoke" /
                                "cude_covariate_fit.npz")
    assert meta["script"] == "exp07"
    assert fit["sse_test"].shape == (8,)
