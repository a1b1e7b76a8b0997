"""PyTorch port: exp02_xl and exp01 at ``--smoke`` through the entry point,
the replication runner's ``--smoke``, and the flags around ``--smoke``,
against the JAX scripts' own smoke runs (``scripts/smoke_reference.json``;
``tests/smoke_runs.py``).

* exp02_xl (named as the JAX script): 300 designs, 4 restarts, 25 + 25
  steps, 50 L-BFGS steps of selection, 100 of each refit, no profile
  (``experiments/exp02_xl.py:43-46,82``); ``config`` and
  ``selection_note`` are JAX's.
* exp01: 100 designs, 3 restarts, 20 + 20 steps on the mean curve of the
  first 8 training subjects (``experiments/exp01_non_conditional.py
  :52-54``); the reference weights' golden block is JAX's.
* ``python -m conditional_ude_tpu_torch.replicate --smoke``: each seed's
  child at ``--smoke``, the aggregate in ``DIR/smoke`` with JAX's keys
  (``experiments/exp_replicate.py:65-75,121``), a seed whose smoke metrics
  exist not run again.
"""

import json
import subprocess

import pytest
from torch_threads import one_thread  # noqa: F401

from smoke_runs import REFERENCE, reference, run_smoke
from conditional_ude_tpu_torch import __main__ as entry
from conditional_ude_tpu_torch import replicate
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint


def test_exp02_xl_smoke_matches_jax(tmp_path, capsys):
    m = run_smoke("exp02_xl", tmp_path, capsys)
    assert m["config"] == "300 inits, 4 restarts (0x reference screen)"
    assert 0 <= m["guarded_best_model_index"] < 2


def test_exp01_smoke_matches_jax(tmp_path, capsys):
    run_smoke("exp01", tmp_path, capsys)
    nn, meta = load_checkpoint(tmp_path / "smoke" /
                               "ude_neural_parameters.npz")
    assert nn["nn_params"].shape == (3, 33)
    assert meta["guesses"] == 100


def test_replicate_smoke_matches_jax(tmp_path, capsys):
    argv = ["--experiment", "exp01", "--seeds", "11", "22", "--out",
            str(tmp_path), "--smoke", "--", "--device", "cpu"]
    replicate.main(argv)
    out = json.loads((tmp_path / "smoke" / "replicate_exp01.json")
                     .read_text())
    assert reference.check("replicate", out, REFERENCE["replicate"]) == []
    for seed in (11, 22):
        assert (tmp_path / "seeds" / f"exp01_seed{seed}" / "smoke" /
                "exp01_metrics.json").exists()

    def no_child(*a, **k):
        raise AssertionError("a cached seed started a child")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(subprocess, "run", no_child)
        replicate.main(argv)


@pytest.mark.parametrize("argv", [
    ["--experiment", "exp00", "--smoke"],
    ["--experiment", "exp03", "--smoke", "--lbfgs-iters", "5"],
    ["--experiment", "exp_suppression", "--smoke", "--test-only"],
    ["--experiment", "exp07", "--smoke", "--xl"],
])
def test_smoke_refusals(argv, tmp_path):
    with pytest.raises(SystemExit) as e:
        entry.main([*argv, "--device", "cpu", "--out", str(tmp_path)])
    assert e.value.code not in (0, None)
    assert not (tmp_path / "smoke").exists()
