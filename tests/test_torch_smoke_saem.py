"""PyTorch port: exp06, exp06a and exp06b at ``--smoke`` through the entry
point, against the JAX scripts' own smoke runs
(``scripts/smoke_reference.json``; ``tests/smoke_runs.py``): 8 subjects of
each split, ``SAEMConfig(6, 3, 3)``, 100-step chains, 20-step MAPs and
MLEs; a clean checkout has no smoke pre-train, so exp06 trains it on 4
training subjects with ``TrainConfig(100, 2, 20, 20)``
(``experiments/exp06_saem.py:53-80,96,103``,
``experiments/exp06a_saem_symreg.py:51-66``,
``experiments/exp06b_saem_discovered.py:56-71``).  The metrics come from
draws, so their keys are held; the drivers on JAX's own draws at these
sizes are ``tests/test_torch_saem_pipeline.py``'s.
"""

import csv

from torch_threads import one_thread  # noqa: F401

from smoke_runs import run_smoke
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint


def test_exp06_smoke_matches_jax_keys(tmp_path, capsys):
    run_smoke("exp06", tmp_path, capsys)
    smoke = tmp_path / "smoke"
    pre, _ = load_checkpoint(smoke / "saem_pretrain.npz")
    assert pre["nn_params"].shape == (2, 37)
    fit, _ = load_checkpoint(smoke / "saem_fit.npz")
    assert fit["beta_map"].shape == (16,) and fit["nll_trace"].shape == (6,)
    assert fit["beta_chains"].shape == (16, 50)
    with (smoke / "neural_simulations.csv").open() as f:
        assert len(list(csv.DictReader(f))) == 600


def test_exp06a_smoke_matches_jax_keys(tmp_path, capsys):
    run_smoke("exp06a", tmp_path, capsys)


def test_exp06b_smoke_matches_jax_keys(tmp_path, capsys):
    run_smoke("exp06b", tmp_path, capsys)
