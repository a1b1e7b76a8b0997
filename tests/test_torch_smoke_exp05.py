"""PyTorch port: exp05 at ``--smoke`` through the entry point, against the
JAX script's own smoke run (``scripts/smoke_reference.json``;
``tests/smoke_runs.py``): the whole cohorts, fractions 0.2 and 0.6 drawn
in that order from the seed's generator, one ablation seed, 100 designs, 2
restarts, 20 + 20 steps, 50 L-BFGS steps of selection and 100 of the test
refit (``experiments/exp05_less_data.py:62,69,113-127``).  The subsets are
JAX's exactly; one fraction's halves on JAX's draws and trained
candidates are ``tests/test_torch_exp05.py``'s.
"""

import csv

import numpy as np
from torch_threads import one_thread  # noqa: F401

from smoke_runs import REPO, run_smoke
from conditional_ude_tpu.utils.stats import stratified_split as jax_split
from conditional_ude_tpu_torch import ablation
from conditional_ude_tpu_torch.data.ohashi import load_npz


def test_smoke_subsets_are_jax_draws_in_smoke_order():
    train, _ = load_npz(REPO / "artifacts" / "ohashi.npz")
    drawn = ablation.subsets(train.types, 270523, ablation.SMOKE_FRACTIONS)
    rng = np.random.default_rng(270523)
    for frac in ablation.SMOKE_FRACTIONS:
        want, held = jax_split(rng, train.types, frac)
        np.testing.assert_array_equal(drawn[frac][0], want)
        np.testing.assert_array_equal(drawn[frac][1], held)
    # the full sweep draws 0.1 first, so its 0.2 subset is another
    assert not np.array_equal(drawn[0.2][0],
                              ablation.subsets(train.types, 270523)[0.2][0])


def test_exp05_smoke_matches_jax(tmp_path, capsys):
    m = run_smoke("exp05", tmp_path, capsys)
    assert m["fractions"] == [0.2, 0.6] and m["n_seeds"] == 1
    with (tmp_path / "smoke" / "exp05_ablation.csv").open() as f:
        rows = list(csv.DictReader(f))
    assert [(r["fraction"], r["n_train"]) for r in rows] == [
        ("0.2", "16"), ("0.6", "49")]
