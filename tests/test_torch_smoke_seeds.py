"""PyTorch port: exp02_seeds at ``--smoke`` through the entry point, seeds
11 and 22 then ``--merge``, against the JAX script's own smoke run of the
same seeds (``scripts/smoke_reference.json``; ``tests/smoke_runs.py``):
each seed trains exp02's smoke multi-start on the first 8 subjects of each
split (``experiments/exp02_seeds.py:74``), the records and the merge have
JAX's keys, and the merge's ``n_seeds`` and ``seeds`` are JAX's.
"""

import json

from torch_threads import one_thread  # noqa: F401

from smoke_runs import REFERENCE, reference, run_smoke, same_json
from conditional_ude_tpu_torch import __main__ as entry


def test_exp02_seeds_smoke_and_merge_match_jax(tmp_path, capsys):
    record = run_smoke("exp02_seeds", tmp_path, capsys, "--seeds", "11", "22")
    assert record["seed"] == 22 and record["ude_vs_cude"] is None
    smoke = tmp_path / "smoke"
    first = json.loads((smoke / "exp02_seed_11.json").read_text())
    assert reference.check("exp02_seeds", first,
                           REFERENCE["exp02_seeds"]) == []
    assert sorted(p.name for p in (smoke / "seeds").iterdir()) == [
        "cude_neural_parameters_11.json", "cude_neural_parameters_11.npz",
        "cude_neural_parameters_22.json", "cude_neural_parameters_22.npz"]
    entry.main(["--experiment", "exp02_seeds", "--merge", "--smoke",
                "--out", str(tmp_path)])
    merged = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert same_json(merged, json.loads(
        (smoke / "exp02_seeds_metrics.json").read_text()))
    assert reference.check("exp02_seeds_merge", merged,
                           REFERENCE["exp02_seeds_merge"]) == []
