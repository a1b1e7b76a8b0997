"""PyTorch port: the λ sweep (``fit_suppression_sweep``) against the JAX
package on the CPU from its own designs, and exp_suppression end to end
(``suppression_pipeline.py``, ``--experiment exp_suppression``) at a tiny
configuration.

Tolerances: the sweep at the size of
``tests/test_suppression_recovery.py:54-82`` (3 λ, 48 designs, 2
restarts, 40 Adam steps): the same designs selected; after Adam the
objectives and loss traces rtol 1e-5 (measured 3e-7); after 5 L-BFGS steps
more, objectives rtol 2e-3 + atol 2e-3 and θ 5e-2, the JAX suite's own
sweep-against-single limits (measured 1.2e-4); each λ's rows equal to the
port's fit at that λ alone (rtol 1e-5).  Not at 40 L-BFGS steps: there the
float32 L-BFGS is chaotic.  JAX's own run from a start one ulp away moves
its objectives by up to 7 % there, and the port's differ from JAX's by up
to 16 %, growing from 1e-6 at the start through 1.2e-4 at 5 steps and
2e-3 at 10.

The pipeline: the JAX script's CSV columns, metrics keys and npz keys (read
from the committed files); the ``_<λ>`` partials and their ``--merge-fine``;
the three selection rules on a small fine grid, with NaN test ρ where the
network is flat (λ = 10); ``--out`` refusing the reference's directories.
"""

import csv
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.models import suppression as jsup
from conditional_ude_tpu_torch import __main__ as entry
from conditional_ude_tpu_torch import suppression_pipeline as pipe
from conditional_ude_tpu_torch.models import suppression as sup
from conditional_ude_tpu_torch.models.suppression import SuppressionFitConfig
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint

TP = np.linspace(0.0, 30.0, 8)
ART = "artifacts"
RESULTS = "results"
TINY = pipe.Sizes(train=(2, 1, 1, 1, 1, 1), valid=(1,) * 6, n_test=6,
                  valid_inits=8, test_inits=8, test_lambda=0.1,
                  lambdas=(0.0, 0.1),
                  fit=SuppressionFitConfig(initial_space=16, select_best_n=2,
                                           adam_iters=3, lbfgs_iters=3))


@pytest.fixture(scope="module")
def nets():
    return jsup.suppression_net(depth=5, width=3), sup.suppression_net()


SWEEP_CFG = dict(initial_space=48, select_best_n=2, adam_iters=40,
                 lbfgs_iters=5, screen_chunk=48)
SWEEP_LAMBDAS = [0.0, 0.01, 0.1]


@pytest.fixture(scope="module")
def sweep_case(nets):
    """``tests/test_suppression_recovery.py``'s sweep: JAX's result, its
    designs and its screen's top designs."""
    jnet = nets[0]
    rng = np.random.default_rng(3)
    data, _ = jsup.generate_data([0.5, 5.0, 12.5], [2] * 3, TP,
                                 noise_multiplicative=0.05, rng=rng)
    key = jax.random.key(11)
    k_nn, k_th = jax.random.split(key)
    nn0 = np.asarray(jnet.init_batch(k_nn, 48))
    th0 = np.asarray(jax.random.normal(k_th, (48, data.shape[0])))
    res = {n: jsup.fit_suppression_sweep(
        jnet, data, TP, key, SWEEP_LAMBDAS,
        jsup.SuppressionFitConfig(**{**SWEEP_CFG, "lbfgs_iters": n}))
        for n in (0, SWEEP_CFG["lbfgs_iters"])}
    err = np.asarray(jax.vmap(lambda a, b: jsup.suppression_loss(
        jnet, a, b, data, TP, 0.0))(nn0, th0))
    pen = (nn0 ** 2).sum(1)
    top = [np.argsort(err + np.float32(lam) * pen, kind="stable")[:2]
           for lam in SWEEP_LAMBDAS]
    return data, (nn0, th0), res, top


def test_sweep_matches_jax_from_its_designs(nets, sweep_case):
    data, designs, jres, top = sweep_case
    adam = sup.fit_suppression_sweep(
        nets[1], data, TP, SWEEP_LAMBDAS,
        sup.SuppressionFitConfig(**{**SWEEP_CFG, "lbfgs_iters": 0}),
        designs=designs)
    np.testing.assert_allclose(adam.objectives, np.asarray(jres[0].objectives),
                               rtol=1e-5)
    np.testing.assert_allclose(adam.loss_traces,
                               np.asarray(jres[0].loss_traces), rtol=1e-5)
    cfg = sup.SuppressionFitConfig(**SWEEP_CFG)
    res = sup.fit_suppression_sweep(nets[1], data, TP, SWEEP_LAMBDAS, cfg,
                                    designs=designs)
    jres = jres[cfg.lbfgs_iters]
    assert res.nn_params.shape == (3, 2, 67)
    assert res.loss_traces.shape == (3, 2, 40)
    for li in range(3):
        assert sorted(res.designs[li].tolist()) == sorted(top[li].tolist())
    np.testing.assert_allclose(res.objectives, np.asarray(jres.objectives),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(res.thetas, np.asarray(jres.thetas),
                               rtol=5e-2, atol=5e-2)
    # each λ's rows are that λ's fit alone
    for li, lam in enumerate(SWEEP_LAMBDAS):
        one = sup.fit_suppression(nets[1], data, TP, lam, cfg,
                                  designs=designs)
        for got, want in zip(one, res):
            torch.testing.assert_close(got, want[li], rtol=1e-5, atol=1e-6)


def test_sweep_draws_its_designs_on_the_cpu(nets):
    """Without designs the sweep draws from the generator (the same
    generator seed, the same fit) and ties in the screen keep the design
    order."""
    data = np.random.default_rng(0).uniform(1, 2, (3, 3, 8)).astype(
        np.float32)
    cfg = sup.SuppressionFitConfig(initial_space=8, select_best_n=2,
                                   adam_iters=2, lbfgs_iters=2)
    a, b = (sup.fit_suppression_sweep(
        nets[1], data, TP, [0.0, 1.0], cfg,
        generator=torch.Generator().manual_seed(5)) for _ in range(2))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    nn, th = sup.initial_designs(nets[1], 8, 3,
                                 torch.Generator().manual_seed(5))
    same = (nn[:1].expand(8, -1).clone(), th[:1].expand(8, -1).clone())
    tied = sup.fit_suppression(nets[1], data, TP, 0.0, cfg, designs=same)
    assert sorted(tied.designs.tolist()) == [0, 1]


def committed_metrics():
    return json.loads(open(f"{RESULTS}/exp_suppression_metrics.json").read())


def header(path):
    with open(path) as f:
        return next(csv.reader(f))


def test_pipeline_writes_the_jax_outputs(tmp_path):
    run = pipe.run_exp_suppression("cpu", ART, out=tmp_path, sizes=TINY)
    want = committed_metrics()
    assert header(tmp_path / "suppression_sweep.csv") == header(
        f"{RESULTS}/suppression_sweep.csv")
    assert len(run.rows) == 2 * 2
    for lam in ("0.0", "0.1"):
        assert set(run.metrics[lam]) == set(want["0.01"])
        arrays, meta = load_checkpoint(tmp_path / f"suppression_lambda={lam}.npz")
        assert set(arrays) == set(np.load(f"{ART}/suppression_lambda=0.01.npz"))
        assert arrays["nn_params"].shape == (2, 67)
        assert meta == {"lambda": float(lam), "noise": 0.1}
    ts = run.metrics["test_stage"]
    assert set(ts) == set(want["test_stage"]) and ts["lambda"] == 0.1
    assert ts["n_test"] == 6
    written = json.loads((tmp_path / "exp_suppression_metrics.json")
                         .read_text())
    assert set(written) == {"0.0", "0.1", "test_stage", "stage_seconds"}
    assert set(written["stage_seconds"]) == {"data", "train", "validate",
                                             "test_stage"}
    assert "exp_suppression" in entry.EXPERIMENTS


def test_partials_and_test_only(tmp_path):
    run = pipe.run_exp_suppression("cpu", ART, out=tmp_path, sizes=TINY,
                                   lambdas=[0.1], no_test_stage=True)
    assert (tmp_path / "suppression_sweep_0.1.csv").exists()
    part = json.loads((tmp_path / "exp_suppression_metrics_0.1.json")
                      .read_text())
    assert set(part) == {"0.1", "stage_seconds"}
    assert "test_stage" not in run.metrics
    # --test-only: the committed artifact of the test λ, revalidated
    run = pipe.run_exp_suppression("cpu", ART, out=tmp_path, sizes=TINY,
                                   test_only=True)
    assert run.rows == [] and len(run.revalidated) == 25
    assert run.metrics["test_stage"]["lambda"] == 0.1
    assert 0 <= run.metrics["test_stage"]["selected_restart"] < 25


def write_partial(out, lam, restarts=2):
    rows = [{"lambda": lam, "restart": r, "correlation_train": 0.5,
             "loss_train": 1.0 + r, "correlation_valid": 0.4,
             "loss_valid": 2.0, "correlation_valid_nonoise": 0.3,
             "loss_valid_nonoise": 3.0} for r in reversed(range(restarts))]
    pipe.write_csv(out / f"suppression_sweep_{lam}.csv", rows)
    pipe.write_metrics(out / f"exp_suppression_metrics_{lam}.json",
                       {str(lam): {"best_correlation_train": lam,
                                   "best_correlation_valid": 0.4},
                        "stage_seconds": {"train": 1.0}})


def test_merge_fine(tmp_path):
    lams = pipe.fine_lambdas()
    assert len(lams) == 13 and 0.1 in lams and 0.01 in lams
    for lam in lams[:-1]:
        write_partial(tmp_path, lam)
    with pytest.raises(SystemExit):
        pipe.merge_fine_outputs(tmp_path)
    write_partial(tmp_path, lams[-1])
    pipe.write_metrics(tmp_path / "exp_suppression_metrics.json",
                       {"test_stage": {"spearman": 0.7}})
    entry.main(["--experiment", "exp_suppression", "--merge-fine", "--out",
                str(tmp_path)])
    rows = pipe.read_csv(tmp_path / "suppression_sweep_fine.csv")
    assert [(r["lambda"], r["restart"]) for r in rows] == [
        (lam, r) for lam in lams for r in range(2)]
    merged = json.loads((tmp_path / "exp_suppression_metrics_fine.json")
                        .read_text())
    assert set(merged) == {str(lam) for lam in lams} | {"test_stage"}
    assert merged["test_stage"] == {"spearman": 0.7}


def test_selection_sensitivity_rules(tmp_path):
    """Three λ's of the committed artifacts, four restarts each; the rules
    pick by validation loss, by validation ρ and by the sum of both ranks,
    and the flat λ = 10 network gives NaN test ρ."""
    results, artifacts = tmp_path / "results", tmp_path / "artifacts"
    results.mkdir()
    artifacts.mkdir()
    for path in Path(ART).resolve().glob("suppression_lambda=*"):
        (artifacts / path.name).symlink_to(path)
    loss = {0: 0.3, 1: 0.2, 2: 0.22, 3: 0.25}
    rho = {0: 0.9, 1: -0.8, 2: 0.89, 3: 0.5}
    rows = [{"lambda": lam, "restart": r, "correlation_train": 0.0,
             "loss_train": 0.0, "correlation_valid": rho[r],
             "loss_valid": loss[r], "correlation_valid_nonoise": 0.0,
             "loss_valid_nonoise": 0.0}
            for lam in (0.0, 0.01, 10.0) for r in range(4)]
    pipe.write_csv(results / "suppression_sweep_fine.csv", rows)
    out = tmp_path / "out"
    out.mkdir()
    run = pipe.run_exp_suppression("cpu", artifacts, out=out, sizes=TINY,
                                   selection_sensitivity=True)
    sens = pipe.read_csv(out / "suppression_selection_sensitivity.csv")
    assert [(r["lambda"], r["rule"], r["restart"]) for r in sens] == [
        (lam, rule, pick) for lam in (0.0, 0.01, 10.0)
        for rule, pick in zip(pipe.RULES, (1, 0, 2))]
    assert [math.isnan(r["test_rho"]) for r in sens] == [False] * 6 + [True] * 3
    block = run.metrics["selection_sensitivity"]
    assert block["rules"] == pipe.sensitivity_block(block["lambdas"],
                                                    sens)["rules"]
    assert all(v["n_degenerate_lambda"] == 1
               for v in block["rules"].values())


@pytest.mark.parametrize("where", [ART, RESULTS, f"{RESULTS}/sub"])
def test_out_refuses_the_reference(where):
    with pytest.raises(SystemExit):
        entry.main(["--experiment", "exp_suppression", "--device", "cpu",
                    "--out", where])
    with pytest.raises(SystemExit):
        entry.main(["--experiment", "exp_suppression", "--merge-fine",
                    "--out", where])
