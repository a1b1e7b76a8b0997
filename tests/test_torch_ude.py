"""PyTorch port: the non-conditional UDE (experiment 01) against the JAX
package on the CPU: the ``"ude"`` and ``"analytic"`` heads, the solves,
``build_individual`` with a dense save grid, ``train_ude`` with the JAX
package's designs, the exp01 pipeline, and the reference's own UDE weights
against their DOP853 golden.

Tolerances: the productions rtol 1e-5; RK4 trajectories rtol 1e-5 and
Tsit5 rtol 2e-2 / atol 1e-3 (the JAX suite's own); ``train_ude`` at 64
designs, 3 restarts and 20 Adam steps: screen rtol 1e-5 and the same top
designs, Adam's parameters atol 1e-5 and objectives rtol 1e-4, with 20
L-BFGS steps added the best objective, and the L-BFGS stage from JAX's
Adam output, rtol 5e-2 (``tests/test_torch_train.py``'s limits for
``train_conditional``).  The golden
(``tests/golden/reference_parity_ude_golden.npz``: width 6, 61 weights,
DOP853 at rtol 1e-10) is held to the cUDE golden's limits
(``tests/test_torch_golden_parity.py``): RK4 at 8 substeps 5e-3, Tsit5 at
rtol 1e-6 5e-4, the SSE means within 1 %, and the float64 splits.  Tsit5 at
the default tolerances is held to the JAX suite's limit for this golden,
5e-2 (``tests/test_reference_parity.py``: these trajectories swing ~5
nmol/L), not the cUDE's 2.5e-2: in float32 it reaches 3.9e-2 on the test
split (float64 1.9e-2), and it equals JAX's own solve within the Tsit5
tolerance.

Run as a script, the file runs the JAX package's ``train_ude`` at full
width (10,000 designs, 10 restarts, 1000 Adam and 1000 L-BFGS steps) on the
mean training curve at the flagship's seed and 19 others, and prints, as
one JSON line, each run's best objective and its train and test MSE means
(Tsit5, the JAX default): the spread that the port's retrain on the card
is held to (~12 minutes).  With ``--port`` it runs the port's own retrain
(its designs from each seed) on the CPU instead, at the same seeds or at
the seeds given (~100 s a seed):

    python tests/test_torch_ude.py
    python tests/test_torch_ude.py --port [SEED ...]
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":      # pytest's conftest does both for the tests
    sys.path.insert(0, str(REPO))
    jax.config.update("jax_platforms", "cpu")

from conditional_ude_tpu.fit import train as jtrain  # noqa: E402
from conditional_ude_tpu.models import cpeptide as jcp  # noqa: E402
from conditional_ude_tpu.models import symbolic as jsym  # noqa: E402
from conditional_ude_tpu.nn import chain as jax_chain  # noqa: E402
from conditional_ude_tpu_torch import pipeline  # noqa: E402
from conditional_ude_tpu_torch.data.ohashi import load_npz  # noqa: E402
from conditional_ude_tpu_torch.fit.losses import sse as cp_sse  # noqa: E402
from conditional_ude_tpu_torch.fit.train import train_ude  # noqa: E402
from conditional_ude_tpu_torch.models import cpeptide as cp  # noqa: E402
from conditional_ude_tpu_torch.models import symbolic as sym  # noqa: E402
from conditional_ude_tpu_torch.nn import chain  # noqa: E402
from conditional_ude_tpu_torch.ops.interp import LinearInterp  # noqa: E402
from conditional_ude_tpu_torch.ops.lbfgs import lbfgs_minimize  # noqa: E402

ART = REPO / "artifacts"
GOLDEN = REPO / "tests" / "golden" / "reference_parity_ude_golden.npz"
SPREAD_SEEDS = (270523, *range(11, 210, 11))   # 19 + the flagship's
G, K, ITERS = 64, 3, 20
UDE = cp.CPeptideModel(chain(4, 2, input_dims=1), "ude")
JUDE = jcp.CPeptideModel(kind="ude", net=jax_chain(4, 2, "tanh",
                                                     input_dims=1))
TSIT5 = dict(rtol=2e-2, atol=1e-3)


def _jax_mean_individual(train):
    """exp01's mean training curve (``experiments/exp01_non_conditional.py
    :43-48``) and its c-peptide."""
    mean_c = train.cpeptide.mean(axis=0).astype(np.float32)
    ind = jcp.build_individual(train.glucose.mean(axis=0), train.timepoints,
                               float(train.ages.mean()), float(mean_c[0]),
                               False)
    return ind, mean_c


def _jax_mse(model, nn, split):
    cohort = jcp.build_cohort(split.glucose, split.timepoints,
                              split.cpeptide, split.ages, split.t2dm)
    res = jcp.simulate_cohort(model, jnp.asarray(nn),
                              jnp.zeros((cohort.n, 0), jnp.float32), cohort)
    return np.mean((np.asarray(res.ys[:, :, 0]) - split.cpeptide) ** 2,
                   axis=1)


def retrain_spread(seeds=SPREAD_SEEDS) -> dict:
    """JAX's exp01 retrain at full width at each seed."""
    train, test = load_npz(ART / "ohashi.npz")
    ind, mean_c = _jax_mean_individual(train)
    tp = jnp.asarray(train.timepoints, jnp.float32)
    runs = {}
    for seed in seeds:
        t0 = time.perf_counter()
        nn, objs, _ = jtrain.train_ude(JUDE, ind, tp, jnp.asarray(mean_c),
                                       jax.random.key(seed))
        nn = np.asarray(nn)
        runs[str(seed)] = {
            "objective_best": float(objs[0]),
            "train_mse_mean": float(_jax_mse(JUDE, nn[0], train).mean()),
            "test_mse_mean": float(_jax_mse(JUDE, nn[0], test).mean()),
            "seconds": time.perf_counter() - t0}
    return runs


@pytest.fixture(scope="module")
def splits():
    return load_npz(ART / "ohashi.npz")


@pytest.fixture(scope="module")
def ude_weights():
    return np.load(ART / "ude_neural_parameters.npz")["nn_params"]


def _both(split, n=6):
    s = split.subset(np.arange(n))
    args = (s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm)
    return s, cp.build_cohort(*args, device="cpu"), jcp.build_cohort(*args)


def _random_weights(net, n=None, seed=5):
    rng = np.random.default_rng(seed)
    shape = (net.num_params,) if n is None else (n, net.num_params)
    return rng.normal(0.0, 0.7, shape).astype(np.float32)


@pytest.mark.parametrize("head", ["ude", "symbolic", "discovered"])
def test_production_heads_match_jax(splits, head):
    """The heads' production along one subject's curve, ΔG from t = 0."""
    split = splits[0].subset([3])
    ind = jcp.build_individual(split.glucose[0], split.timepoints,
                               float(split.ages[0]),
                               float(split.cpeptide[0, 0]), False)
    ts = np.linspace(0.0, 120.0, 25, dtype=np.float32)
    glucose = LinearInterp(split.timepoints,
                           torch.as_tensor(split.glucose[0], dtype=torch.float32))
    dg = glucose(ts) - glucose(0.0)
    if head == "ude":
        nn = _random_weights(UDE.net)
        model, jmodel, params = UDE, JUDE, {"neural": jnp.asarray(nn)}
        lanes, nn = torch.zeros(25), torch.as_tensor(nn)
    else:
        theta = np.float32(37.5 if head == "symbolic" else 0.62)
        model = getattr(sym, f"{head}_model")()
        jmodel = getattr(jsym, f"{head}_model")()
        params = {"k" if head == "symbolic" else "b": jnp.asarray(theta)}
        lanes, nn = torch.full((25,), float(theta)), None
    out = model.production(nn, lanes)(dg).numpy()
    ref = np.asarray(jax.vmap(lambda t: jmodel.production(t, params, ind))(
        jnp.asarray(ts)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)
    assert np.abs(ref).max() > 1e-2


def test_symbolic_production_is_nan_at_zero():
    """No epsilon: ΔG = 0 and k = 0 give NaN in both packages."""
    out = sym.symbolic_production(torch.tensor([0.0, 1.0]), torch.tensor(0.0))
    ref = jsym.symbolic_production(jnp.array([0.0, 1.0]), jnp.array(0.0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert np.isnan(out.numpy()[0]) and out.numpy()[1] == np.float32(1.78)


@pytest.mark.parametrize("solver", ["rk4", "tsit5"])
@pytest.mark.parametrize("weights", ["committed", "random"])
def test_simulate_cohort_ude_matches_jax(splits, ude_weights, solver,
                                         weights):
    _, c, jc = _both(splits[1])
    nn = ude_weights[0] if weights == "committed" else _random_weights(
        UDE.net, seed=11)
    res = cp.simulate_cohort(UDE, torch.as_tensor(nn), None, c,
                             solver=solver, substeps=8)
    ref = jcp.simulate_cohort(JUDE, jnp.asarray(nn), jnp.zeros((c.n, 0)), jc,
                              solver=solver, substeps=8)
    np.testing.assert_array_equal(res.success.numpy(),
                                  np.asarray(ref.success))
    tol = dict(rtol=1e-5, atol=1e-6) if solver == "rk4" else TSIT5
    np.testing.assert_allclose(res.ys.numpy(), np.asarray(ref.ys), **tol)


def test_simulate_cohort_batched_networks(splits):
    """Networks ``[R, 1, P]`` against the cohort give ``[R, N]`` lanes, each
    the solve of its own network."""
    _, c, _ = _both(splits[1], 4)
    nn = torch.as_tensor(_random_weights(UDE.net, 3, seed=2))
    batched = cp.simulate_cohort(UDE, nn[:, None, :], None, c)
    assert batched.ys.shape == (3, 4, 5, 2)
    for r in range(3):
        one = cp.simulate_cohort(UDE, nn[r], None, c)
        torch.testing.assert_close(batched.ys[r], one.ys, rtol=1e-6,
                                   atol=1e-7)


def test_build_individual_and_dense_simulate(splits):
    """The mean training curve as a one-row cohort, c0 as given, and the
    2-minute grid of the sampled bands (61 points, RK4 at 4 substeps),
    for the UDE head and for the conditional head at 5 β's."""
    train = splits[0]
    mean_c = train.cpeptide.mean(axis=0).astype(np.float32)
    args = (train.glucose.mean(axis=0), train.timepoints,
            float(train.ages.mean()), float(mean_c[0]), True)
    ind = cp.build_individual(*args, "cpu")
    jind = jcp.build_individual(*args)
    assert ind.n == 1 and ind.cpeptide is None
    for name in ("k0", "k1", "k2", "c0"):
        np.testing.assert_allclose(getattr(ind, name).numpy()[0],
                                   np.asarray(getattr(jind, name)), rtol=1e-6)
    np.testing.assert_allclose(ind.u0.numpy()[0], np.asarray(jind.u0),
                               rtol=1e-6)
    dense = np.arange(0.0, 120.1, 2.0).astype(np.float32)
    assert dense.shape == (61,)
    kw = dict(solver="rk4", substeps=4)
    nn = _random_weights(UDE.net, seed=3)
    res = cp.simulate(UDE, torch.as_tensor(nn), None, ind, dense, **kw)
    ref = jcp.simulate(JUDE, {"neural": jnp.asarray(nn)}, jind,
                       jnp.asarray(dense), **kw)
    assert res.ys.shape == (61, 2)
    np.testing.assert_allclose(res.ys.numpy(), np.asarray(ref.ys), rtol=1e-5,
                               atol=1e-6)
    cnn = np.load(ART / "cude_neural_parameters.npz")["nn_params"][19]
    betas = np.linspace(-2.0, 0.0, 5).astype(np.float32)
    cmodel = cp.CPeptideModel(chain(4, 2))
    jcmodel = jcp.CPeptideModel(kind="conditional",
                                net=jax_chain(4, 2, "tanh", input_dims=2))
    res = cp.simulate(cmodel, torch.as_tensor(cnn), betas, ind, dense, **kw)
    ref = jax.vmap(lambda b: jcp.simulate(
        jcmodel, {"neural": jnp.asarray(cnn), "conditional": b}, jind,
        jnp.asarray(dense), **kw).ys)(jnp.asarray(betas))
    assert res.ys.shape == (5, 61, 2)
    np.testing.assert_allclose(res.ys.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def trainings(splits):
    """``train_ude`` in both packages on the mean training curve, the port
    fed the JAX package's designs: Adam alone, and Adam then L-BFGS."""
    train = splits[0]
    jind, mean_c = _jax_mean_individual(train)
    ind = cp.build_individual(train.glucose.mean(axis=0), train.timepoints,
                              float(train.ages.mean()), float(mean_c[0]),
                              False, "cpu")
    designs = np.asarray(JUDE.net.init_batch(jax.random.key(7), G))
    out = {}
    for lbfgs in (0, ITERS):
        kw = dict(initial_guesses=G, selected_initials=K, adam_iters=ITERS,
                  lbfgs_iters=lbfgs, screen_chunk=G)
        ref = jtrain.train_ude(JUDE, jind,
                               jnp.asarray(train.timepoints, jnp.float32),
                               jnp.asarray(mean_c), jax.random.key(7), **kw)
        port = train_ude(UDE, ind, mean_c, designs=designs, **kw)
        assert set(port.timings) == {"screen", "adam", "lbfgs"}
        out[lbfgs] = tuple(t.numpy() for t in port[:3]), tuple(
            np.asarray(a) for a in ref)
    return out


def test_train_ude_screen_and_selection(trainings):
    (_, _, screen), (_, _, ref) = trainings[0]
    assert screen.shape == (G,)
    np.testing.assert_array_equal(np.isfinite(screen), np.isfinite(ref))
    np.testing.assert_allclose(screen, ref, rtol=1e-5)
    top = np.argsort(np.where(np.isfinite(ref), ref, np.inf),
                     kind="stable")[:K]
    top_port = np.argsort(np.where(np.isfinite(screen), screen, np.inf),
                          kind="stable")[:K]
    np.testing.assert_array_equal(top_port, top)


def test_train_ude_adam_stage(trainings):
    (nn, objs, _), (jnn, jobjs, _) = trainings[0]
    assert nn.shape == (K, 33)
    np.testing.assert_allclose(objs, jobjs, rtol=1e-4)
    np.testing.assert_allclose(nn, jnn, atol=1e-5)


def test_train_ude_lbfgs_stage(trainings, splits):
    """End to end, the best restart within rtol 5e-2: Adam's differences
    of ~1e-5 grow through 20 L-BFGS steps on an objective near 2e-4, and
    the third restart ends 8 % apart.  The stage itself is held from JAX's
    Adam output: the port's L-BFGS there ends within rtol 5e-2 of JAX's."""
    (nn, objs, _), (_, jobjs, _) = trainings[ITERS]
    assert nn.shape == (K, 33) and np.isfinite(objs).all()
    assert (np.diff(objs) >= 0).all()
    np.testing.assert_allclose(objs[0], jobjs[0], rtol=5e-2)
    assert objs[0] < trainings[0][0][1][0]      # L-BFGS improved on Adam
    train = splits[0]
    mean_c = train.cpeptide.mean(axis=0).astype(np.float32)
    series = dataclasses.replace(
        cp.build_individual(train.glucose.mean(axis=0), train.timepoints,
                            float(train.ages.mean()), float(mean_c[0]),
                            False, "cpu"),
        cpeptide=torch.as_tensor(mean_c)[None])
    res = lbfgs_minimize(
        lambda x: cp_sse(UDE, x[:, None, :], None, series, substeps=8)[:, 0],
        torch.as_tensor(np.array(trainings[0][1][0])), max_iters=ITERS)
    np.testing.assert_allclose(np.sort(res.fval.numpy()), jobjs, rtol=5e-2)


def test_ude_pipeline_frozen_matches_jax(splits, ude_weights):
    """exp01 without --retrain: the committed network's MSE of every
    subject by Tsit5, against the JAX package's evaluation
    (``experiments/exp01_non_conditional.py:59-76``)."""
    res = pipeline.run_ude_pipeline("cpu", ART)
    for split, got in zip(splits, (res.mse_train, res.mse_test)):
        np.testing.assert_allclose(got, _jax_mse(JUDE, ude_weights[0], split),
                                   **TSIT5)
    metrics = res.metrics()
    committed = json.loads((REPO / "results"
                            / "exp01_metrics.json").read_text())
    assert set(committed) <= set(metrics)
    assert metrics["objective_best"] == committed["objective_best"]
    assert abs(metrics["test_mse_mean"] / committed["test_mse_mean"] - 1) \
        < 0.03


def test_ude_pipeline_retrain_reduced():
    """exp01 with --retrain at a reduced width: the designs from the seed,
    candidates best first, every subject evaluated."""
    res = pipeline.run_ude_pipeline("cpu", ART, retrain=True, seed=3,
                                    initial_guesses=32, selected_initials=2,
                                    adam_iters=5, lbfgs_iters=5)
    assert res.nn_params.shape == (2, 33)
    assert (np.diff(res.objectives) >= 0).all()
    assert res.mse_train.shape == (82,) and res.mse_test.shape == (35,)
    assert set(res.seconds) == {"train", "train_screen", "train_adam",
                                "train_lbfgs", "evaluate"}
    again = pipeline.run_ude_pipeline("cpu", ART, retrain=True, seed=3,
                                      initial_guesses=32, selected_initials=2,
                                      adam_iters=5, lbfgs_iters=5)
    torch.testing.assert_close(again.nn_params, res.nn_params, rtol=0,
                               atol=0)


# -- the reference's UDE weights against DOP853 --------------------------------

SOLVES = {"rk4, 8 substeps": (dict(solver="rk4", substeps=8), 5e-3),
          "tsit5, defaults": (dict(solver="tsit5"), 5e-2),
          "tsit5, rtol 1e-6": (dict(solver="tsit5", rtol=1e-6, atol=1e-9,
                                    max_steps=4096), 5e-4)}
CASTS = ("glucose", "cpeptide", "age", "k0", "k1", "k2", "c0")


@pytest.fixture(scope="module")
def golden(splits):
    g = np.load(GOLDEN)
    model = cp.CPeptideModel(chain(int(g["width"]), int(g["depth"]),
                                   input_dims=1), "ude")
    cohorts = {name: cp.build_cohort(s.glucose, s.timepoints, s.cpeptide,
                                     s.ages, s.t2dm, "cpu")
               for name, s in zip(("train", "test"), splits)}
    return g, model, cohorts


def _golden_solve(golden, name, kw, dtype=torch.float32):
    g, model, cohorts = golden
    cohort = cohorts[name]
    if dtype == torch.float64:
        cohort = dataclasses.replace(
            cohort, **{f: getattr(cohort, f).double() for f in CASTS})
    res = cp.simulate_cohort(model, torch.as_tensor(g["nn"], dtype=dtype),
                             None, cohort, **kw)
    assert bool(res.success.all())
    return res.ys[:, :, 0], cohort


def test_golden_is_the_committed_cohort(golden, splits):
    g, model, _ = golden
    assert model.net.num_params == g["nn"].shape[0] == 61
    for name, split in zip(("train", "test"), splits):
        assert np.array_equal(g[f"types_{name}"], split.types)
        np.testing.assert_allclose(g["timepoints"], split.timepoints)


@pytest.mark.parametrize("solve", list(SOLVES))
@pytest.mark.parametrize("name", ["train", "test"])
def test_golden_trajectories_and_sse(golden, name, solve):
    g = golden[0]
    kw, bound = SOLVES[solve]
    traj, cohort = _golden_solve(golden, name, kw)
    delta = np.abs(traj.numpy() - g[f"traj_{name}"])
    assert delta.max() < bound, (name, solve, delta.max())
    sse = ((traj - cohort.cpeptide) ** 2).sum(1).double().numpy()
    sse_gold, types = g[f"sse_{name}"], g[f"types_{name}"]
    assert abs(sse.mean() / sse_gold.mean() - 1.0) < 0.01
    for kind in np.unique(types):
        sel = types == kind
        assert abs(sse[sel].mean() / sse_gold[sel].mean() - 1.0) < 0.01


def test_golden_default_tsit5_equals_jax(golden):
    """The default-tolerance solve that misses the cUDE's 2.5e-2 in float32
    is JAX's own solve, within the Tsit5 tolerance."""
    g, _, cohorts = golden
    traj, _ = _golden_solve(golden, "test", dict(solver="tsit5"))
    s = load_npz(ART / "ohashi.npz")[1]
    jc = jcp.build_cohort(s.glucose, s.timepoints, s.cpeptide, s.ages,
                          s.t2dm)
    jmodel = jcp.CPeptideModel(kind="ude", net=jax_chain(
        int(g["width"]), int(g["depth"]), "tanh", input_dims=1))
    ref = jcp.simulate_cohort(jmodel, jnp.asarray(g["nn"]),
                              jnp.zeros((jc.n, 0)), jc)
    np.testing.assert_allclose(traj.numpy(), np.asarray(ref.ys[:, :, 0]),
                               **TSIT5)


def test_golden_float64_splits_the_float32_delta(golden):
    """As for the cUDE: RK4 at 8 substeps and Tsit5 at rtol 1e-6 keep their
    deltas in float64 (within a factor 2), RK4 at 64 substeps reaches DOP853
    within 1.5e-6 in float64, and float32's RK4 at 64 substeps stays 5
    times below either float32 delta."""
    g = golden[0]
    d = {}
    for dtype in (torch.float32, torch.float64):
        for solve, kw in ({k: kw for k, (kw, _) in SOLVES.items()}
                          | {"rk4, 64 substeps": dict(solver="rk4",
                                                      substeps=64)}).items():
            d[solve, dtype] = max(
                float(np.abs(_golden_solve(golden, name, kw, dtype)[0]
                             .double().numpy() - g[f"traj_{name}"]).max())
                for name in ("train", "test"))
    for solve in ("rk4, 8 substeps", "tsit5, rtol 1e-6"):
        ratio = d[solve, torch.float64] / d[solve, torch.float32]
        assert 0.5 < ratio < 2.0, (solve, ratio)
    assert d["rk4, 64 substeps", torch.float64] < 1.5e-6
    assert 5 * d["rk4, 64 substeps", torch.float32] < min(
        d["rk4, 8 substeps", torch.float32],
        d["tsit5, rtol 1e-6", torch.float32])


def port_retrain_spread(seeds=SPREAD_SEEDS) -> dict:
    """The port's exp01 retrain (its own designs from each seed) at full
    width on the CPU."""
    runs = {}
    for seed in seeds:
        t0 = time.perf_counter()
        m = pipeline.run_ude_pipeline("cpu", ART, retrain=True,
                                      seed=seed).metrics()
        runs[str(seed)] = {k: m[k] for k in ("objective_best",
                                             "train_mse_mean",
                                             "test_mse_mean")}
        runs[str(seed)]["seconds"] = time.perf_counter() - t0
    return runs


if __name__ == "__main__":
    # --port [SEED ...]: the port's own retrains instead of JAX's
    if sys.argv[1:2] == ["--port"]:
        seeds = [int(a) for a in sys.argv[2:]] or SPREAD_SEEDS
        print(json.dumps(port_retrain_spread(seeds)))
    else:
        print(json.dumps(retrain_spread()))
