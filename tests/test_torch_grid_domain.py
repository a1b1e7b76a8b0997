"""PyTorch port: every kernel body's plain version on the JAX kernels'
whole input domain (F9): any time grid of two or more points (increasing,
possibly from before t = 0), any number of RK4 substeps and any cohort
size.  Before this, the port refused more than 16 time points in every
body, more than 16 substeps in K2 and K5, and on the card more than 819
individuals in K1 and 909 in K5, all of which the JAX kernels compute.

On the CPU each wrapper runs its body's plain version, held here against
the JAX package on the same inputs (both input counts; the age scaled by
1/100 as the JAX suite's covariate tests scale it):

* at 20 and 25 points, Fujita's 14 points from -10 min and 20 substeps:
  K1 (the RK4 screen) against JAX's Pallas screen in interpret mode, K4
  (RK4 lanes) against JAX's XLA route, its RK4 ``sse`` per lane, which
  JAX's suite holds its Pallas kernel to (a Pallas kernel in interpret
  mode costs 6-9 s a grid and input count here): rtol 1e-5, atol 1e-6
  (``tests/test_pallas_rk4.py``);
* K2, K5 (value + gradient) against JAX's XLA route, ``jax.value_and_grad``
  of that ``sse`` (its Pallas gradient kernels in interpret mode take more
  than 10 minutes at 25 points): value rtol 1e-4, gradients within 2e-4 of
  a row's largest entry (``tests/test_pallas_grad.py``);
* K3 (Tsit5) against its Pallas kernel in interpret mode at 20 and 25
  points and Fujita's: rtol 2e-2, atol 1e-3, the same ``ok`` mask
  (``tests/test_pallas_tsit5.py``);
* K1 and K5 at 1,053 individuals, past what a block held on the card;
* ``train_conditional`` at a cut on the 25-point cohort
  (``scripts/grid_reference.py``) against JAX's screen and Adam trace;
* the SAEM and ADVI kernel routes equal JAX's ``fused_kernel_eligible`` at
  20 and 32 substeps, with no substep term of their own.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.analysis import profiles as jprof
from conditional_ude_tpu.fit import losses as jloss
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.ops.pallas_rk4 import (
    _population_sse_pallas_impl,
    cohort_kinetics,
)
from conditional_ude_tpu.ops.pallas_tsit5 import cohort_sse_tsit5_pallas
from conditional_ude_tpu_torch.fit import advi
from conditional_ude_tpu_torch.fit.saem import CohortLogLik
from conditional_ude_tpu_torch.models import cpeptide as cp
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import (
    lane_grad,
    population_grad,
    rk4_cohort,
    rk4_population,
    tsit5_cohort,
)

REPO = Path(__file__).resolve().parent.parent
RK4 = dict(rtol=1e-5, atol=1e-6)
TSIT5 = dict(rtol=2e-2, atol=1e-3)
OGTT = (0.0, 30.0, 60.0, 90.0, 120.0)
GRIDS = {"20 points": tuple(np.linspace(0.0, 120.0, 20)),
         "25 points": tuple(np.linspace(0.0, 120.0, 25)),
         "fujita": tuple(float(t) for t in np.load(
             REPO / "artifacts" / "fujita.npz")["timepoints"]),
         "ogtt": OGTT}


def _case(grid, input_dims, g=3, n=5, seed=31):
    """g restarts (Glorot-scale weights, small biases, the last of huge
    ΔG weights) and β's on an n-subject cohort on ``GRIDS[grid]``, the last
    subject's glucose rising: ``(net, jax cohort, jax kinetics, numpy
    inputs, the port's tensors, times)``."""
    tp = GRIDS[grid]
    k = len(tp)
    rng = np.random.default_rng(seed)
    net = chain(4, 2, input_dims=input_dims)
    parts = []
    for fi, fo in net.layer_dims:
        b = np.sqrt(6.0 / (fi + fo))
        parts += [rng.uniform(-b, b, (g, fo * fi)),
                  rng.uniform(-0.1, 0.1, (g, fo))]
    nn = np.concatenate(parts, axis=1).astype(np.float32)
    w1 = np.zeros((4, input_dims))
    w1[:, 0] = 1e20
    nn[-1] = np.concatenate([w1.ravel(), np.zeros(4), np.eye(4).ravel(),
                             np.zeros(4), np.full(4, 1e20), [0.0]])
    glucose = 5.0 + rng.uniform(0, 5, (n, k))
    glucose[-1] = np.linspace(5.0, 9.0, k)
    jc = jcp.build_cohort(glucose, np.asarray(tp),
                          0.5 + rng.uniform(0, 1.5, (n, k)),
                          rng.uniform(30, 70, n), rng.uniform(size=n) > 0.5)
    kin = np.array(cohort_kinetics(jc, with_age=input_dims == 3))
    if input_dims == 3:       # the first layer not saturated
        kin[:, 4] /= 100.0
        jc = jc._replace(individuals=jc.individuals._replace(
            age=jnp.asarray(kin[:, 4])))
    betas = rng.uniform(-2.0, 0.0, (g, n)).astype(np.float32)
    t = lambda a: torch.as_tensor(np.array(a, np.float32))  # noqa: E731
    port = (t(nn), t(betas), t(jc.individuals.glucose), t(jc.cpeptide),
            t(kin))
    return net, jc, (nn, betas, kin), port, tp


def _lanes(port):
    """Restart inputs as K4's (restart × individual) lanes."""
    nn, betas, glucose, data, kin = port
    g, n = betas.shape
    return (nn.repeat_interleave(n, 0), betas.reshape(-1),
            glucose.repeat(g, 1), data.repeat(g, 1), kin.repeat(g, 1))


def _j(*xs):
    return tuple(jnp.asarray(np.asarray(x)) for x in xs)


def _same_inf(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    return np.isfinite(ref)


def _jax_lane_vg(input_dims, jc, nn, betas, substeps):
    """JAX's XLA route for K2: per-lane ``sse`` and its gradients in the
    weights and β by ``jax.value_and_grad``."""
    kind = "conditional_covariate" if input_dims == 3 else "conditional"
    model = jcp.CPeptideModel(kind=kind, net=jax_chain(
        4, 2, "tanh", input_dims=input_dims))

    def lane(w, b, ind, data):
        return jloss.sse(model, {"neural": w, "conditional": b}, ind,
                         jc.timepoints, data, solver="rk4",
                         substeps=substeps)

    per_ind = jax.vmap(jax.value_and_grad(lane, argnums=(0, 1)),
                       in_axes=(None, 0, 0, 0))
    sse, (gnn, gb) = jax.jit(jax.vmap(per_ind, in_axes=(0, 0, None, None)))(
        jnp.asarray(nn), jnp.asarray(betas), jc.individuals, jc.cpeptide)
    return np.asarray(sse), np.asarray(gnn), np.asarray(gb)


def _close_rows(got, want):
    """Each row within 2e-4 of its largest entry (finite rows)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).max(-1, keepdims=True), 1e-6)
    assert float(np.abs((got - want) / scale).max()) <= 2e-4


def _hold(grid, input_dims, substeps, g=3, n=5):
    """K1 against JAX's Pallas screen in interpret mode; K4, K2 and K5
    against JAX's XLA route (per-lane RK4 ``sse`` and its gradients; K5 the
    lanes' mean over the individuals; JAX's own suite holds its Pallas
    kernels to it); K5 also equal to K2's lanes summed in order."""
    net, jc, (nn, betas, kin), port, tp = _case(grid, input_dims, g, n)
    jnet = jax_chain(4, 2, "tanh", input_dims=input_dims)
    out = rk4_population.population_sse(net, *port, tp, substeps).numpy()
    ref = np.asarray(_population_sse_pallas_impl(
        jnet, *_j(nn, betas, jc.individuals.glucose, jc.cpeptide, kin), tp,
        substeps, True))
    assert np.isinf(out[-1])
    fin = _same_inf(out, ref)
    np.testing.assert_allclose(out[fin], ref[fin], **RK4)

    r_sse, r_gnn, r_gb = _jax_lane_vg(input_dims, jc, nn, betas, substeps)
    k4 = rk4_cohort.cohort_sse(net, *_lanes(port), tp, substeps).numpy()
    fin = np.isfinite(r_sse.ravel())
    assert np.isinf(k4[~fin]).all()
    np.testing.assert_allclose(k4[fin], r_sse.ravel()[fin], **RK4)

    sse, gnn, gb = (x.numpy() for x in lane_grad.lane_sse_and_grad(
        net, *port, tp, substeps))
    ok = np.isfinite(r_sse).all(1)        # restarts with every lane finite
    assert not ok[-1] and ok[:-1].all()
    np.testing.assert_allclose(sse[ok], r_sse[ok], rtol=1e-4, atol=0)
    _close_rows(gnn[ok].reshape(-1, gnn.shape[-1]),
                r_gnn[ok].reshape(-1, gnn.shape[-1]))
    _close_rows(gb[ok], r_gb[ok])
    f, g_nn, g_b = population_grad.restart_sse_and_grad(net, *port, tp,
                                                        substeps)
    assert bool(torch.isinf(f[-1]))
    np.testing.assert_allclose(f.numpy()[ok], r_sse[ok].mean(1), rtol=1e-4)
    _close_rows(g_nn.numpy()[ok], r_gnn[ok].mean(1))
    _close_rows(g_b.numpy()[ok], r_gb[ok] / n)
    lanes = lane_grad.lane_sse_and_grad(net, *port, tp, substeps)
    inv_n = np.float32(1.0 / n)
    mean = population_grad.sum_in_order(lanes[0]) * inv_n
    for got, want in ((f, torch.where(torch.isfinite(mean), mean, torch.inf)),
                      (g_nn, population_grad.sum_in_order(lanes[1]) * inv_n)):
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("grid,input_dims", [
    ("20 points", 2), ("25 points", 2), ("25 points", 3), ("fujita", 2),
    ("fujita", 3)])
def test_rk4_and_grad_bodies_on_a_longer_grid(grid, input_dims):
    """K1, K4, K2 and K5 (K1c, K4c, K2c, K5c) at 20 and 25 points and on
    Fujita's grid from -10 min, 8 substeps, against JAX: the port refused
    any grid of more than 16 points."""
    _hold(grid, input_dims, 8)


@pytest.mark.parametrize("grid,input_dims", [
    ("20 points", 2), ("25 points", 3), ("fujita", 2)])
def test_tsit5_body_on_a_longer_grid(grid, input_dims):
    """K3 (K3c): SSE and ``ok`` against JAX's Pallas Tsit5 kernel."""
    net, jc, (nn, betas, kin), port, tp = _case(grid, input_dims)
    jnet = jax_chain(4, 2, "tanh", input_dims=input_dims)
    lanes = _lanes(port)
    sse, ok = tsit5_cohort.cohort_sse_tsit5(
        net, *port, tp)
    r_sse, r_ok = cohort_sse_tsit5_pallas(jnet, *_j(*lanes), tp,
                                          interpret=True)
    ok, r_ok = ok.numpy().reshape(-1), np.asarray(r_ok)
    np.testing.assert_array_equal(ok, r_ok)
    assert not ok[-1] and ok[:-5].all()
    np.testing.assert_allclose(sse.numpy().reshape(-1)[ok],
                               np.asarray(r_sse)[ok], **TSIT5)


@pytest.mark.parametrize("input_dims", [2, 3])
def test_bodies_at_20_substeps(input_dims):
    """K1, K4, K2 and K5 at 20 substeps on the OGTT grid (165 evaluation
    points a lane): K2 and K5 refused more than 16."""
    _hold("ogtt", input_dims, 20)


@pytest.mark.parametrize("input_dims", [2, 3])
def test_cohort_past_909(input_dims):
    """K1 and K5 at 1,053 individuals from seed 31: K1 against JAX's
    Pallas screen, K5 against JAX's XLA value + gradient.  On the card K1
    held at most 819 and K5 909 individuals in a block."""
    n = 1053
    net, jc, (nn, betas, kin), port, tp = _case("ogtt", input_dims, 2, n)
    jnet = jax_chain(4, 2, "tanh", input_dims=input_dims)
    out = rk4_population.population_sse(net, *port, tp, 8).numpy()
    ref = np.asarray(_population_sse_pallas_impl(
        jnet, *_j(nn, betas, jc.individuals.glucose, jc.cpeptide, kin), tp,
        8, True))
    assert np.isfinite(out[0]) and np.isinf(out[1])
    np.testing.assert_allclose(out[0], ref[0], **RK4)
    f, g_nn, g_b = population_grad.restart_sse_and_grad(net, *port, tp, 8)
    r_sse, r_gnn, r_gb = _jax_lane_vg(input_dims, jc, nn[:1], betas[:1], 8)
    np.testing.assert_allclose(float(f[0]), r_sse[0].mean(), rtol=1e-4)
    _close_rows(g_nn.numpy()[:1], r_gnn[0].mean(0)[None])
    _close_rows(g_b.numpy()[:1], r_gb[:1] / n)


def _grid_reference():
    sys.path.insert(0, str(REPO / "scripts"))
    import grid_reference as ref
    import widths_reference
    return ref, widths_reference, json.loads(ref.OUT.read_text())


def test_training_cut_on_the_25_point_cohort():
    """``train_conditional`` on exp02's 57-subject fit split resampled to
    25 points (``scripts/grid_reference.py``'s cohort and numpy designs):
    all 2,500 screen losses within rtol 1e-5 of JAX's, and the best two
    restarts' first 3 Adam losses within rtol 1e-4 of JAX's restarts with
    the same first loss (the plain route of K1, K2 and K3)."""
    from conditional_ude_tpu_torch.data.ohashi import load_npz
    from conditional_ude_tpu_torch.fit.train import (
        TrainConfig,
        train_conditional,
    )
    from conditional_ude_tpu_torch.utils.stats import stratified_split
    ref, wref, want = _grid_reference()
    cfg0 = want["config"]
    train, _ = load_npz(REPO / "artifacts" / "ohashi.npz")
    idx_fit, _ = stratified_split(np.random.default_rng(cfg0["seed"]),
                                  train.types, 0.7)
    s = ref.resample(train.subset(idx_fit))
    assert tuple(float(t) for t in s.timepoints) == tuple(want["grid"])
    assert float(np.asarray(s.glucose, np.float64).sum()) == \
        want["cohort_sums"]["glucose"]
    fit = cp.build_cohort(s.glucose, s.timepoints, s.cpeptide, s.ages,
                          s.t2dm, "cpu")
    nn, betas = wref.designs((4, 4), 2, fit.n, cfg0["lhs_lower"],
                             cfg0["lhs_upper"])
    assert wref.checksums(nn, betas) == {k: want[k] for k in
                                         ("nn_sum", "betas_sum")}
    cfg = TrainConfig(initial_guesses=cfg0["initial_guesses"],
                      selected_initials=2, adam_iters=3, lbfgs_iters=0,
                      substeps=cfg0["substeps"], max_steps=cfg0["max_steps"])
    res = train_conditional(cp.CPeptideModel(chain(4, 2), "conditional"),
                            fit, cfg, designs=(nn, betas))
    assert res.timings["screen_path"] == "plain"
    np.testing.assert_allclose(res.screen_losses.numpy(),
                               want["screen_losses"], rtol=1e-5)
    traces = np.asarray(want["loss_traces"])
    got = res.loss_traces.numpy()
    for row in got:
        j = int(np.argmin(np.abs(traces[:, 0] - row[0])))
        np.testing.assert_allclose(row[:3], traces[j, :3], rtol=1e-4)


@pytest.mark.parametrize("substeps", [20, 32])
def test_fit_routes_equal_jax_predicate_past_16_substeps(substeps):
    """SAEM's likelihood (``CohortLogLik.kernels``) and ADVI's gradient
    (``advi.kernel_route``) take the kernels exactly where JAX's
    ``fused_kernel_eligible`` does, for the canonical, wider and non-tanh
    networks of both kinds: the port added ``substeps <= 16``."""
    c = cp.build_cohort(5.0 + np.zeros((2, 5)), np.asarray(OGTT),
                        np.ones((2, 5)), np.full(2, 50.0),
                        np.zeros(2, bool), "cpu")
    taken = 0
    for widths, act, (kind, inputs) in (
            ((4, 4), "tanh", ("conditional", 2)),
            ((8, 8), "tanh", ("conditional", 2)),
            ((6, 3), "tanh", ("conditional_covariate", 3)),
            ((4, 4), "relu", ("conditional", 2)),
            ((4, 4), "tanh", ("conditional", 3))):
        jmodel = jcp.CPeptideModel(kind=kind, net=jax_chain(
            list(widths), activation=act, input_dims=inputs))
        model = cp.CPeptideModel(chain(list(widths), activation=act,
                                       input_dims=inputs), kind)
        want = jprof.fused_kernel_eligible(jmodel, {"substeps": substeps})
        assert advi.kernel_route(model, substeps) == want
        assert CohortLogLik(model, c, substeps=substeps).kernels == want
        taken += want
    assert taken == 3
