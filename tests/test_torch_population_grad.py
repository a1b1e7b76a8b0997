"""PyTorch port: K5, the value+gradient kernel with restarts as lanes
(``ops/population_grad.py``), the switch that takes it above
``PACK_MAX_LANES`` packed lanes, and the enlarged multi-start (exp02_xl) that
reaches it, against the JAX package.

On the CPU the wrapper runs K5's plain version.  Both bodies (2 inputs; 3
inputs with the age, scaled by 1/100 as in ``test_torch_covariate.py``) are
held at one small configuration (5 subjects on the OGTT grid, 2 RK4
substeps, 8 restarts) against the JAX package's restart-lane Pallas kernel
in interpret mode, against torch autograd through the port's plain RK4, and
against the port's own packed route (K2 and the sum outside it): value rtol
1e-4, gradients within 2e-4 of each row's largest entry
(``tests/test_pallas_grad.py:61-76`` and ``:214-238``).  On raw ages, where
that scale fails, both layouts are held to the packed plain version run in
float64, within 256 float32 roundings of a row's largest sum of absolute
per-point terms.

No CPU test reaches 131,072 lanes, so the switch and the training test
lower the threshold, in both packages, and count the calls of each package's
restart-lane function.  Training is fed the JAX package's designs (5
subjects, 64 designs, 3 restarts, 2 substeps); tolerances as in
``test_torch_train.py``: after 30 Adam steps parameters atol 1e-5 and loss
traces rtol 1e-4, Tsit5 objectives rtol 2e-2; with 20 L-BFGS steps added,
final objectives rtol 5e-2.  The reduced exp02_xl frozen pipeline (12
candidates, 5 subjects per set, 30 L-BFGS steps) is held against the same
steps composed from the JAX package as ``test_torch_pipeline.py`` holds
exp02's: validation objectives rtol 1e-4, β atol 2e-3, σ rtol 5e-3, the SSE
back-converted from the σ-NLL rtol 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

import conditional_ude_tpu.ops.pallas_grad as jpg
from conditional_ude_tpu.fit import train as jtrain
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.ops.pallas_rk4 import cohort_kinetics
from conditional_ude_tpu_torch.convert import (
    candidate_objectives,
    load_candidates,
    params_from_jax,
)
from conditional_ude_tpu_torch.data.ohashi import load_npz
from conditional_ude_tpu_torch.fit import train as ptrain
from conditional_ude_tpu_torch.fit.losses import population_sse
from conditional_ude_tpu_torch.models import cpeptide as cp
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import lane_grad, population_grad
from conditional_ude_tpu_torch.parallel import make_mesh
from conditional_ude_tpu_torch.parallel.mesh import sharded_population_vg
from conditional_ude_tpu_torch.pipeline import (
    guarded_best,
    run_frozen_pipeline,
)

TP = (0.0, 30.0, 60.0, 90.0, 120.0)
SUBSTEPS, G, N = 2, 8, 5
GRAD_ATOL = 2e-4
KINDS = {2: "conditional", 3: "conditional_covariate"}
XL = "artifacts/cude_neural_parameters_xl.npz"
# the reduced pipeline: candidates, subjects per set, L-BFGS steps
R, NS, ITERS = 12, 5, 30


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _huge(d):
    """Weights of 1e20 from ΔG through to the head: a rising glucose curve
    drives the trajectory past float32."""
    w1 = np.zeros((4, d))
    w1[:, 0] = 1e20
    return np.concatenate([w1.ravel(), np.zeros(4), np.eye(4).ravel(),
                           np.zeros(4), np.full(4, 1e20), [0.0]])


def _assert_grads_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-6)
    np.testing.assert_allclose(got / scale, ref / scale, atol=GRAD_ATOL)


@pytest.fixture(scope="module", params=[2, 3])
def case(request):
    """(d, JAX net, JAX cohort, port cohort, nn[G, P], betas[G, N], the
    kernels' cohort arguments); the last subject's glucose rises."""
    d = request.param
    rng = np.random.default_rng(17 + d)
    glucose = 5.0 + rng.uniform(0, 5, (N, 5))
    glucose[-1] = [5.0, 6.0, 7.0, 8.0, 9.0]
    ages = rng.uniform(30, 70, N)
    raw = (glucose, np.asarray(TP), 0.5 + rng.uniform(0, 1.5, (N, 5)), ages,
           rng.uniform(size=N) > 0.5)
    jc, pc = jcp.build_cohort(*raw), cp.build_cohort(*raw, "cpu")
    if d == 3:       # the kinetics keep the ages they were made from
        age = np.asarray(ages / 100.0, np.float32)
        jc = jc._replace(individuals=jc.individuals._replace(
            age=jnp.asarray(age)))
        pc = dataclasses.replace(pc, age=torch.as_tensor(age))
    jnet = jax_chain(4, 2, "tanh", input_dims=d)
    nn = np.array(jnet.init_batch(jax.random.key(5), G))
    betas = rng.uniform(-2.0, 0.0, (G, N)).astype(np.float32)
    kin = np.asarray(cohort_kinetics(jc, with_age=d == 3))
    args = (_t(jc.individuals.glucose), _t(jc.cpeptide), _t(kin), TP)
    return d, jnet, jc, pc, nn, betas, args


def _pallas_restart_lanes(jnet, jc, nn, betas, with_age):
    return jpg._population_sse_and_grad_impl(
        jnet, jnp.asarray(nn), jnp.asarray(betas), jc.individuals.glucose,
        jc.cpeptide, cohort_kinetics(jc, with_age=with_age), TP, SUBSTEPS,
        True)


def test_plain_matches_pallas_restart_lane_kernel(case):
    d, jnet, jc, _, nn, betas, args = case
    before = (population_grad.launches, population_grad.launches_age)
    f, gnn, gb = population_grad.restart_sse_and_grad(
        chain(4, 2, input_dims=d), _t(nn), _t(betas), *args, SUBSTEPS)
    # the CPU path launches nothing
    assert (population_grad.launches, population_grad.launches_age) == before
    assert f.shape == (G,) and gnn.shape == (G, 37 + 4 * (d == 3))
    assert gb.shape == (G, N)
    f_r, gnn_r, gb_r = _pallas_restart_lanes(jnet, jc, nn, betas, d == 3)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_r), rtol=1e-4)
    _assert_grads_close(gnn, gnn_r)
    _assert_grads_close(gb, gb_r)
    if d == 3:      # every w1[o][2] (the age weights) has a live gradient
        assert (gnn[:, 2:12:3].abs() > 0).all()


def test_plain_matches_autograd(case):
    """Against torch autograd through the model's plain batched RK4: the
    same discretisation by another derivation."""
    d, _, _, pc, nn, betas, args = case
    net = chain(4, 2, input_dims=d)
    f, gnn, gb = population_grad.restart_sse_and_grad(
        net, _t(nn), _t(betas), *args, SUBSTEPS)
    x = _t(nn).requires_grad_(True)
    b = _t(betas).requires_grad_(True)
    f_ad = population_sse(cp.CPeptideModel(net, KINDS[d]), x[:, None, :], b,
                          pc, substeps=SUBSTEPS)
    f_ad.sum().backward()
    np.testing.assert_allclose(f.numpy(), f_ad.detach().numpy(), rtol=1e-4)
    _assert_grads_close(gnn, x.grad)
    _assert_grads_close(gb, b.grad)


def test_plain_matches_the_packed_route(case):
    """K5 and K2 with the sum outside it are two layouts of one function
    (``tests/test_pallas_grad.py:214-238``)."""
    d, _, _, _, nn, betas, args = case
    net = chain(4, 2, input_dims=d)
    f, gnn, gb = population_grad.restart_sse_and_grad(
        net, _t(nn), _t(betas), *args, SUBSTEPS)
    f_p, gnn_p, gb_p = lane_grad.packed_sse_and_grad(
        net, _t(nn), _t(betas), *args, SUBSTEPS)
    np.testing.assert_allclose(f.numpy(), f_p.numpy(), rtol=1e-4)
    _assert_grads_close(gnn, gnn_p)
    _assert_grads_close(gb, gb_p)


def test_restart_of_huge_weights_gives_inf(case):
    """One restart's trajectory leaves float32 on the rising glucose curve:
    its value is inf, as the JAX kernel's, and the other restarts are
    untouched."""
    d, jnet, jc, _, nn, betas, args = case
    net = chain(4, 2, input_dims=d)
    bad = nn.copy()
    bad[3] = _huge(d)
    f, gnn, gb = population_grad.restart_sse_and_grad(
        net, _t(bad), _t(betas), *args, SUBSTEPS)
    f_r, _, _ = _pallas_restart_lanes(jnet, jc, bad, betas, d == 3)
    assert bool(torch.isinf(f[3])) and np.isinf(np.asarray(f_r)[3])
    good, g_gnn, g_gb = population_grad.restart_sse_and_grad(
        net, _t(nn), _t(betas), *args, SUBSTEPS)
    keep = np.arange(G) != 3
    np.testing.assert_allclose(f.numpy()[keep], np.asarray(f_r)[keep],
                               rtol=1e-4)
    torch.testing.assert_close(f[keep], good[keep], rtol=0, atol=0)
    torch.testing.assert_close(gnn[keep], g_gnn[keep], rtol=0, atol=0)
    torch.testing.assert_close(gb[keep], g_gb[keep], rtol=0, atol=0)


def test_both_layouts_lie_near_the_float64_witness(case):
    """On raw ages (30-70) a random network is saturated and its weight
    gradient is what float32 leaves of cancelling terms, so the two layouts
    are no longer close by a row's largest entry.  The packed plain version
    follows the dtype of its inputs: run in float64 with ``magnitudes`` it
    gives the witness and each entry's sum of absolute per-point terms, and
    both float32 layouts lie within 256 float32 roundings of a row's largest
    such sum (the limit the card check states)."""
    d, _, _, _, nn, betas, (glucose, data, kin, tp) = case
    net = chain(4, 2, input_dims=d)
    if d == 3:
        kin = kin.clone()
        kin[:, 4] *= 100.0
    args = (_t(nn), _t(betas), glucose, data, kin)
    plain = lane_grad.lane_sse_and_grad_reference(net, *args, tp, SUBSTEPS)
    sse, gnn, gb, mag, mag_b = lane_grad.lane_sse_and_grad_reference(
        net, *(a.double() for a in args), tp, SUBSTEPS, magnitudes=True)
    assert gnn.dtype == mag.dtype == torch.float64 and len(plain) == 3
    assert mag.shape == gnn.shape and mag_b.shape == gb.shape
    assert bool((mag >= gnn.abs() * (1 - 1e-12)).all())
    assert bool((mag_b >= gb.abs() * (1 - 1e-12)).all())
    np.testing.assert_allclose(plain[0].numpy(), sse.numpy(), rtol=1e-4)
    g64, terms = gnn.mean(1), mag.mean(1)
    scale = terms.amax(1, keepdim=True)
    for route in (population_grad.restart_sse_and_grad,
                  lane_grad.packed_sse_and_grad):
        got = route(net, *args, tp, SUBSTEPS)[1].double()
        assert float(((got - g64).abs() / scale).max()) < 256 * 2.0 ** -23
    if d == 3:      # the cancellation the witness is for
        assert float((g64.abs().amax(1) / scale[:, 0]).min()) < 1e-2


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name``."""
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_switch_follows_the_lane_count(case, monkeypatch):
    """Up to ``PACK_MAX_LANES`` (restart × individual) lanes the packed
    route, above it the restart kernel; the threshold is the JAX package's,
    and ``PopulationSSE`` goes through the same switch."""
    d, _, _, _, nn, betas, args = case
    net = chain(4, 2, input_dims=d)
    assert lane_grad.PACK_MAX_LANES == jpg.PACK_MAX_LANES == 131072
    assert not lane_grad.takes_restart_kernel(2299, 57)
    assert lane_grad.takes_restart_kernel(2300, 57)
    packed = _spy(monkeypatch, lane_grad, "lane_sse_and_grad_reference")
    restart = _spy(monkeypatch, population_grad,
                   "restart_sse_and_grad_reference")
    call = (net, _t(nn), _t(betas), *args, SUBSTEPS)
    monkeypatch.setattr(lane_grad, "PACK_MAX_LANES", G * N)
    at = lane_grad.population_sse_and_grad(*call)
    assert (len(packed), len(restart)) == (1, 0)
    monkeypatch.setattr(lane_grad, "PACK_MAX_LANES", G * N - 1)
    above = lane_grad.population_sse_and_grad(*call)
    assert (len(packed), len(restart)) == (1, 1)
    for a, b in zip(at, above):
        assert a.shape == b.shape
    np.testing.assert_allclose(above[0].numpy(), at[0].numpy(), rtol=1e-4)
    _assert_grads_close(above[1], at[1])
    _assert_grads_close(above[2], at[2])
    # under autograd: the forward takes the restart route once, the backward
    # scales its saved gradients
    x = _t(nn).requires_grad_(True)
    vg = sharded_population_vg(net, args, make_mesh(devices=["cpu"]),
                               substeps=SUBSTEPS)
    f = lane_grad.PopulationSSE.apply(x, _t(betas), vg)
    f.sum().backward()
    assert (len(packed), len(restart)) == (1, 2)
    torch.testing.assert_close(x.grad, above[1], rtol=0, atol=0)


@pytest.fixture(scope="module")
def trained():
    """``train_conditional`` of both packages above the lowered threshold,
    from the JAX package's designs, without and with L-BFGS; with each run
    the calls of the two restart-lane functions and of the port's packed
    one."""
    n, g, k, adam, lbfgs = 5, 64, 3, 30, 20
    train, _ = load_npz("artifacts/ohashi.npz")
    s = train.subset(np.arange(n))
    raw = (s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm)
    jmodel = jcp.CPeptideModel(kind="conditional",
                               net=jax_chain(4, 2, "tanh", input_dims=2))
    jc, pc = jcp.build_cohort(*raw), cp.build_cohort(*raw, "cpu")
    key = jax.random.key(0)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # k · n = 15 lanes are above the threshold, a single restart's n
        # lanes (the unbatched trace of the JAX package's vmap seam) too
        mp.setattr(jpg, "PACK_MAX_LANES", n - 1)
        mp.setattr(lane_grad, "PACK_MAX_LANES", n - 1)
        jax_calls = _spy(mp, jpg, "_population_sse_and_grad_impl")
        port_calls = _spy(mp, population_grad,
                          "restart_sse_and_grad_reference")
        packed_calls = _spy(mp, lane_grad, "lane_sse_and_grad_reference")
        for steps in (0, lbfgs):
            # no other test trains with this configuration: the JAX package
            # caches its jitted programs by model and configuration
            kw = dict(initial_guesses=g, selected_initials=k,
                      adam_iters=adam, lbfgs_iters=steps, screen_chunk=g,
                      substeps=SUBSTEPS, lhs_lower=-1.9)
            jcfg = jtrain.TrainConfig(use_pallas=True, **kw)
            designs = jtrain.initial_designs(jmodel.net, n, key, jcfg)
            before = (len(jax_calls), len(port_calls), len(packed_calls))
            ref = jtrain.train_conditional(jmodel, jc, key, jcfg)
            port = ptrain.train_conditional(
                cp.CPeptideModel(chain(4, 2)), pc, ptrain.TrainConfig(**kw),
                designs=designs)
            calls = tuple(len(c) - b for c, b in zip(
                (jax_calls, port_calls, packed_calls), before))
            out[steps] = (port, ref, calls)
    return out, (n, k, adam, lbfgs)


def test_training_above_the_threshold_takes_the_restart_route(trained):
    runs, (_, _, adam, lbfgs) = trained
    for steps in (0, lbfgs):
        port, _, (jax_calls, port_calls, packed_calls) = runs[steps]
        assert jax_calls > 0        # traced into the JAX package's programs
        assert port_calls >= adam + steps and packed_calls == 0
        assert port.timings["refine_path"] == "plain_k5"
        assert port.timings["screen_path"] == "plain"


def test_adam_stage_above_the_threshold_matches_jax(trained):
    runs, (n, k, adam, _) = trained
    port, ref, _ = runs[0]
    assert port.nn_params.shape == (k, 37) and port.betas.shape == (k, n, 1)
    assert port.loss_traces.shape == (k, adam)
    np.testing.assert_allclose(port.screen_losses.numpy(),
                               np.asarray(ref.screen_losses), rtol=1e-5)
    np.testing.assert_allclose(port.nn_params.numpy(),
                               np.asarray(ref.nn_params), atol=1e-5)
    np.testing.assert_allclose(port.betas.numpy(), np.asarray(ref.betas),
                               atol=1e-5)
    np.testing.assert_allclose(port.loss_traces.numpy(),
                               np.asarray(ref.loss_traces), rtol=1e-4)
    np.testing.assert_allclose(port.objectives.numpy(),
                               np.asarray(ref.objectives), rtol=2e-2)
    np.testing.assert_array_equal(port.orientations.numpy(),
                                  np.asarray(ref.orientations))


def test_lbfgs_stage_above_the_threshold_matches_jax(trained):
    runs, (_, _, _, lbfgs) = trained
    port, ref, _ = runs[lbfgs]
    np.testing.assert_allclose(port.loss_traces.numpy(),
                               np.asarray(ref.loss_traces), rtol=1e-4)
    np.testing.assert_allclose(port.objectives.numpy(),
                               np.asarray(ref.objectives), rtol=5e-2)
    assert (np.diff(port.objectives.numpy()) >= 0).all()


def test_orientations_batched_equal_one_by_one():
    """The ±1 gauges of many networks in one call equal the JAX package's,
    taken one network at a time."""
    nn, _, _, orientations = load_candidates(XL)
    model = cp.CPeptideModel(chain(4, 2))
    jmodel = jcp.CPeptideModel(kind="conditional",
                               net=jax_chain(4, 2, "tanh", input_dims=2))
    out = cp.production_orientations(model, _t(nn))
    assert out.shape == (96,)
    np.testing.assert_array_equal(out.numpy(), orientations)
    for i in (0, 45, 95):
        assert float(out[i]) == float(jcp.production_orientation(
            jmodel, jnp.asarray(nn[i])))
        assert cp.production_orientation(model, _t(nn[i])) == float(out[i])


def _real(split):
    raw = (split.glucose, split.timepoints, split.cpeptide, split.ages,
           split.t2dm)
    return jcp.build_cohort(*raw)


@pytest.fixture(scope="module")
def frozen():
    """exp02_xl's frozen path with R candidates and NS subjects per set, and
    the same steps composed from the JAX package
    (``experiments/exp02_xl.py:68-85``)."""
    port = run_frozen_pipeline("cpu", "artifacts", lbfgs_iters=ITERS,
                               candidates=R, subjects=NS, profile_steps=0,
                               census_steps=0, xl=True)
    train, test = load_npz("artifacts/ohashi.npz")
    nn, betas, idx_fit, _ = load_candidates(XL)
    val = train.subset(np.setdiff1d(np.arange(len(train.ages)), idx_fit))
    jtr, jval, jte = (_real(s.subset(np.arange(NS)))
                      for s in (train, val, test))
    jmodel = jcp.CPeptideModel(kind="conditional",
                               net=jax_chain(4, 2, "tanh", input_dims=2))
    objectives = np.asarray(jtrain.evaluate_model(
        jmodel, jnp.asarray(nn[:R]), jnp.asarray(betas[:R]), jval,
        lbfgs_iters=ITERS))
    best = jtrain.select_best(objectives)
    sums = objectives.sum(axis=1)
    guard = int(np.argmin(sums[:max(1, len(sums) // 2)]))

    def refit(i, cohort):
        bb = betas[i].ravel()
        lb, ub = bb.min() - 0.1 * abs(bb.min()), bb.max() + 0.1 * abs(bb.max())
        b, s, o = (np.asarray(a) for a in jtrain.fit_betas_sigma(
            jmodel, jnp.asarray(nn[i]), cohort, -1.0, (float(lb), float(ub)),
            ITERS))
        return b, s, (o - (5 / 2) * np.log(s**2)) * (2 * s**2)

    ref = dict(objectives=objectives, best=best, guard=guard,
               train=refit(best, jtr), test=refit(best, jte),
               guard_test=refit(guard, jte))
    return port, ref


def test_reduced_xl_pipeline_selects_as_jax(frozen):
    port, ref = frozen
    np.testing.assert_allclose(port.val_objectives, ref["objectives"],
                               rtol=1e-4)
    assert port.best == ref["best"]
    assert port.guarded_best == ref["guard"] != port.best
    assert port.guarded_best == guarded_best(ref["objectives"])
    assert set(port.seconds) == {"select", "refit", "guarded_refit"}


def test_reduced_xl_pipeline_refits_as_jax(frozen):
    port, ref = frozen
    for split, (b, s, sse) in (("train", ref["train"]),
                               ("test", ref["test"])):
        np.testing.assert_allclose(getattr(port, f"b_{split}"), b, atol=2e-3)
        np.testing.assert_allclose(getattr(port, f"s_{split}"), s, rtol=5e-3)
        np.testing.assert_allclose(getattr(port, f"sse_{split}"), sse,
                                   rtol=2e-2)
    # the guarded candidate's own refit of the test subjects
    sse_g = ref["guard_test"][2]
    np.testing.assert_allclose(port.guarded_sse_test, sse_g, rtol=2e-2)
    m = port.metrics()
    assert m["guarded_best_model_index"] == ref["guard"]
    np.testing.assert_allclose(m["guarded_test_sse_mean"], sse_g.mean(),
                               rtol=2e-2)
    np.testing.assert_allclose(m["guarded_test_sse_median"],
                               np.median(sse_g), rtol=2e-2)
    np.testing.assert_allclose(m["test_sse_median"],
                               np.median(ref["test"][2]), rtol=2e-2)
    assert -1.0 <= m["guarded_spearman_first_phase"] <= 1.0


def test_xl_candidates_and_the_guarded_rule():
    """The committed xl candidates are stored best first, which the guarded
    rule relies on; the rule itself on a small table; and the enlarged
    multi-start has no covariate variant."""
    objectives = candidate_objectives(XL)
    nn, betas, idx_fit, orientations = load_candidates(XL)
    assert objectives.shape == (96,) and (np.diff(objectives) >= 0).all()
    assert nn.shape == (96, 37) and betas.shape == (96, 57, 1)
    assert idx_fit.shape == (57,) and orientations.shape == (96,)
    # the file stores the networks column-major; the kernels need rows
    assert not nn.flags["C_CONTIGUOUS"]
    cand = params_from_jax(nn, chain(4, 2), "cpu")
    assert cand.is_contiguous() and cand[95].stride() == (1,)
    np.testing.assert_array_equal(cand.numpy(), nn)
    table = np.array([[3.0, 1.0], [1.0, 2.0], [0.5, 0.5], [0.1, 0.1]])
    assert guarded_best(table) == 1           # the better half: rows 0, 1
    assert guarded_best(table[:1]) == 0
    assert int(np.argmin(table.sum(1))) == 3  # the plain rule's pick
    with pytest.raises(ValueError):
        run_frozen_pipeline("cpu", "artifacts", covariate=True, xl=True)
