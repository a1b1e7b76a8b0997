"""PyTorch port: the covariate cUDE of experiment 07, whose network takes the
age as a third input ([ΔG, e^β, age], 41 weights), against the JAX package.

On the CPU every kernel wrapper runs its plain version; the four covariate
bodies (K1c screen, K2c value + gradient, K3c Tsit5 re-rank, K4c cohort RK4)
are held against the JAX package's Pallas kernels in interpret mode at one
small configuration (5 subjects on the OGTT grid, 2 RK4 substeps, 8
restarts), as ``tests/test_pallas_covariate.py`` holds them against XLA
(that file's 3-point grid gives 30-minute RK4 steps, on which the
kinetics are unstable and float32 differences grow).  Raw ages (30-70)
saturate a Glorot network's first tanh layer, so there, and in training,
the age input is scaled by 1/100 after the kinetics are made, as in that
file; the model, the fits and the reduced pipeline use the real, raw ages.

Tolerances are those of each 2-input counterpart: K1c rtol 1e-5
(``test_torch_population.py``), K4c rtol 1e-4 (``test_torch_rk4_cohort.py``),
K2c value rtol 1e-4 and gradients 2e-4 of each row's largest
(``test_torch_lane_grad.py``), K3c rtol 2e-2 / atol 1e-3
(``test_torch_tsit5.py``), the β/σ fits and the pipeline as
``test_torch_frozen.py`` and ``test_torch_pipeline.py`` (with atol 1e-5 on
the σ-NLL objectives, which can cross zero), training as
``test_torch_train.py``.  The card itself runs ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.analysis import (
    classify_identifiability,
    cohort_beta_profiles,
    find_confidence_intervals,
)
from conditional_ude_tpu.fit import train as jtrain
from conditional_ude_tpu.fit.losses import population_sse as jax_population_sse
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.ops.pallas_grad import population_sse_and_grad_pallas
from conditional_ude_tpu.ops.pallas_rk4 import (
    cohort_kinetics,
    cohort_sse_pallas,
    expand_to_lanes,
    population_sse_pallas,
)
from conditional_ude_tpu.ops.pallas_tsit5 import screen_population_tsit5_pallas
from conditional_ude_tpu_torch.convert import load_candidates, params_from_jax
from conditional_ude_tpu_torch.data.ohashi import load_npz
from conditional_ude_tpu_torch.fit import train as ptrain
from conditional_ude_tpu_torch.fit.losses import population_sse
from conditional_ude_tpu_torch.models import cpeptide as cp
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import (
    lane_grad,
    rk4_cohort,
    rk4_population,
    tsit5_cohort,
)
from conditional_ude_tpu_torch.pipeline import run_frozen_pipeline

KIND = "conditional_covariate"
TP = (0.0, 30.0, 60.0, 90.0, 120.0)
SUBSTEPS, G, N = 2, 8, 5
GRAD_ATOL = 2e-4
MODULES = (rk4_cohort, rk4_population, lane_grad, tsit5_cohort)
CANDIDATES = "artifacts/cude_covariate_neural_parameters.npz"
# the reduced pipeline: candidates, subjects per set, L-BFGS steps, scan points
R, NS, ITERS, STEPS = 3, 6, 30, 40


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _huge():
    """Weights of 1e20 from ΔG through to the head: a rising glucose curve
    drives the trajectory past float32."""
    w1 = np.zeros((4, 3))
    w1[:, 0] = 1e20
    return np.concatenate([w1.ravel(), np.zeros(4), np.eye(4).ravel(),
                           np.zeros(4), np.full(4, 1e20), [0.0]])


def _with_age(jc, pc, age):
    """Both packages' cohorts with the covariate input replaced by ``age``;
    the kinetics keep the ages they were made from."""
    age = np.asarray(age, np.float32)
    return (jc._replace(individuals=jc.individuals._replace(
        age=jnp.asarray(age))), dataclasses.replace(pc, age=torch.as_tensor(age)))


def _launch_counts():
    return [(m.launches, m.launches_age) for m in MODULES]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    glucose = 5.0 + rng.uniform(0, 5, (N, 5))
    glucose[-1] = [5.0, 6.0, 7.0, 8.0, 9.0]
    raw = (glucose, np.asarray(TP), 0.5 + rng.uniform(0, 1.5, (N, 5)),
           rng.uniform(30, 70, N), rng.uniform(size=N) > 0.5)
    jc, pc = _with_age(jcp.build_cohort(*raw), cp.build_cohort(*raw, "cpu"),
                       raw[3] / 100.0)
    jnet = jax_chain(4, 2, "tanh", input_dims=3)
    nn = np.array(jnet.init_batch(jax.random.key(5), G))
    betas = rng.uniform(-2.0, 0.0, (G, N)).astype(np.float32)
    return jnet, jc, pc, nn, betas


def _cohort_args(jc):
    kin = np.asarray(cohort_kinetics(jc, with_age=True))
    return _t(jc.individuals.glucose), _t(jc.cpeptide), _t(kin), TP


def test_screen_plain_matches_pallas_interpret(case):
    """K1c, with one restart of huge weights whose mean is inf."""
    jnet, jc, _, nn, betas = case
    nn = nn.copy()
    nn[-1] = _huge()
    before = _launch_counts()
    out = rk4_population.population_sse(chain(4, 2, input_dims=3), _t(nn),
                                        _t(betas), *_cohort_args(jc),
                                        SUBSTEPS).numpy()
    assert _launch_counts() == before        # the CPU path launches nothing
    ref = np.asarray(population_sse_pallas(jnet, jnp.asarray(nn),
                                           jnp.asarray(betas), jc, SUBSTEPS,
                                           interpret=True))
    assert np.isinf(out[-1]) and np.isinf(ref[-1])
    np.testing.assert_allclose(out[:-1], ref[:-1], rtol=1e-5, atol=1e-6)


def test_cohort_plain_matches_pallas_interpret_and_the_screen(case):
    """K4c on the (restart × individual) lanes; their mean per restart is
    K1c's population SSE."""
    jnet, jc, _, nn, betas = case
    net = chain(4, 2, input_dims=3)
    lanes = expand_to_lanes(jnp.asarray(nn), jnp.asarray(betas), jc,
                            with_age=True)
    nn_l, b_l, g_l, d_l, kin_l, tp = lanes
    assert kin_l.shape == (G * N, 5)
    out = rk4_cohort.cohort_sse(net, *map(_t, lanes[:5]), tp, SUBSTEPS)
    ref = np.asarray(cohort_sse_pallas(jnet, nn_l, b_l, g_l, d_l, kin_l, tp,
                                       SUBSTEPS, interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-6)
    pop = rk4_population.population_sse(net, _t(nn), _t(betas),
                                        *_cohort_args(jc), SUBSTEPS)
    torch.testing.assert_close(out.reshape(G, N).mean(1), pop, rtol=1e-5,
                               atol=1e-6)


def test_value_and_grad_plain_matches_pallas_and_autograd(case):
    """K2c against the Pallas kernel, and against torch autograd through the
    covariate model's plain RK4 (which checks the age's weight gradient
    without JAX)."""
    jnet, jc, pc, nn, betas = case
    net = chain(4, 2, input_dims=3)
    f, gnn, gb = lane_grad.population_sse_and_grad(
        net, _t(nn), _t(betas), *_cohort_args(jc), SUBSTEPS)
    assert gnn.shape == (G, 41)
    f_r, gnn_r, gb_r = population_sse_and_grad_pallas(
        jnet, jnp.asarray(nn), jnp.asarray(betas), jc, substeps=SUBSTEPS,
        interpret=True)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_r), rtol=1e-4)
    for got, ref in ((gnn, gnn_r), (gb, gb_r)):
        ref = np.asarray(ref)
        scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-6)
        np.testing.assert_allclose(got.numpy() / scale, ref / scale,
                                   atol=GRAD_ATOL)
    # every w1[o][2] (the age weights) has a live gradient
    assert (gnn[:, 2:12:3].abs() > 0).all()

    x = _t(nn).requires_grad_(True)
    b = _t(betas).requires_grad_(True)
    f_ad = population_sse(cp.CPeptideModel(net, KIND), x[:, None, :], b, pc,
                          substeps=SUBSTEPS)
    f_ad.sum().backward()
    np.testing.assert_allclose(f.numpy(), f_ad.detach().numpy(), rtol=1e-4)
    for got, ref in ((gnn, x.grad), (gb, b.grad)):
        scale = ref.abs().amax(1, keepdim=True).clamp_min(1e-6)
        assert float(((got - ref) / scale).abs().max()) <= GRAD_ATOL


def test_tsit5_plain_matches_pallas_interpret(case):
    """K3c: the population mean of the adaptive SSE, inf for a failed lane."""
    jnet, jc, _, nn, betas = case
    out = tsit5_cohort.screen_population_tsit5(
        chain(4, 2, input_dims=3), _t(nn), _t(betas), *_cohort_args(jc),
        max_steps=128).numpy()
    ref = np.asarray(screen_population_tsit5_pallas(
        jnet, jnp.asarray(nn), jnp.asarray(betas), jc, max_steps=128,
        interpret=True))
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin.any()
    np.testing.assert_allclose(out[fin], ref[fin], rtol=2e-2, atol=1e-3)


def test_age_reaches_every_plain_kernel(case):
    """Two cohorts that differ only in the age input (the kinetics are
    made from the same ages) give different results in all four covariate
    bodies, and K1c still matches the Pallas kernel on each
    (``tests/test_pallas_covariate.py:96-123``)."""
    jnet, jc, pc, nn, betas = case
    net = chain(4, 2, input_dims=3)
    outs = []
    for age in (0.3, 0.7):
        jca, _ = _with_age(jc, pc, np.full(N, age))
        args = _cohort_args(jca)
        k1 = rk4_population.population_sse(net, _t(nn), _t(betas), *args,
                                           SUBSTEPS)
        ref = population_sse_pallas(jnet, jnp.asarray(nn), jnp.asarray(betas),
                                    jca, SUBSTEPS, interpret=True)
        np.testing.assert_allclose(k1.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
        k2 = lane_grad.population_sse_and_grad(net, _t(nn), _t(betas), *args,
                                               SUBSTEPS)[1]
        k3 = tsit5_cohort.screen_population_tsit5(net, _t(nn), _t(betas),
                                                  *args, max_steps=128)
        kin = args[2].expand(G, N, 5).reshape(-1, 5)
        k4 = rk4_cohort.cohort_sse(
            net, _t(nn).repeat_interleave(N, 0), _t(betas).reshape(-1),
            args[0].repeat(G, 1), args[1].repeat(G, 1), kin, TP, SUBSTEPS)
        outs.append((k1, k2, k3, k4))
    for a, b in zip(*outs):
        assert not torch.allclose(a, b)


def test_simulate_cohort_and_orientation_match_jax():
    """The covariate model's RK4 solve on real subjects (raw ages), and the
    ±1 gauge of committed candidates at a given age."""
    train, _ = load_npz("artifacts/ohashi.npz")
    s = train.subset(np.arange(6))
    raw = (s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm)
    jc, pc = jcp.build_cohort(*raw), cp.build_cohort(*raw, "cpu")
    jmodel = jcp.CPeptideModel(kind=KIND, net=jax_chain(4, 2, "tanh",
                                                        input_dims=3))
    model = cp.CPeptideModel(chain(4, 2, input_dims=3), KIND)
    nets, betas, _, _ = load_candidates(CANDIDATES)
    nn, b = nets[16], betas[16, :6, 0]
    res = cp.simulate_cohort(model, _t(nn), _t(b), pc, substeps=8)
    ref = jcp.simulate_cohort(jmodel, jnp.asarray(nn), jnp.asarray(b), jc,
                              solver="rk4", substeps=8)
    ys = np.asarray(ref.ys)
    np.testing.assert_allclose(res.ys.numpy(), ys, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(ys).max()))
    # the age input matters: the same solve at a constant age differs
    other = cp.simulate_cohort(model, _t(nn), _t(b), dataclasses.replace(
        pc, age=torch.full((6,), 50.0)), substeps=8)
    assert not torch.allclose(other.ys, res.ys)
    for i in (0, 14, 16):
        for age in (float(np.mean(train.ages)), 30.0):
            out = cp.production_orientation(model, _t(nets[i]), age=age)
            assert out == float(jcp.production_orientation(
                jmodel, jnp.asarray(nets[i]), age=age))


def _real(split_slice):
    s = split_slice
    raw = (s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm)
    return jcp.build_cohort(*raw), cp.build_cohort(*raw, "cpu")


def test_train_conditional_with_jax_designs():
    """Joint training of the covariate model from the JAX package's designs
    (its Pallas path in interpret mode): 5 subjects, 64 designs, 2 restarts,
    10 Adam steps and the Tsit5 re-rank, 2 RK4 substeps.  (L-BFGS runs the
    same code for both models; ``test_torch_train.py`` holds it.)"""
    train, _ = load_npz("artifacts/ohashi.npz")
    s = train.subset(np.arange(N))
    raw = (s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm)
    jc, pc = _with_age(jcp.build_cohort(*raw), cp.build_cohort(*raw, "cpu"),
                       s.ages / 100.0)
    jmodel = jcp.CPeptideModel(kind=KIND, net=jax_chain(4, 2, "tanh",
                                                        input_dims=3))
    kw = dict(initial_guesses=64, selected_initials=2, adam_iters=10,
              lbfgs_iters=0, screen_chunk=64, substeps=SUBSTEPS)
    jcfg = jtrain.TrainConfig(use_pallas=True, **kw)
    key = jax.random.key(0)
    designs = jtrain.initial_designs(jmodel.net, N, key, jcfg)
    ref = jtrain.train_conditional(jmodel, jc, key, jcfg)
    before = _launch_counts()
    port = ptrain.train_conditional(
        cp.CPeptideModel(chain(4, 2, input_dims=3), KIND), pc,
        ptrain.TrainConfig(**kw), designs=designs)
    assert _launch_counts() == before
    assert port.nn_params.shape == (2, 41) and port.betas.shape == (2, N, 1)
    np.testing.assert_allclose(port.screen_losses.numpy(),
                               np.asarray(ref.screen_losses), rtol=1e-5)
    np.testing.assert_allclose(port.loss_traces.numpy(),
                               np.asarray(ref.loss_traces), rtol=1e-4)
    np.testing.assert_allclose(port.objectives.numpy(),
                               np.asarray(ref.objectives), rtol=5e-2)
    np.testing.assert_array_equal(port.orientations.numpy(),
                                  np.asarray(ref.orientations))


def _counts(census):
    return {str(c): int((census == c).sum()) for c in np.unique(census)}


@pytest.fixture(scope="module")
def frozen():
    """exp07's frozen path with R candidates and NS subjects per set, and
    the same steps composed from the JAX package."""
    port = run_frozen_pipeline("cpu", "artifacts", lbfgs_iters=ITERS,
                               candidates=R, subjects=NS, profile_steps=STEPS,
                               census_steps=STEPS, covariate=True)
    train, test = load_npz("artifacts/ohashi.npz")
    nn, betas, idx_fit, _ = load_candidates(CANDIDATES)
    val = train.subset(np.setdiff1d(np.arange(len(train.ages)), idx_fit))
    (jtr, _), (jval, _), (jte, pte) = (_real(s.subset(np.arange(NS)))
                                       for s in (train, val, test))
    jmodel = jcp.CPeptideModel(kind=KIND, net=jax_chain(4, 2, "tanh",
                                                        input_dims=3))
    objectives = np.asarray(jtrain.evaluate_model(
        jmodel, jnp.asarray(nn[:R]), jnp.asarray(betas[:R]), jval,
        lbfgs_iters=ITERS))
    best = jtrain.select_best(objectives)
    bb = betas[best].ravel()
    lb, ub = bb.min() - 0.1 * abs(bb.min()), bb.max() + 0.1 * abs(bb.max())
    fits = [[np.asarray(a) for a in jtrain.fit_betas_sigma(
        jmodel, jnp.asarray(nn[best]), c, -1.0, (float(lb), float(ub)),
        ITERS)] for c in (jtr, jte)]
    prof = cohort_beta_profiles(jmodel, jnp.asarray(nn[best]), jte,
                                sigmas=jnp.asarray(fits[1][1]),
                                lower=float(lb) - 1.0, upper=float(ub) + 1.0,
                                steps=STEPS, use_pallas=False)
    ref = dict(objectives=objectives, best=best, bounds=(lb, ub), fits=fits,
               profile=np.asarray(prof.values),
               census_test=_counts(classify_identifiability(
                   find_confidence_intervals(prof, "raue95"))),
               nn_best=nn[best], cohort_test=pte)
    return port, ref


def test_reduced_frozen_pipeline_matches_jax(frozen):
    """Selection, the (β, σ) refit, the test profiles and their Raue-95
    census, and no census over all subjects."""
    port, ref = frozen
    np.testing.assert_allclose(port.val_objectives, ref["objectives"],
                               rtol=1e-4)
    assert port.best == ref["best"]
    np.testing.assert_allclose(port.bounds, ref["bounds"], rtol=1e-6)
    (b_tr, s_tr, _), (b_te, s_te, _) = ref["fits"]
    for got, want in ((port.b_train, b_tr), (port.b_test, b_te)):
        np.testing.assert_allclose(got, want, atol=2e-3)
    for got, want in ((port.s_train, s_tr), (port.s_test, s_te)):
        np.testing.assert_allclose(got, want, rtol=5e-3)
    np.testing.assert_allclose(port.profile.values.numpy(), ref["profile"],
                               rtol=2e-2)
    assert port.census_test == ref["census_test"]
    assert port.delta_profile is None and port.census_all == {}
    assert set(port.seconds) == {"select", "refit", "profile_test"}


def test_fit_betas_sigma_matches_jax(frozen):
    """(β, σ) re-estimation of the NS test subjects on the selected
    candidate, called directly, against the JAX package's fit."""
    _, ref = frozen
    b, s, o = (t.numpy() for t in ptrain.fit_betas_sigma(
        cp.CPeptideModel(chain(4, 2, input_dims=3), KIND),
        _t(ref["nn_best"]), ref["cohort_test"], initial_beta=-1.0,
        bounds=tuple(float(v) for v in ref["bounds"]), lbfgs_iters=ITERS))
    jb, js, jo = ref["fits"][1]
    np.testing.assert_allclose(o, jo, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b, jb, atol=2e-3)
    np.testing.assert_allclose(s, js, rtol=5e-3)


def test_params_from_jax_takes_the_covariate_candidates():
    nn, betas, idx_fit, orientations = load_candidates(CANDIDATES)
    assert nn.shape == (25, 41) and betas.shape == (25, 57, 1)
    assert idx_fit.shape == (57,) and orientations.shape == (25,)
    net = chain(4, 2, input_dims=3)
    params = params_from_jax(nn, net, "cpu")
    torch.testing.assert_close(params, torch.as_tensor(nn), rtol=0, atol=0)
    x = np.random.default_rng(2).uniform([-2, 0, 30], [8, 1, 70], (9, 3))
    out = net.scalar(params[16], _t(x)).numpy()
    ref = np.asarray(jax.vmap(lambda v: jax_chain(
        4, 2, "tanh", input_dims=3).scalar(jnp.asarray(nn[16]), v))(
            jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        params_from_jax(nn, chain(4, 2), "cpu")


def test_mismatched_kind_or_kinetics_width_raises():
    """A kind must match the network's input count, and every kernel wrapper
    refuses a kinetics width that does not match it, in either direction
    (``tests/test_pallas_covariate.py:126-137``)."""
    with pytest.raises(ValueError):
        cp.CPeptideModel(chain(4, 2, input_dims=3))
    with pytest.raises(ValueError):
        cp.CPeptideModel(chain(4, 2), KIND)
    with pytest.raises(ValueError):
        cp.CPeptideModel(chain(4, 2), "ude")
    with pytest.raises(ValueError):     # the covariate head needs the age
        cp.CPeptideModel(chain(4, 2, input_dims=3), KIND).production(
            torch.zeros(41), torch.zeros(3))
    g = torch.ones(4, 5)
    for input_dims, cols in ((3, 4), (2, 5)):
        net = chain(4, 2, input_dims=input_dims)
        nn = torch.zeros(2, net.num_params)
        with pytest.raises(ValueError, match="kinetics"):
            rk4_population.population_sse(net, nn, torch.zeros(2, 4), g, g,
                                          torch.ones(4, cols), TP)
        with pytest.raises(ValueError, match="kinetics"):
            lane_grad.lane_sse_and_grad(net, nn, torch.zeros(2, 4), g, g,
                                        torch.ones(4, cols), TP)
        with pytest.raises(ValueError, match="kinetics"):
            tsit5_cohort.cohort_sse_tsit5(net, nn, torch.zeros(2, 4), g, g,
                                          torch.ones(4, cols), TP)
        with pytest.raises(ValueError, match="kinetics"):
            rk4_cohort.cohort_sse(net, torch.zeros(4, net.num_params),
                                  torch.zeros(4), g, g, torch.ones(4, cols),
                                  TP)


def test_population_loss_of_the_covariate_model_matches_jax():
    """The plain RK4 population loss of the covariate model (the route of
    the eager β fits) against the JAX package's XLA loss."""
    train, _ = load_npz("artifacts/ohashi.npz")
    jc, pc = _real(train.subset(np.arange(6)))
    nets, betas, _, _ = load_candidates(CANDIDATES)
    jmodel = jcp.CPeptideModel(kind=KIND, net=jax_chain(4, 2, "tanh",
                                                        input_dims=3))
    for i in (0, 16):
        out = population_sse(cp.CPeptideModel(chain(4, 2, input_dims=3), KIND),
                             _t(nets[i]), _t(betas[i, :6, 0]), pc, substeps=8)
        ref = jax_population_sse(jmodel, jnp.asarray(nets[i]),
                                 jnp.asarray(betas[i, :6, 0]), jc,
                                 solver="rk4", substeps=8)
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-4)
