"""PyTorch port: the generic training route of ``train_conditional`` against
the JAX package's (``screen_path`` ``xla_vmap``, ``refine_path``
``xla_reverse_ad``, the route JAX takes wherever ``_pallas_eligible`` is
false and on every CPU), fed the JAX package's ``initial_designs``.

Five Ohashi training subjects, 32 designs in two screen chunks, 2
restarts, 5 Adam and 3 L-BFGS steps, RK4 at 4 substeps; the cases are two
conditional parameters (a 3-input ``conditional`` network, ``betas[..., N,
2]``), networks of another width with relu, gelu and sigmoid, the covariate
model at k = 2 and ``lbfgs_iters=0`` (the three networks of width 8 without
the Tsit5 re-rank, which the others run).  Tolerances: the screen rtol 1e-5
(the RK4 kernel's, ``tests/test_pallas_rk4.py:43``), the Adam trace rtol
1e-4, the objectives after L-BFGS and the re-rank rtol 5e-2 (as
``tests/test_torch_train.py``: float32 L-BFGS parts within a few steps, and
the re-rank's Tsit5 takes other steps than JAX's, F7).

Training with ``solver="tsit5"`` is held otherwise.  u0 is the kinetics'
fixed point, so the adaptive steps start from rounding noise (F7), and the
gradient through them moves with the steps: JAX's own gradient moves by up
to 105 % of a row's largest entry when u0 moves one float32 ulp
(``scripts/generic_reference.json``, ``G``).  So the
screen (values, no gradient) is held at the Tsit5 kernel's rtol 2e-2 +
atol 1e-3 (``tests/test_pallas_tsit5.py:53``), and the Adam trace and the
objectives to JAX's own spread, as ``tests/test_torch_tsit5.py``'s F7 test
holds the MSEs: JAX trains again with u0 one ulp away in each of four
directions, and the port's largest miss of JAX's unperturbed run must be
within twice JAX's largest move.

The generic route launches no kernel: each test replaces every kernel
wrapper by one that fails.  A canonical model still takes the kernel
route, and the generic route on a 2-way CPU mesh is held to unsharded at
``tests/test_parallel.py``'s rtol 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.fit import train as jtrain
from conditional_ude_tpu.fit.losses import population_sse as jax_population_sse
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu_torch.data.ohashi import load_npz
from conditional_ude_tpu_torch.fit import train as ptrain
from conditional_ude_tpu_torch.fit.losses import population_sse
from conditional_ude_tpu_torch.models import cpeptide as cp
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import (
    lane_grad,
    population_grad,
    rk4_cohort,
    rk4_population,
    tsit5_cohort,
)
from conditional_ude_tpu_torch.parallel import make_mesh

N = 5
KW = dict(initial_guesses=32, selected_initials=2, adam_iters=5,
          lbfgs_iters=3, screen_chunk=16, substeps=4)
# case -> (kind, width, depth, activation, input_dims, TrainConfig fields)
CASES = {
    "k2": ("conditional", 4, 2, "tanh", 3, {"n_conditional": 2}),
    "relu": ("conditional", 8, 2, "relu", 2, {"final_eval_tsit5": False}),
    "gelu": ("conditional", 8, 2, "gelu", 2, {"final_eval_tsit5": False}),
    "sigmoid": ("conditional", 8, 2, "sigmoid", 2,
                {"final_eval_tsit5": False}),
    "covariate_k2": ("conditional_covariate", 4, 2, "tanh", 4,
                     {"n_conditional": 2}),
    "lbfgs0": ("conditional", 8, 2, "relu", 2, {"lbfgs_iters": 0}),
}
KERNELS = ((rk4_population, "population_sse"),
           (lane_grad, "population_sse_and_grad"),
           (lane_grad, "lane_sse_and_grad"),
           (population_grad, "restart_sse_and_grad"),
           (tsit5_cohort, "screen_population_tsit5"),
           (tsit5_cohort, "cohort_sse_tsit5"),
           (rk4_cohort, "cohort_sse"))
MODULES = (rk4_cohort, rk4_population, lane_grad, tsit5_cohort,
           population_grad)
# u0 one float32 ulp up or down in each of its two entries
DIRECTIONS = ((np.inf, np.inf), (np.inf, -np.inf), (-np.inf, np.inf),
              (-np.inf, -np.inf))


@pytest.fixture
def no_kernels(monkeypatch):
    """Every kernel wrapper fails when called; the launch counts must not
    move."""
    def refuse(*args, **kwargs):
        raise AssertionError("the generic route called a kernel wrapper")

    for mod, name in KERNELS:
        monkeypatch.setattr(mod, name, refuse)
    before = [(m.launches, m.launches_age) for m in MODULES]
    yield
    assert [(m.launches, m.launches_age) for m in MODULES] == before


@pytest.fixture(scope="module")
def cohorts():
    train, _ = load_npz("artifacts/ohashi.npz")
    s = train.subset(np.arange(N))
    raw = (s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm)
    return jcp.build_cohort(*raw), cp.build_cohort(*raw, "cpu")


def _models(kind, width, depth, act, inputs):
    return (jcp.CPeptideModel(kind=kind, net=jax_chain(width, depth, act,
                                                       input_dims=inputs)),
            cp.CPeptideModel(chain(width, depth, act, input_dims=inputs),
                             kind))


def _jax_run(jmodel, jc, cfg):
    """JAX's training and its designs at key 0."""
    key = jax.random.key(0)
    return (jtrain.train_conditional(jmodel, jc, key, cfg),
            jtrain.initial_designs(jmodel.net, N, key, cfg))


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("case", CASES)
def test_generic_route_matches_jax(case, cohorts, no_kernels):
    kind, width, depth, act, inputs, extra = CASES[case]
    jmodel, model = _models(kind, width, depth, act, inputs)
    kw = {**KW, **extra}
    ref, designs = _jax_run(jmodel, cohorts[0], jtrain.TrainConfig(**kw))
    port = ptrain.train_conditional(model, cohorts[1],
                                    ptrain.TrainConfig(**kw), designs=designs)
    assert ref.timings["screen_path"] == "xla_vmap"
    assert (port.timings["screen_path"], port.timings["refine_path"]) == (
        "torch_batched", "autograd")
    k = kw.get("n_conditional", 1)
    assert port.betas.shape == ref.betas.shape == (2, N, k)
    assert port.nn_params.shape == ref.nn_params.shape
    np.testing.assert_allclose(port.screen_losses.numpy(),
                               np.asarray(ref.screen_losses), rtol=1e-5)
    np.testing.assert_allclose(port.loss_traces.numpy(),
                               np.asarray(ref.loss_traces), rtol=1e-4)
    np.testing.assert_allclose(port.objectives.numpy(),
                               np.asarray(ref.objectives), rtol=5e-2)
    if ref.orientations is None:
        assert port.orientations is None and k == 2
    else:
        np.testing.assert_array_equal(port.orientations.numpy(),
                                      np.asarray(ref.orientations))


def test_tsit5_training_within_jax_ulp_spread(cohorts, no_kernels):
    jc, pc = cohorts
    jmodel, model = _models("conditional", 4, 2, "tanh", 2)
    kw = {**KW, "solver": "tsit5"}
    cfg = jtrain.TrainConfig(**kw)
    ref, designs = _jax_run(jmodel, jc, cfg)
    u0 = np.asarray(jc.individuals.u0, np.float32)
    moved = [_jax_run(jmodel, jc._replace(individuals=jc.individuals._replace(
        u0=jnp.asarray(np.nextafter(u0, np.float32(d))))), cfg)[0]
        for d in DIRECTIONS]
    port = ptrain.train_conditional(model, pc, ptrain.TrainConfig(**kw),
                                    designs=designs)
    assert port.timings["refine_path"] == "autograd"
    # the trained objectives are Tsit5's: no re-rank
    assert port.timings["final_eval"] < 1e-3
    np.testing.assert_allclose(port.screen_losses.numpy(),
                               np.asarray(ref.screen_losses), rtol=2e-2,
                               atol=1e-3)
    for field in ("loss_traces", "objectives"):
        miss = _rel(getattr(port, field), getattr(ref, field))
        spread = max(_rel(getattr(r, field), getattr(ref, field))
                     for r in moved)
        assert miss <= 2 * spread, (field, miss, spread)
    np.testing.assert_array_equal(port.orientations.numpy(),
                                  np.asarray(ref.orientations))


def test_generic_route_on_a_cpu_mesh_matches_unsharded(cohorts, no_kernels):
    """The restarts (3, padded to 4) and the designs split over a 2-way
    mesh of the CPU, gathered in order."""
    _, model = _models("conditional", 4, 2, "tanh", 3)
    cfg = ptrain.TrainConfig(**{**KW, "n_conditional": 2,
                                "selected_initials": 3})
    one = ptrain.train_conditional(model, cohorts[1], cfg, seed=5)
    two = ptrain.train_conditional(model, cohorts[1], cfg, seed=5,
                                   mesh=make_mesh(("restarts",),
                                                  devices=["cpu"] * 2))
    assert (two.timings["screen_path"], two.timings["refine_path"]) == (
        "torch_batched+mesh2", "autograd+mesh2")
    np.testing.assert_array_equal(two.screen_losses.numpy(),
                                  one.screen_losses.numpy())
    np.testing.assert_allclose(two.objectives.numpy(),
                               one.objectives.numpy(), rtol=5e-3)
    np.testing.assert_allclose(two.loss_traces.numpy(),
                               one.loss_traces.numpy(), rtol=5e-3)
    assert two.betas.shape == (3, N, 2) and two.orientations is None


@pytest.mark.parametrize("kind,inputs", [("conditional", 2),
                                         ("conditional_covariate", 3)])
def test_canonical_model_keeps_the_kernel_route(kind, inputs, cohorts):
    """The canonical cUDE and covariate model at RK4 train through the
    kernels' plain versions on the CPU, as before."""
    _, model = _models(kind, 4, 2, "tanh", inputs)
    cfg = ptrain.TrainConfig(**KW)
    assert ptrain.kernels_compute(model, cfg)
    res = ptrain.train_conditional(model, cohorts[1], cfg, seed=3)
    assert (res.timings["screen_path"], res.timings["refine_path"]) == (
        "plain", "plain")
    assert res.betas.shape == (2, N, 1) and res.orientations.shape == (2,)


def test_route_follows_model_and_config():
    """The kernel route takes exactly what the JAX package's
    ``_pallas_eligible`` takes: a network of tanh hidden layers (any widths
    and depth) with a softplus head, one conditional parameter, RK4."""
    cfg = ptrain.TrainConfig()
    canonical = cp.CPeptideModel(chain(4, 2))
    covariate = cp.CPeptideModel(chain(4, 2, input_dims=3),
                                 "conditional_covariate")
    kernel_side = [(canonical, cfg), (covariate, cfg),
                   (cp.CPeptideModel(chain(8, 2)), cfg),
                   (cp.CPeptideModel(chain(4, 3)), cfg)]
    generic_side = [
        (canonical, dataclasses.replace(cfg, solver="tsit5")),
        (cp.CPeptideModel(chain(4, 2, input_dims=3)),
         dataclasses.replace(cfg, n_conditional=2)),
        (cp.CPeptideModel(chain(4, 2, "relu")), cfg),
        (cp.CPeptideModel(chain(4, 2, "gelu")), cfg),
        (cp.CPeptideModel(chain(4, 2, output_activation="identity")), cfg)]
    for side, models in ((True, kernel_side), (False, generic_side)):
        for model, c in models:
            assert ptrain.kernels_compute(model, c) == side
            jmodel = jcp.CPeptideModel(kind=model.kind, net=jax_chain(
                list(model.net.widths), activation=model.net.activations[0],
                input_dims=model.net.input_dims,
                output_activation=model.net.output_activation))
            jcfg = jtrain.TrainConfig(solver=c.solver,
                                      n_conditional=c.n_conditional)
            assert jtrain._pallas_eligible(jmodel, jcfg) == side


@pytest.mark.parametrize("solver", ["rk4", "tsit5"])
def test_k_conditional_lanes_match_jax(solver, cohorts):
    """``betas[R, N, k]`` through ``population_sse`` and one individual's
    ``simulate`` (``betas[..., k]``), k = 2 and 3, against JAX's vmapped
    losses (RK4 rtol 1e-5, Tsit5 rtol 2e-2 + atol 1e-3)."""
    jc, pc = cohorts
    rng = np.random.default_rng(4)
    tol = (dict(rtol=1e-5) if solver == "rk4"
           else dict(rtol=2e-2, atol=1e-3))
    for kind, inputs, k in (("conditional", 3, 2), ("conditional", 4, 3),
                            ("conditional_covariate", 4, 2)):
        jmodel, model = _models(kind, 4, 2, "tanh", inputs)
        assert model.n_conditional == k
        nn = rng.normal(0, 0.5, (3, model.net.num_params)).astype(np.float32)
        b = rng.uniform(-2, 0, (3, N, k)).astype(np.float32)
        ref = np.asarray(jax.vmap(lambda a, c: jax_population_sse(
            jmodel, a, c, jc, solver=solver, substeps=4))(
                jnp.asarray(nn), jnp.asarray(b)))
        got = population_sse(model, torch.as_tensor(nn)[:, None, :],
                             torch.as_tensor(b), pc, solver=solver,
                             substeps=4).numpy()
        np.testing.assert_allclose(got, ref, **tol)
        one = dataclasses.replace(pc, **{
            f: getattr(pc, f)[:1] for f in ("glucose", "cpeptide", "age",
                                            "k0", "k1", "k2", "c0")})
        ys = cp.simulate(model, torch.as_tensor(nn[0]),
                         torch.as_tensor(b[:, 0]), one, pc.timepoints,
                         solver=solver, substeps=4).ys
        whole = cp.simulate_cohort(model, torch.as_tensor(nn[0]),
                                   torch.as_tensor(b[:, :1]), one,
                                   solver=solver, substeps=4).ys[:, 0]
        assert ys.shape == (3, pc.timepoints.shape[0], 2)
        torch.testing.assert_close(ys, whole, rtol=0, atol=0)
