"""PyTorch port: the device mesh (``parallel/mesh.py``) on the CPU, each case
of ``tests/test_parallel.py`` at that file's own shapes, on meshes of
``["cpu"] * k``.

Where a sharded result is a set of independent lanes (the screen, the
profiles on both routes, the population loss, SAEM, the suppression sweep)
it is held to the unsharded port bit for bit (``assert_array_equal``): the
rows split over the shards and gather in order, and every row's arithmetic
is the unsharded one.  Elsewhere the tolerances are ``test_parallel.py``'s:
the screen rtol 2e-3 and the training objectives rtol 5e-3, the trained
β's atol 5e-3; SAEM's ``nll_trace`` atol 1e-4 and θ atol 1e-5; the
suppression sweep's objectives rtol 5e-2 + atol 1e-4 and θ's rtol 1e-1 +
atol 1.5e-1; the β and (β, σ) fits β and σ atol 2e-3, objectives rtol
2e-3 + atol 1e-5.  The fits are autograd through the batched RK4, and on
the CPU PyTorch's vectorised kernels sum a broadcast gradient in an order
that depends on the number of rows, so a shard's gradients sit a few
float32 roundings from the whole batch's (on the card they are equal:
``chip_smoke.py``'s mesh path holds the refit of 117 bit for bit).
``sharded_fit_betas`` and ``sharded_beta_profiles`` are also held to the
JAX package's unsharded ``fit_betas`` (β atol 2e-3, objectives rtol 2e-3 +
atol 1e-5) and ``cohort_beta_profiles`` (rtol 1e-4; the kernel route rtol
2e-4 + atol 1e-5).  ``test_parallel.py``'s checkpoint case is not
repeated: the port's checkpoint has its round trip in
``tests/test_torch_exp02_outputs.py``.  Its mesh-shape and padding cases
are ``tests/test_torch_mesh_helpers.py``, and ``dryrun_mesh`` is
``tests/test_torch_mesh_dryrun.py``: several test processes share them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu_torch.analysis.profiles import cohort_beta_profiles
from conditional_ude_tpu_torch.fit import train as ptrain
from conditional_ude_tpu_torch.fit.losses import population_sse
from conditional_ude_tpu_torch.fit.saem import SAEMConfig, saem_cude
from conditional_ude_tpu_torch.models import suppression as sup
from conditional_ude_tpu_torch.models.cpeptide import CPeptideModel, build_cohort
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.parallel import (
    make_mesh,
    shard_cohort,
    sharded_beta_profiles,
    sharded_fit_betas,
    sharded_screen,
)

TP = np.array([0.0, 30.0, 60.0, 90.0, 120.0])
MODEL = CPeptideModel(chain(4, 2))
JMODEL = jcp.CPeptideModel(kind="conditional",
                           net=jax_chain(4, 2, "tanh", input_dims=2))


def cpus(k=8):
    return make_mesh(("individuals",), devices=["cpu"] * k)


def raw_cohort(rng, n):
    """``test_parallel.py::_synthetic_cohort``'s arrays."""
    return (5 + rng.uniform(0, 5, (n, 5)), TP,
            0.5 + rng.uniform(0, 1.5, (n, 5)), rng.uniform(30, 70, n),
            np.zeros(n, bool))


def cohort_of(rng, n):
    return build_cohort(*raw_cohort(rng, n), "cpu")


def glorot(rng, k=None):
    """Glorot-uniform weights of chain(4, 2), biases 0 (numpy)."""
    parts = []
    for fi, fo in MODEL.net.layer_dims:
        lim = np.sqrt(6.0 / (fi + fo))
        parts += [rng.uniform(-lim, lim, (k or 1, fo * fi)),
                  np.zeros((k or 1, fo))]
    flat = np.concatenate(parts, 1).astype(np.float32)
    return flat if k else flat[0]


def equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shards", [8, 3])
def test_sharded_loss_matches_unsharded(rng, shards):
    """8 subjects over 8 shards, and over 3 (uneven: 3, 3 and 2)."""
    n = 8
    cohort = cohort_of(rng, n)
    nn = torch.as_tensor(glorot(rng))
    betas = torch.full((n,), -1.0)
    plain = population_sse(MODEL, nn, betas, cohort)
    sharded_cohort = shard_cohort(cohort, cpus(shards), "individuals")
    assert [c.n for c in sharded_cohort.shards] == (
        [1] * 8 if shards == 8 else [3, 3, 2])
    equal(population_sse(MODEL, nn, betas, sharded_cohort), plain)
    equal(sharded_cohort.whole().glucose, cohort.glucose)


def test_saem_sharded_matches_unsharded(rng):
    n = 8
    cohort = cohort_of(rng, n)
    nn0 = torch.as_tensor(glorot(rng))
    cfg = SAEMConfig(iterations=4, burnin=2, n_mcmc_steps=2)
    plain = saem_cude(MODEL, cohort, nn0, torch.Generator().manual_seed(1),
                      cfg)
    sharded = saem_cude(MODEL, shard_cohort(cohort, cpus(2), "individuals"),
                        nn0, torch.Generator().manual_seed(1), cfg)
    assert sharded.route == "plain_k4_k2+mesh2"
    np.testing.assert_allclose(sharded.nll_trace.numpy(),
                               plain.nll_trace.numpy(), atol=1e-4)
    np.testing.assert_allclose(sharded.theta.numpy(), plain.theta.numpy(),
                               atol=1e-5)
    equal(sharded.nll_trace, plain.nll_trace)     # lanes are independent


def _train_both(cohort, cfg, mesh, seed):
    plain = ptrain.train_conditional(MODEL, cohort, cfg, seed=seed)
    sharded = ptrain.train_conditional(MODEL, cohort, cfg, seed=seed,
                                       mesh=mesh)
    return plain, sharded


def _check_training(plain, sharded, betas_atol=None):
    np.testing.assert_allclose(sharded.screen_losses.numpy(),
                               plain.screen_losses.numpy(), rtol=2e-3)
    np.testing.assert_allclose(np.sort(sharded.objectives.numpy()),
                               np.sort(plain.objectives.numpy()), rtol=5e-3)
    if betas_atol:
        np.testing.assert_allclose(np.sort(sharded.betas.numpy(), axis=None),
                                   np.sort(plain.betas.numpy(), axis=None),
                                   atol=betas_atol)
    assert sharded.nn_params.shape == plain.nn_params.shape
    assert sharded.loss_traces.shape == plain.loss_traces.shape


def test_train_conditional_mesh_parity_realistic_shape(rng):
    """82 subjects, 256 designs, 8 restarts on a 2-D (4 × 2) mesh: the
    restarts split over the 4 rows, each on its row's first device."""
    cohort = cohort_of(rng, 82)
    cfg = ptrain.TrainConfig(initial_guesses=256, selected_initials=8,
                             adam_iters=5, lbfgs_iters=5, screen_chunk=256,
                             final_eval_tsit5=False)
    mesh = make_mesh(("restarts", "individuals"), (4, 2), devices=["cpu"] * 8)
    plain, sharded = _train_both(cohort, cfg, mesh, 3)
    _check_training(plain, sharded)
    assert sharded.timings["screen_path"] == "plain+mesh4"
    assert sharded.timings["refine_path"] == "plain+mesh4"
    equal(sharded.screen_losses, plain.screen_losses)


def test_sharded_fit_betas_parity(rng):
    """11 subjects over 2 shards (the pad path), within test_parallel.py's
    tolerances of the unsharded port and of the JAX package's unsharded
    fit, on test_parallel.py's network."""
    raw = raw_cohort(rng, 11)
    cohort = build_cohort(*raw, "cpu")
    nn = np.array(JMODEL.net.init(jax.random.key(5)))  # test_parallel.py's
    mesh = cpus(2)
    b0, o0 = ptrain.fit_betas(MODEL, torch.as_tensor(nn), cohort,
                              lbfgs_iters=60)
    b1, o1 = sharded_fit_betas(MODEL, torch.as_tensor(nn), cohort, mesh,
                               lbfgs_iters=60)
    assert b1.shape == (11,)
    np.testing.assert_allclose(b1.numpy(), b0.numpy(), atol=2e-3)
    np.testing.assert_allclose(o1.numpy(), o0.numpy(), rtol=2e-3, atol=1e-5)
    from conditional_ude_tpu.fit.train import fit_betas as jax_fit_betas
    jb, jo = map(np.asarray, jax_fit_betas(JMODEL, jnp.asarray(nn),
                                           jcp.build_cohort(*raw),
                                           lbfgs_iters=60))
    np.testing.assert_allclose(b1.numpy(), jb, atol=2e-3)
    np.testing.assert_allclose(o1.numpy(), jo, rtol=2e-3, atol=1e-5)

    bs0, ss0, os0 = ptrain.fit_betas_sigma(MODEL, torch.as_tensor(nn),
                                           cohort, lbfgs_iters=60)
    bs1, ss1, os1 = sharded_fit_betas(MODEL, torch.as_tensor(nn), cohort,
                                      mesh, sigma=True, lbfgs_iters=60)
    np.testing.assert_allclose(bs1.numpy(), bs0.numpy(), atol=2e-3)
    np.testing.assert_allclose(ss1.numpy(), ss0.numpy(), atol=2e-3)


@pytest.mark.parametrize("kernel", [False, True])
def test_sharded_beta_profiles_parity(rng, kernel):
    """6 subjects over 8 shards with per-subject Δβ centres: the batched
    RK4 scan (a relu network, which K4 does not compute, against JAX's
    ``use_pallas=False``) and K4's route (the canonical tanh network,
    ``require_kernel=True``, the Pallas case), each bit for bit against
    the unsharded port and close to JAX's unsharded XLA scan."""
    from conditional_ude_tpu.analysis import cohort_beta_profiles as jprof
    raw = raw_cohort(rng, 6)
    nn = glorot(rng)
    if kernel:
        model, jmodel = MODEL, JMODEL
        centers = np.linspace(-1.2, -0.4, 6, dtype=np.float32)
        kw = dict(lower=-2.0, upper=2.0, steps=32, chunk=16)
        tol = dict(rtol=2e-4, atol=1e-5)
    else:
        model = CPeptideModel(chain(4, 2, "relu"))
        jmodel = jcp.CPeptideModel(kind="conditional", net=jax_chain(
            4, 2, "relu", input_dims=2))
        centers = np.linspace(-1.5, -0.5, 6, dtype=np.float32)
        kw = dict(lower=-2.0, upper=2.0, steps=64)
        tol = dict(rtol=1e-4)
    cohort = build_cohort(*raw, "cpu")
    p0 = cohort_beta_profiles(model, torch.as_tensor(nn), cohort,
                              center=torch.as_tensor(centers),
                              require_kernel=kernel, **kw)
    p1 = sharded_beta_profiles(model, torch.as_tensor(nn), cohort, cpus(),
                               center=centers, require_kernel=kernel, **kw)
    assert p1.values.shape == (6, kw["steps"])
    equal(p1.values, p0.values)
    equal(p1.minimum, p0.minimum)
    ref = jprof(jmodel, jnp.asarray(nn), jcp.build_cohort(*raw),
                center=jnp.asarray(centers), use_pallas=False, **kw)
    np.testing.assert_allclose(p1.values.numpy(), np.asarray(ref.values),
                               **tol)


def test_sharded_beta_profiles_refuses_forced_kernel(rng):
    relu = CPeptideModel(chain(4, 2, "relu"))
    with pytest.raises(ValueError):
        sharded_beta_profiles(relu, torch.as_tensor(glorot(rng)),
                              cohort_of(rng, 6), cpus(), steps=8,
                              require_kernel=True)


def test_sharded_screen_matches_unsharded(rng):
    """K1's plain version on 2 restart shards of 16 designs (the screen of
    ``dryrun_multichip``), bit for bit."""
    from conditional_ude_tpu_torch.ops import rk4_population
    from conditional_ude_tpu_torch.parallel.mesh import cohort_args
    cohort = cohort_of(rng, 5)
    nn = torch.as_tensor(glorot(rng, 16))
    betas = torch.as_tensor(rng.uniform(-2, 0, (16, 5)), dtype=torch.float32)
    mesh = make_mesh(("restarts",), devices=["cpu"] * 2)
    plain = rk4_population.population_sse(MODEL.net, nn, betas,
                                          *cohort_args(cohort, False))
    equal(sharded_screen(MODEL.net, nn, betas, cohort, mesh), plain)


def test_suppression_sweep_mesh_parity():
    """36 designs and 2 λ × 3 restarts = 6 lanes over 5 shards: both pad.
    5 shards and 5 Adam and 5 L-BFGS steps where test_parallel.py takes 8
    and 20 and 20: on the CPU a shard costs as many operations as the
    unsharded run, and the rows are bit for bit equal at any depth."""
    rng = np.random.default_rng(11)
    tp = np.linspace(0.0, 30.0, 6)
    data, _ = sup.generate_data([0.5, 5.0, 12.5], [2] * 3, tp,
                                noise_multiplicative=0.05, rng=rng)
    net = sup.suppression_net(depth=3, width=3)
    lambdas = np.asarray([0.0, 0.1], np.float32)
    cfg = sup.SuppressionFitConfig(initial_space=36, select_best_n=3,
                                   adam_iters=5, lbfgs_iters=5,
                                   screen_chunk=36)
    designs = sup.initial_designs(net, 36, data.shape[0],
                                  torch.Generator().manual_seed(2))
    plain = sup.fit_suppression_sweep(net, data, tp, lambdas, cfg,
                                      designs=designs)
    sharded = sup.fit_suppression_sweep(
        net, data, tp, lambdas, cfg, designs=designs,
        mesh=make_mesh(("restarts",), devices=["cpu"] * 5))
    assert sharded.objectives.shape == plain.objectives.shape == (2, 3)
    np.testing.assert_allclose(sharded.objectives.numpy(),
                               plain.objectives.numpy(), rtol=5e-2,
                               atol=1e-4)
    np.testing.assert_allclose(sharded.thetas.numpy(), plain.thetas.numpy(),
                               rtol=1e-1, atol=1.5e-1)
    equal(sharded.designs, plain.designs)
    equal(sharded.objectives, plain.objectives)


def test_train_conditional_fused_mesh_parity(rng):
    """5 subjects, 16 designs, 3 restarts over 8 shards (the pad path),
    2 substeps, the Tsit5 re-rank."""
    cohort = cohort_of(rng, 5)
    cfg = ptrain.TrainConfig(initial_guesses=16, selected_initials=3,
                             adam_iters=4, lbfgs_iters=4, substeps=2,
                             screen_chunk=16, max_steps=64)
    mesh = make_mesh(("restarts",), devices=["cpu"] * 8)
    plain, sharded = _train_both(cohort, cfg, mesh, 7)
    _check_training(plain, sharded, betas_atol=5e-3)
    assert sharded.objectives.shape == (3,)
    assert sharded.screen_losses.shape == (16,)
    assert sharded.timings["refine_path"] == "plain+mesh8"


def test_train_conditional_mesh_nondivisible_individuals(rng):
    """5 subjects on a (4 × 2) mesh: the individuals stay whole on each
    restart shard, so nothing re-weights the population mean."""
    cohort = cohort_of(rng, 5)
    cfg = ptrain.TrainConfig(initial_guesses=16, selected_initials=4,
                             adam_iters=3, lbfgs_iters=3, screen_chunk=16,
                             max_steps=64, final_eval_tsit5=False)
    mesh = make_mesh(("restarts", "individuals"), (4, 2), devices=["cpu"] * 8)
    plain, sharded = _train_both(cohort, cfg, mesh, 5)
    np.testing.assert_allclose(np.sort(sharded.objectives.numpy()),
                               np.sort(plain.objectives.numpy()), rtol=5e-3)
