"""PyTorch port: the routes to the kernels at every network the JAX
kernels take, and the library shapes that serve them.

* ``fit/train.py::kernels_compute`` equals the JAX package's
  ``_pallas_eligible``, and ``analysis/profiles.py::fused_kernel_eligible``
  the JAX package's ``fused_kernel_eligible``, over a grid of widths,
  depths, activations, heads, kinds, input counts, k and solvers: no width
  is exempt.
* ``train_conditional`` at W = ``chain(8, 2)`` takes the kernel route's
  plain versions on the CPU (``screen_path`` ``"plain"``) and matches JAX's
  ``train_conditional`` (``use_pallas=False`` on the CPU) from JAX's own
  designs: the screen within rtol 1e-5, the Adam trace within rtol 1e-4.
* ``cohort_beta_profiles`` at D = ``chain(4, 3)`` takes the fused route
  (K4's plain version on the CPU) and matches JAX's at rtol 1e-4.
* ``params_from_jax`` carries a depth-3 network and a widths vector by
  value, and the port's network then gives JAX's outputs.
* ``ops/cuda_build.py`` keeps one library a (body, network shape): its own
  name, its own widths header, the canonical command unchanged.
* K2's and K5's plain versions at ``chain(20, 2)``, whose gradient the
  kernels sum in passes, match autograd.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.analysis import profiles as jprof
from conditional_ude_tpu.fit import train as jtrain
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu_torch.analysis import profiles as prof
from conditional_ude_tpu_torch.convert import params_from_jax
from conditional_ude_tpu_torch.data.ohashi import load_npz
from conditional_ude_tpu_torch.fit import train as ptrain
from conditional_ude_tpu_torch.models import cpeptide as cp
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import (
    cuda_build,
    lane_grad,
    population_grad,
    rk4_cohort,
    rk4_population,
)

N = 5
KW = dict(initial_guesses=32, selected_initials=2, adam_iters=10,
          lbfgs_iters=3, screen_chunk=16, substeps=4)
WIDTHS = ((4, 4), (8, 8), (4, 4, 4), (6, 3), (5,))
ACTIVATIONS = ("tanh", "relu", "gelu")
HEADS = ("softplus", "identity")
# (kind, input count): each kind at k = 1 and k = 2 conditional parameters
KINDS = (("conditional", 2), ("conditional", 3),
         ("conditional_covariate", 3), ("conditional_covariate", 4))


@pytest.fixture(scope="module")
def cohorts():
    train, _ = load_npz("artifacts/ohashi.npz")
    s = train.subset(np.arange(N))
    raw = (s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm)
    return jcp.build_cohort(*raw), cp.build_cohort(*raw, "cpu")


def _models(kind, widths, act, inputs, head="softplus"):
    return (jcp.CPeptideModel(kind=kind, net=jax_chain(
                list(widths), activation=act, input_dims=inputs,
                output_activation=head)),
            cp.CPeptideModel(chain(list(widths), activation=act,
                                   input_dims=inputs,
                                   output_activation=head), kind))


def _grid():
    for widths, act, head, (kind, inputs) in itertools.product(
            WIDTHS, ACTIVATIONS, HEADS, KINDS):
        yield _models(kind, widths, act, inputs, head)


@pytest.mark.parametrize("solver", ["rk4", "tsit5"])
def test_kernels_compute_equals_pallas_eligible(solver):
    """Every model of the grid at k = 1 and 2 and ``solver``: the port's
    training route is the JAX package's."""
    taken = 0
    for (jmodel, model), k in itertools.product(_grid(), (1, 2)):
        jcfg = jtrain.TrainConfig(solver=solver, n_conditional=k)
        cfg = ptrain.TrainConfig(solver=solver, n_conditional=k)
        want = jtrain._pallas_eligible(jmodel, jcfg)
        assert ptrain.kernels_compute(model, cfg) == want, (
            model.kind, model.net, k, solver)
        taken += want
    # tanh, softplus, k = 1 and RK4: every width, both kinds
    assert taken == (len(WIDTHS) * 2 if solver == "rk4" else 0)


@pytest.mark.parametrize("solver_kwargs", [{}, {"substeps": 4},
                                           {"max_steps": 64}])
def test_fused_kernel_eligible_equals_jax(solver_kwargs):
    """Every model of the grid, and the UDE's network: the port's profile
    route is the JAX package's."""
    models = list(_grid()) + [
        (jcp.CPeptideModel(kind="ude", net=jax_chain(4, 2, input_dims=1)),
         cp.CPeptideModel(chain(4, 2, input_dims=1), "ude"))]
    taken = 0
    for jmodel, model in models:
        want = jprof.fused_kernel_eligible(jmodel, solver_kwargs)
        assert prof.fused_kernel_eligible(model, solver_kwargs) == want, (
            model.kind, model.net, solver_kwargs)
        taken += want
    assert taken == (0 if "max_steps" in solver_kwargs else len(WIDTHS) * 2)


def test_training_at_w_takes_the_kernel_route_and_matches_jax(cohorts):
    """W on 5 subjects from JAX's designs at key 0: 32 designs screened, 2
    restarts of 10 Adam and 3 L-BFGS steps, RK4 at 4 substeps, then the
    Tsit5 re-rank."""
    jc, pc = cohorts
    jmodel, model = _models("conditional", (8, 8), "tanh", 2)
    jcfg = jtrain.TrainConfig(**KW)
    assert jtrain._pallas_eligible(jmodel, jcfg)
    key = jax.random.key(0)
    ref = jtrain.train_conditional(jmodel, jc, key, jcfg)
    designs = jtrain.initial_designs(jmodel.net, N, key, jcfg)
    before = (rk4_population.launches, lane_grad.launches)
    port = ptrain.train_conditional(model, pc, ptrain.TrainConfig(**KW),
                                    designs=designs)
    assert ref.timings["screen_path"] == "xla_vmap"
    assert (port.timings["screen_path"], port.timings["refine_path"]) == (
        "plain", "plain")
    assert (rk4_population.launches, lane_grad.launches) == before
    np.testing.assert_allclose(port.screen_losses.numpy(),
                               np.asarray(ref.screen_losses), rtol=1e-5)
    np.testing.assert_allclose(port.loss_traces.numpy(),
                               np.asarray(ref.loss_traces), rtol=1e-4)
    np.testing.assert_allclose(port.objectives.numpy(),
                               np.asarray(ref.objectives), rtol=5e-2)
    np.testing.assert_array_equal(port.orientations.numpy(),
                                  np.asarray(ref.orientations))


def test_profiles_at_d_take_the_fused_route_and_match_jax(cohorts):
    """D = ``chain(4, 3)``: the β profiles of 5 subjects, 50 grid points in
    chunks of 20, through K4's plain version, against JAX's XLA route."""
    jc, pc = cohorts
    jmodel, model = _models("conditional", (4, 4, 4), "tanh", 2)
    assert prof.fused_kernel_eligible(model)
    assert jprof.fused_kernel_eligible(jmodel, {})
    nn = np.array(jmodel.net.init(jax.random.key(3)), np.float32) * 1.5
    sig = np.linspace(0.5, 1.5, N).astype(np.float32)
    before = rk4_cohort.launches
    out = prof.cohort_beta_profiles(model, torch.as_tensor(nn), pc,
                                    sigmas=sig, lower=-3.0, upper=1.0,
                                    steps=50, chunk=20, require_kernel=True)
    assert rk4_cohort.launches == before
    ref = jprof.cohort_beta_profiles(jmodel, jnp.asarray(nn), jc,
                                     sigmas=jnp.asarray(sig), lower=-3.0,
                                     upper=1.0, steps=50, chunk=20,
                                     use_pallas=False)
    assert out.values.shape == (N, 50)
    np.testing.assert_allclose(out.values.numpy(), np.asarray(ref.values),
                               rtol=1e-4)
    np.testing.assert_allclose(out.minimum.numpy(), np.asarray(ref.minimum),
                               rtol=1e-4)


@pytest.mark.parametrize("widths,inputs", [((4, 4, 4), 2), ((6, 3), 3)])
def test_weights_carry_across_by_value(widths, inputs):
    """A depth-3 network and a widths vector: ``params_from_jax`` keeps
    JAX's flat layout, and the port's network gives JAX's outputs."""
    jnet = jax_chain(list(widths), activation="tanh", input_dims=inputs)
    net = chain(list(widths), activation="tanh", input_dims=inputs)
    flat = np.array(jnet.init_batch(jax.random.key(9), 3), np.float32)
    got = params_from_jax(flat, net, "cpu")
    assert got.shape == (3, net.num_params) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), flat)
    x = np.random.default_rng(2).normal(size=(7, inputs)).astype(np.float32)
    for row in range(3):
        want = np.asarray(jnet.apply(jnp.asarray(flat[row]), jnp.asarray(x)))
        np.testing.assert_allclose(
            net(got[row], torch.as_tensor(x)).numpy(), want, rtol=1e-5,
            atol=1e-6)
    with pytest.raises(ValueError):
        params_from_jax(flat[:, 1:], net, "cpu")


def test_a_library_for_each_network_shape():
    """One library a (body, shape): the canonical command is the one the
    bodies always had, another shape's includes its generated widths
    header and hashes its widths into its name; ``at`` keeps one instance
    a shape."""
    src = rk4_cohort.kernel.source
    canonical = cuda_build.library_path(src)
    assert cuda_build.library_path(src, (4, 4)) == canonical
    wide = cuda_build.library_path(src, (8, 8))
    deep = cuda_build.library_path(src, (8, 8, 8))
    assert len({canonical, wide, deep}) == 3
    assert wide.name.startswith("rk4_cohort-w8_8-")
    cmd = cuda_build.nvcc_command(src, wide, (8, 8))
    header = cuda_build.widths_header((8, 8))
    assert cmd[cmd.index("-include") + 1] == str(header)
    assert header.parent == cuda_build.BUILD_DIR
    assert "-include" not in cuda_build.nvcc_command(src, canonical)
    lib = rk4_cohort.kernel.at((8, 8))
    assert lib is rk4_cohort.kernel.at([8, 8]) and lib.widths == (8, 8)
    assert lib.name == rk4_cohort.kernel.name and lib.source == src
    assert rk4_cohort.kernel.at((4, 4)) is rk4_cohort.kernel
    assert rk4_cohort.kernel_age.at((8, 8)) is not lib


def test_gradient_past_one_pass_matches_autograd(cohorts):
    """``chain(20, 2)``'s 501 weights, whose gradient K2 and K5 sum in 4
    passes of 128 columns on the card: the plain versions of both (the
    kernels' order at any width) against autograd through the generic
    route's RK4 on 3 restarts of 5 subjects, the value within rtol 1e-4 and
    each gradient row within 2e-4 of its largest entry."""
    from conditional_ude_tpu_torch.fit.losses import population_sse

    _, cohort = cohorts
    net = chain(20, 2)
    rng = np.random.default_rng(11)
    nn = torch.as_tensor(rng.uniform(-0.3, 0.3, (3, net.num_params)),
                         dtype=torch.float32)
    betas = torch.as_tensor(rng.uniform(-2.0, 0.0, (3, N)),
                            dtype=torch.float32)
    x, b = nn.clone().requires_grad_(True), betas.clone().requires_grad_(True)
    f_ad = population_sse(cp.CPeptideModel(net), x[:, None, :], b, cohort,
                          substeps=8)
    f_ad.sum().backward()
    args = (nn, betas, cohort.glucose, cohort.cpeptide, cohort.kinetics(),
            tuple(float(t) for t in cohort.timepoints), 8)
    for f, gnn, gb in (lane_grad.packed_sse_and_grad(net, *args),
                       population_grad.restart_sse_and_grad(net, *args)):
        torch.testing.assert_close(f, f_ad.detach(), rtol=1e-4, atol=0)
        for got, ref in ((gnn, x.grad), (gb, b.grad)):
            scale = ref.abs().amax(-1, keepdim=True).clamp_min(1e-6)
            assert float(((got - ref) / scale).abs().max()) <= 2e-4
