"""PyTorch port: the JAX package's solver options outside training, and the
activations it has, against the JAX package on the CPU.

* ``gelu`` (``jax.nn.gelu``'s tanh approximation) and ``sigmoid`` in
  ``MLP.apply``, at ``tests/test_torch_nn.py``'s rtol 1e-6 + atol 1e-6;
* ``fit_betas``, ``fit_betas_sigma``, ``evaluate_model`` and ``train_ude``
  with ``solver="tsit5"`` and ``max_steps``, on six Ohashi test subjects at
  exp02's committed best candidate (row 19 of
  ``artifacts/cude_neural_parameters.npz``);
* ``cohort_beta_profiles`` with Tsit5's rtol and atol;
* ``log_every`` of Adam and SAEM.

Tsit5 starts from the kinetics' fixed point, where its first error estimate
is rounding noise (F7), and the gradient through the adaptive steps moves
with the steps: JAX's own (β, σ) fit of the 35 test subjects moves β by up
to 1.54 after 2 L-BFGS steps when u0 moves one float32 ulp
(``scripts/generic_reference.json``, ``C``), and an objective at a fit's
start (no step) by a few per cent, where the Tsit5 kernel's rtol 2e-2 +
atol 1e-3 (``tests/test_pallas_tsit5.py:53``) does not hold.  So the fits and ``train_ude`` are held to JAX's
own spread, as ``tests/test_torch_tsit5.py``'s F7 test holds the MSEs: JAX
fits again with u0 one ulp away in each of four directions, and the port's
largest miss of JAX's unperturbed fit must be within twice JAX's largest
move; a screen of designs (values only) is held at the kernel's
tolerance, and ``train_ude``'s objectives are each the Tsit5 SSE of its
network, JAX's among them.  At rtol 1e-6 and atol 1e-9 both solvers
are accurate to far below F7's noise, and the profiles are held at rtol
1e-3 (measured 3.2e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.analysis import cohort_beta_profiles as jax_profiles
from conditional_ude_tpu.fit import train as jtrain
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu_torch.analysis.profiles import (
    cohort_beta_profiles,
    fused_kernel_eligible,
)
from conditional_ude_tpu_torch.data.ohashi import load_npz
from conditional_ude_tpu_torch.fit import train as ptrain
from conditional_ude_tpu_torch.fit.losses import sse as cp_sse
from conditional_ude_tpu_torch.fit.optim import adam_minimize
from conditional_ude_tpu_torch.fit.saem import LogLik, SAEMConfig, run_saem
from conditional_ude_tpu_torch.models import cpeptide as cp
from conditional_ude_tpu_torch.nn import chain

N = 6
RTOL, ATOL = 1e-6, 1e-6
TSIT5 = dict(rtol=2e-2, atol=1e-3)
MODEL = cp.CPeptideModel(chain(4, 2))
JMODEL = jcp.CPeptideModel(kind="conditional",
                           net=jax_chain(4, 2, "tanh", input_dims=2))
DIRECTIONS = ((np.inf, np.inf), (np.inf, -np.inf), (-np.inf, np.inf),
              (-np.inf, -np.inf))


@pytest.fixture(scope="module")
def data():
    """Six test subjects in both packages (the JAX cohort also with u0 one
    ulp away in four directions) and the committed candidates."""
    _, test = load_npz("artifacts/ohashi.npz")
    s = test.subset(np.arange(N))
    raw = (s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm)
    jc = jcp.build_cohort(*raw)
    u0 = np.asarray(jc.individuals.u0, np.float32)
    moved = [jc._replace(individuals=jc.individuals._replace(
        u0=jnp.asarray(np.nextafter(u0, np.float32(d))))) for d in DIRECTIONS]
    with np.load("artifacts/cude_neural_parameters.npz") as z:
        cand, betas = z["nn_params"], z["betas"]
    return jc, moved, cp.build_cohort(*raw, "cpu"), cand, betas


def _within_spread(port, ref, moved, what):
    """The port's largest miss of JAX's unperturbed result within twice
    JAX's own largest move."""
    port, ref = np.asarray(port), np.asarray(ref)
    miss = np.abs(port - ref).max()
    spread = max(np.abs(np.asarray(m) - ref).max() for m in moved)
    assert miss <= 2 * spread, (what, miss, spread)


@pytest.mark.parametrize("act", ["gelu", "sigmoid", "relu"])
def test_activations_match_jax_mlp(act):
    rng = np.random.default_rng(3)
    net = chain(8, 2, act, input_dims=3)
    jnet = jax_chain(8, 2, act, input_dims=3)
    flat = rng.normal(0.0, 0.7, (256, net.num_params)).astype(np.float32)
    x = rng.uniform(-6.0, 6.0, (256, 3)).astype(np.float32)
    out = net.apply(torch.as_tensor(flat), torch.as_tensor(x)).numpy()
    ref = np.asarray(jax.vmap(jnet.apply)(jnp.asarray(flat), jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    # the hidden activation alone, elementwise
    h = rng.uniform(-8.0, 8.0, 1000).astype(np.float32)
    from conditional_ude_tpu.nn import resolve_activation
    from conditional_ude_tpu_torch.nn import ACTIVATIONS
    np.testing.assert_allclose(
        ACTIVATIONS[act](torch.as_tensor(h)).numpy(),
        np.asarray(resolve_activation(act)(jnp.asarray(h))), rtol=RTOL,
        atol=ATOL)


def test_fit_betas_sigma_tsit5_within_jax_spread(data):
    jc, moved, pc, cand, _ = data
    nn = cand[19]

    def jax_fit(c):
        return [np.asarray(a) for a in jtrain.fit_betas_sigma(
            JMODEL, jnp.asarray(nn), c, -1.0, (-4.0, 1.0), 3, "tsit5", 256,
            8)]

    ref = jax_fit(jc)
    port = [t.numpy() for t in ptrain.fit_betas_sigma(
        MODEL, torch.as_tensor(nn), pc, -1.0, (-4.0, 1.0), 3,
        solver="tsit5", max_steps=256)]
    runs = [jax_fit(c) for c in moved]
    for i, what in enumerate(("beta", "sigma", "objective")):
        _within_spread(port[i], ref[i], [r[i] for r in runs], what)


def test_fit_betas_and_evaluate_model_tsit5_within_jax_spread(data):
    jc, moved, pc, cand, betas = data
    rows = [0, 19]

    def jax_fits(c, iters):
        b, o = jtrain.fit_betas(JMODEL, jnp.asarray(cand[19]), c, -2.0,
                                (-4.0, 1.0), iters, "tsit5", 256, 8)
        e = jtrain.evaluate_model(JMODEL, jnp.asarray(cand[rows]),
                                  jnp.asarray(betas[rows]), c,
                                  lbfgs_iters=iters, solver="tsit5")
        return [np.asarray(a) for a in (b, o, e)]

    def port_fits(iters):
        b, o = ptrain.fit_betas(MODEL, torch.as_tensor(cand[19]), pc, -2.0,
                                (-4.0, 1.0), iters, solver="tsit5")
        e = ptrain.evaluate_model(MODEL, torch.as_tensor(cand[rows]),
                                  torch.as_tensor(betas[rows]), pc,
                                  lbfgs_iters=iters, solver="tsit5")
        return [t.numpy() for t in (b, o, e)]

    ref, port = jax_fits(jc, 3), port_fits(3)
    runs = [jax_fits(c, 3) for c in moved]
    for i, what in enumerate(("beta", "objective", "evaluate")):
        _within_spread(port[i], ref[i], [r[i] for r in runs], what)


def test_max_steps_reaches_the_fits(data):
    """Too few Tsit5 steps fail every lane: inf objectives, and the fits
    stay at their start, as in the JAX package (its L-BFGS stops a row
    that starts at inf)."""
    _, _, pc, cand, betas = data
    pb, po = ptrain.fit_betas(MODEL, torch.as_tensor(cand[19]), pc, -2.0,
                              (-4.0, 1.0), 3, solver="tsit5", max_steps=4)
    assert torch.isinf(po).all()
    assert torch.equal(pb, torch.full((N,), -2.0))
    _, s, o = ptrain.fit_betas_sigma(MODEL, torch.as_tensor(cand[19]), pc,
                                     solver="tsit5", max_steps=4,
                                     lbfgs_iters=2)
    assert torch.isinf(o).all() and torch.equal(s, torch.ones(N))
    e = ptrain.evaluate_model(MODEL, torch.as_tensor(cand[:2]),
                              torch.as_tensor(betas[:2]), pc, lbfgs_iters=2,
                              solver="tsit5", max_steps=4)
    assert e.shape == (2, N) and torch.isinf(e).all()


def test_train_ude_takes_tsit5():
    """``train_ude`` on exp01's mean training curve with Tsit5, the port fed
    JAX's designs: 32 designs, 2 restarts, 5 Adam and 3 L-BFGS steps.  The
    screen (values only) at Tsit5's tolerance; each objective is the Tsit5
    SSE of its network (not RK4's), and the port's Tsit5 SSE of JAX's
    trained networks is JAX's objectives at Tsit5's tolerance.  The trained
    networks themselves part from JAX's within the first Adam step (F7)."""
    train, _ = load_npz("artifacts/ohashi.npz")
    mean_c = train.cpeptide.mean(axis=0).astype(np.float32)
    args = (train.glucose.mean(axis=0), train.timepoints,
            float(train.ages.mean()), float(mean_c[0]), False)
    jude = jcp.CPeptideModel(kind="ude", net=jax_chain(4, 2, "tanh",
                                                       input_dims=1))
    kw = dict(initial_guesses=32, selected_initials=2, adam_iters=5,
              lbfgs_iters=3, screen_chunk=32, solver="tsit5", max_steps=256)
    ref = [np.array(a) for a in jtrain.train_ude(
        jude, jcp.build_individual(*args),
        jnp.asarray(train.timepoints, jnp.float32), jnp.asarray(mean_c),
        jax.random.key(7), **kw)]
    designs = np.asarray(jude.net.init_batch(jax.random.key(7), 32))
    model = cp.CPeptideModel(chain(4, 2, input_dims=1), "ude")
    ind = cp.build_individual(*args, "cpu")
    port = ptrain.train_ude(model, ind, mean_c, designs=designs, **kw)
    np.testing.assert_allclose(port.screen_losses.numpy(), ref[2], **TSIT5)
    series = dataclasses.replace(ind, cpeptide=torch.as_tensor(mean_c)[None])

    def sse(nn, solver):
        return cp_sse(model, torch.as_tensor(nn)[:, None, :], None, series,
                      solver=solver, substeps=8)[:, 0]

    np.testing.assert_allclose(port.objectives.numpy(),
                               sse(port.nn_params, "tsit5").numpy(),
                               rtol=1e-6)
    assert not torch.allclose(port.objectives, sse(port.nn_params, "rk4"),
                              rtol=1e-6, atol=0)
    np.testing.assert_allclose(sse(ref[0], "tsit5").numpy(), ref[1],
                               **TSIT5)


def test_profiles_take_tsit5_tolerances(data):
    """``cohort_beta_profiles(solver="tsit5", rtol=1e-6, atol=1e-9)`` on
    50 grid points against JAX's; the keywords leave the kernel out, as
    JAX's ``fused_kernel_eligible`` decides."""
    jc, _, pc, cand, _ = data
    nn = cand[19]
    kw = dict(steps=50, chunk=25, solver="tsit5", rtol=1e-6, atol=1e-9)
    ref = np.asarray(jax_profiles(JMODEL, jnp.asarray(nn), jc, **kw).values)
    got = cohort_beta_profiles(MODEL, torch.as_tensor(nn), pc, **kw).values
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3)
    # the default tolerances give another scan
    loose = cohort_beta_profiles(MODEL, torch.as_tensor(nn), pc, steps=50,
                                 chunk=25, solver="tsit5").values
    assert not torch.equal(loose, got)
    assert fused_kernel_eligible(MODEL)
    assert fused_kernel_eligible(MODEL, {"substeps": 4})
    for extra in ({"rtol": 1e-6}, {"max_steps": 64}, {"solver": "rk4"}):
        assert not fused_kernel_eligible(MODEL, extra)
    with pytest.raises(ValueError):
        cohort_beta_profiles(MODEL, torch.as_tensor(nn), pc, steps=10,
                             require_kernel=True, max_steps=64)
    with pytest.raises(TypeError):
        cohort_beta_profiles(MODEL, torch.as_tensor(nn), pc, steps=10,
                             solver="tsit5", dt0=0.1)


def test_log_every_prints_on_stderr(capsys):
    """Adam prints every row's loss before steps 0, k, 2k, …; SAEM its NLL,
    acceptance, σ and Ω every k iterations; 0 prints nothing."""
    x0 = (torch.tensor([[1.0, 2.0], [3.0, -1.0]]),)

    def fun(x):
        return (x[0] ** 2).sum(-1)

    adam_minimize(fun, x0, iters=5, log_every=2)
    err = capsys.readouterr().err.splitlines()
    assert [line.split()[1] for line in err] == ["it=0", "it=2", "it=4"]
    assert err[0] == "adam it=0 loss=5.000000 10.000000"
    adam_minimize(fun, x0, iters=5)
    assert capsys.readouterr().err == ""

    class Toy(LogLik):
        """y_ij ~ N(θ + r_i, σ) (``tests/test_torch_saem.py``'s toy)."""

        def __init__(self, data):
            self.data = torch.as_tensor(data)
            self.n, self.device = self.data.shape[0], self.data.device

        def __call__(self, theta, sigma, rand):
            resid = self.data - (theta + rand[..., None])
            return (-(self.data.shape[1] / 2.0) * torch.log(sigma**2)
                    - torch.sum(resid**2, -1) / (2.0 * sigma**2))

    data = np.random.default_rng(0).normal(1.5, 0.5, (8, 4)).astype(
        np.float32)
    for every, want in ((0, []), (2, ["it=2", "it=4"])):
        res = run_saem(Toy(data), 0.0, SAEMConfig(
            iterations=5, burnin=2, pop_update_iters=2, log_every=every),
            generator=torch.Generator().manual_seed(0))
        err = capsys.readouterr().err.splitlines()
        assert [line.split()[1] for line in err] == want
        if every:
            assert err[0].startswith("SAEM it=2  nll=")
            assert f"nll={float(res.nll_trace[1]):.4f}" in err[0]
