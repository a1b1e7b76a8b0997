"""PyTorch port: the suppression model (``models/suppression.py``) against
the JAX package on the CPU, on the same numpy-seeded inputs and the JAX
package's own designs.

Tolerances, from the gaps measured on the CPU:
- ``generate_data``: the true p4 equal; the data rtol 1e-4 + atol 1e-5 (the
  two Tsit5 solves at rtol 1e-6 differ by at most 5.7e-6, 2.8e-5 relative);
  the generator's state after each population equal, so the draws whose
  multiplier is 0 are drawn.
- ``suppression_loss`` by RK4: value and gradients rtol 1e-4 (measured
  ~1e-6).  By Tsit5: value rtol 1e-5 (measured 3e-6); gradients within
  5e-3 of each row's largest (measured 1.4e-3): the two solvers' float32
  trajectories differ by ~2e-6 relative, and the gradient through the
  adaptive step-size controller amplifies that.  Both on Glorot networks:
  at a trained network the gradient is a remainder of cancellation.
- The committed artifacts: each file's objectives within max(1e-4, twice
  JAX-CPU's own largest miss of that file).  JAX on the CPU misses the
  TPU-made objectives of λ = 0 (restart 24) by 4.24e-4 and of λ = 1 by
  9.2e-5, the port by as much (``scripts/suppression_reference.py --only
  artifacts``).
- The λ sweep: ``tests/test_torch_suppression_pipeline.py``.
- The frozen-network refits after 30 L-BFGS steps: exp(θ), which the
  network reads, rtol 1e-3 + atol 1e-3 (θ itself drifts in the flat
  direction θ → −∞: −7.35 against −7.53, exp(θ) 6.4e-4 against 5.4e-4),
  objectives rtol 1e-4; a tie of candidates resolves to the first; a row
  of a batch equals its fit alone within rtol 1e-5.  The (θ, σ) fits after
  25 steps: σ rtol 1e-3 + atol 1e-4, exp(θ) rtol 2e-2 (measured 1.26e-2
  at exp(θ) ≈ 30, where the network's response to exp(θ) has flattened and
  the NLL is flat in θ), the NLL rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.models import suppression as jsup
from conditional_ude_tpu_torch.convert import params_from_jax
from conditional_ude_tpu_torch.models import suppression as sup
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint

TP = np.linspace(0.0, 30.0, 8)
GROUP_MEANS = [0.5, 2.5, 5.0, 7.5, 10.0, 12.5]
TRAIN = [15, 3, 3, 3, 3, 10]
ART = "artifacts"
LAMBDAS = [0.0, 0.001, 0.01, 0.015848931925, 0.025118864315, 0.039810717055,
           0.063095734448, 0.1, 0.158489319246, 0.251188643151, 1.0, 10.0,
           100.0, 1000.0]


def artifact(lam):
    return load_checkpoint(f"{ART}/suppression_lambda={lam}.npz")[0]


@pytest.fixture(scope="module")
def populations():
    """The JAX script's three populations from both packages, and each
    generator's next draw after them."""
    out = {}
    for name, gen in (("jax", jsup.generate_data),
                      ("port", sup.generate_data)):
        rng = np.random.default_rng(27052023)
        pops = [gen(GROUP_MEANS, sizes, TP, noise_multiplicative=nz,
                    rng=rng)
                for sizes, nz in ((TRAIN, 0.1), ([5] * 6, 0.1),
                                  ([5] * 6, 0.0))]
        out[name] = (pops, rng.uniform(size=4))
    return out


@pytest.fixture(scope="module")
def nets():
    return jsup.suppression_net(depth=5, width=3), sup.suppression_net()


def test_net_is_the_reference_shape(nets):
    jnet, net = nets
    assert net.num_params == jnet.num_params == 67
    assert net.input_dims == 4 and net.widths == (3,) * 5
    flat = artifact(0.01)["nn_params"]
    assert params_from_jax(flat, net, "cpu").shape == (25, 67)


def test_generate_data_matches_jax(populations):
    (jpops, jnext), (ppops, pnext) = populations["jax"], populations["port"]
    for (dj, gj), (dp, gp) in zip(jpops, ppops):
        assert dp.dtype == np.float32 and dp.shape == dj.shape
        np.testing.assert_array_equal(gp, gj)
        np.testing.assert_allclose(dp, dj, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(pnext, jnext)


@pytest.mark.parametrize("solver", ["rk4", "tsit5"])
def test_loss_and_gradients_match_jax(populations, nets, solver):
    jnet, net = nets
    data = populations["jax"][0][0][0]
    nn = np.asarray(jnet.init_batch(jax.random.key(0), 4))
    theta = np.random.default_rng(1).standard_normal((4, 37)).astype(
        np.float32)
    lam = np.float32(0.01)

    def f(a, b):
        return jsup.suppression_loss(jnet, a, b, data, TP, lam,
                                     solver=solver)

    vj, (gnj, gtj) = jax.vmap(jax.value_and_grad(f, argnums=(0, 1)))(
        jnp.asarray(nn), jnp.asarray(theta))
    a = torch.tensor(nn, requires_grad=True)
    b = torch.tensor(theta, requires_grad=True)
    v = sup.suppression_loss(net, a, b, data, TP, float(lam), solver=solver)
    gn, gt = torch.autograd.grad(v.sum(), [a, b])
    if solver == "rk4":
        np.testing.assert_allclose(v.detach(), vj, rtol=1e-4)
        np.testing.assert_allclose(gn, gnj, rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(gt, gtj, rtol=1e-4, atol=1e-7)
    else:
        np.testing.assert_allclose(v.detach(), vj, rtol=1e-5)
        for got, want in ((gn, gnj), (gt, gtj)):
            want = np.asarray(want)
            scale = np.abs(want).max(1, keepdims=True)
            assert (np.abs(got.numpy() - want) <= 5e-3 * scale).all()
    # one dataset a row gives the same losses as the shared one
    rows = sup.suppression_loss(net, a.detach(), b.detach(),
                                np.stack([data] * 4), TP, float(lam),
                                solver=solver)
    torch.testing.assert_close(rows, v.detach(), rtol=0, atol=0)


@pytest.fixture(scope="module")
def jax_artifact_miss(populations, nets):
    """JAX-CPU's largest relative miss of each artifact's objectives."""
    jnet = nets[0]
    data = populations["jax"][0][0][0]
    loss = jax.jit(jax.vmap(
        lambda a, b, lam: jsup.suppression_loss(jnet, a, b, data, TP, lam),
        in_axes=(0, 0, None)))
    out = {}
    for lam in LAMBDAS:
        ck = artifact(lam)
        got = np.asarray(loss(ck["nn_params"], ck["thetas"],
                              np.float32(lam)))
        out[lam] = float(np.abs(got / ck["objectives"] - 1).max())
    return out


@pytest.mark.parametrize("lam", LAMBDAS)
def test_committed_artifacts_objectives(populations, nets, jax_artifact_miss,
                                        lam):
    data, gt = populations["port"][0][0]
    ck = artifact(lam)
    np.testing.assert_array_equal(ck["gt_train"], gt)
    lam_rows = torch.full((25,), lam)
    got = sup.suppression_loss(nets[1], torch.as_tensor(ck["nn_params"]),
                               torch.as_tensor(ck["thetas"]), data, TP,
                               lam_rows).numpy()
    limit = max(1e-4, 2 * jax_artifact_miss[lam])
    assert np.abs(got / ck["objectives"] - 1).max() <= limit


@pytest.fixture(scope="module")
def valid_case(populations):
    """Noisy validation subjects, 16 candidate θ vectors, two restarts of
    the committed λ = 0.01 artifact."""
    data = populations["jax"][0][1][0][:6]
    inits = np.random.default_rng(2).uniform(size=(16, 6)).astype(np.float32)
    return data, inits, artifact(0.01)["nn_params"][[4, 5]]


def test_validate_suppression_matches_jax(nets, valid_case):
    jnet, net = nets
    data, inits, nn = valid_case
    tj, oj = jsup.validate_suppression(jnet, jnp.asarray(nn), data, TP,
                                       jnp.asarray(inits), lbfgs_iters=30)
    tp_, op = sup.validate_suppression(net, torch.as_tensor(nn), data, TP,
                                       inits, lbfgs_iters=30)
    # the network reads exp(θ): a θ far below 0 sits in a flat direction
    np.testing.assert_allclose(np.exp(tp_), np.exp(np.asarray(tj)),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(op, np.asarray(oj), rtol=1e-4)
    # one network gives a vector and a scalar
    t1, o1 = sup.validate_suppression(net, torch.as_tensor(nn[0]), data, TP,
                                      inits, lbfgs_iters=30)
    assert t1.shape == (6,) and o1.shape == ()


def test_validate_tie_resolves_to_the_first_candidate(nets, valid_case):
    """At λ = 10 the network is flat in θ: every candidate's loss is the
    same float32 number, and both packages keep the first."""
    jnet, net = nets
    data, inits, _ = valid_case
    flat = artifact(10.0)["nn_params"][:2]
    with torch.no_grad():
        losses = sup.suppression_loss(
            net, torch.as_tensor(flat[:1]).expand(16, -1),
            torch.as_tensor(inits), data, TP)
    assert (losses == losses[0]).all()
    bj = jsup._validate_best_init(jnet, jnp.asarray(flat[0]), data,
                                  jnp.asarray(TP, jnp.float32),
                                  jnp.asarray(inits))
    bp, _ = sup.validate_suppression(net, torch.as_tensor(flat), data, TP,
                                     inits, lbfgs_iters=0)
    np.testing.assert_array_equal(np.asarray(bj), inits[0])
    np.testing.assert_array_equal(bp, inits[[0, 0]])


def test_validation_rows_equal_their_fits_alone(nets, valid_case,
                                                populations):
    """Two λ's restarts on both validation sets as rows of one L-BFGS, each
    row against its fit alone."""
    net = nets[1]
    data, inits, nn = valid_case
    nonoise = populations["port"][0][2][0][:6]
    nn2 = torch.as_tensor(np.concatenate([nn, artifact(0.1)["nn_params"][:1]]))
    sets = torch.cat([torch.as_tensor(data).expand(3, -1, -1, -1),
                      torch.as_tensor(nonoise).expand(3, -1, -1, -1)])
    tb, ob = sup.validate_suppression(net, torch.cat([nn2, nn2]), sets, TP,
                                      inits, lbfgs_iters=10)
    for i in (1, 5):
        ta, oa = sup.validate_suppression(net, nn2[i % 3], sets[i], TP, inits,
                                          lbfgs_iters=10)
        torch.testing.assert_close(tb[i], ta, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(ob[i], oa, rtol=1e-5, atol=0)


def test_sigma_fits_match_jax(nets, populations):
    jnet, net = nets
    data = populations["jax"][0][1][0][:5]
    grid = np.random.default_rng(4).uniform(size=24).astype(np.float32)
    nn = artifact(0.01)["nn_params"][[4, 5]]
    xj, nj = jsup.validate_suppression_sigma_batch(
        jnet, jnp.asarray(nn[0]), jnp.asarray(data),
        jnp.asarray(TP, jnp.float32), jnp.asarray(grid), 25)
    xp, np_ = sup.validate_suppression_sigma_batch(
        net, torch.as_tensor(nn[0]), data, TP, grid, 25)
    xj = np.asarray(xj)
    np.testing.assert_allclose(xp[:, 1:], xj[:, 1:], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.exp(xp[:, 0]), np.exp(xj[:, 0]), rtol=2e-2)
    np.testing.assert_allclose(np_, np.asarray(nj), rtol=1e-4, atol=1e-4)
    # two networks as rows of one fit: each as its fit alone
    xb, nb = sup.validate_suppression_sigma_batch(
        net, torch.as_tensor(nn), data, TP, grid, 25)
    assert xb.shape == (2, 5, 4)
    torch.testing.assert_close(xb[0], xp, rtol=1e-5, atol=1e-6)
    # one individual
    x1, n1 = sup.validate_suppression_sigma(net, torch.as_tensor(nn[0]),
                                            data[0], TP, grid, 25)
    torch.testing.assert_close(x1, xp[0], rtol=1e-5, atol=1e-6)


def test_fit_closures_take_no_host_data(nets, monkeypatch):
    """Every value+grad that a fit hands to ``graphed_vg`` makes no tensor
    from host data: on a card that call is captured as a CUDA graph, which
    refuses a copy from the host.  Checked here on the CPU at a tiny size
    by refusing ``torch.tensor``, ``torch.from_numpy`` and ``as_tensor`` of
    a non-tensor inside those closures."""
    from conditional_ude_tpu_torch.fit import optim
    calls, made = [0], []
    real = {name: getattr(torch, name)
            for name in ("tensor", "as_tensor", "from_numpy")}

    def refuse(name):
        def fn(data, *args, **kwargs):
            if name != "as_tensor" or not torch.is_tensor(data):
                made.append(name)
            return real[name](data, *args, **kwargs)
        return fn

    def checked(fun, x0):
        def wrapped(xs):
            calls[0] += 1
            with monkeypatch.context() as m:
                for name in real:
                    m.setattr(torch, name, refuse(name))
                return fun(xs)
        return optim.graphed_vg(wrapped, x0)

    monkeypatch.setattr(sup, "graphed_vg", checked)
    net = nets[1]
    rng = np.random.default_rng(0)
    data, _ = sup.generate_data((0.5, 5.0), (2, 2), TP, 0.1, rng=rng)
    cfg = sup.SuppressionFitConfig(initial_space=8, select_best_n=2,
                                   adam_iters=2, lbfgs_iters=2,
                                   screen_chunk=4)
    fit = sup.fit_suppression_sweep(net, data, TP, [0.0, 1.0], cfg,
                                    generator=torch.Generator().manual_seed(1))
    nn = fit.nn_params.reshape(-1, net.num_params)
    inits = rng.uniform(size=(5, 4)).astype(np.float32)
    sup.validate_suppression(net, nn, data, TP, inits, lbfgs_iters=2)
    sup.validate_suppression_sigma_batch(
        net, nn[:2], data, TP, rng.uniform(size=7).astype(np.float32),
        lbfgs_iters=2)
    assert calls[0] > 0 and made == []
