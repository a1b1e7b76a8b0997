"""PyTorch port: joint training (``fit/train.py::train_conditional``) and
its designs, against the JAX package's ``train_conditional`` on its Pallas
path in interpret mode (K1 screen, K2 value + gradient, K3 re-rank).

``torch.Generator`` and ``jax.random`` draw different numbers, so the port
is fed the JAX package's ``initial_designs``.  8 subjects of the Ohashi
training split, 256 designs, 3 restarts.  Tolerances: screen losses rtol
1e-5 (the RK4 kernel's); after 30 Adam steps parameters atol 1e-5 and the
loss traces rtol 1e-4; Tsit5 objectives rtol 2e-2 (the Tsit5 kernel's); with
20 L-BFGS steps added, final objectives rtol 5e-2 (the JAX package's own
XLA and Pallas paths end 4 % apart there: L-BFGS amplifies float32
differences).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.fit import train as jtrain
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.utils.stats import latin_hypercube as jax_lhs
from conditional_ude_tpu_torch.data.ohashi import load_npz
from conditional_ude_tpu_torch.fit import train as ptrain
from conditional_ude_tpu_torch.models.cpeptide import CPeptideModel, build_cohort
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import lane_grad, rk4_population, tsit5_cohort
from conditional_ude_tpu_torch.utils.stats import latin_hypercube

N, G, K, ADAM, LBFGS = 8, 256, 3, 30, 20


def _configs(lbfgs):
    kw = dict(initial_guesses=G, selected_initials=K, adam_iters=ADAM,
              lbfgs_iters=lbfgs, screen_chunk=G)
    return jtrain.TrainConfig(use_pallas=True, **kw), ptrain.TrainConfig(**kw)


@pytest.fixture(scope="module")
def runs():
    train, _ = load_npz("artifacts/ohashi.npz")
    s = train.subset(np.arange(N))
    raw = (s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm)
    jmodel = jcp.CPeptideModel(kind="conditional",
                               net=jax_chain(4, 2, "tanh", input_dims=2))
    jc = jcp.build_cohort(*raw)
    pmodel = CPeptideModel(chain(4, 2))
    pc = build_cohort(*raw, "cpu")
    key = jax.random.key(0)
    out = {}
    for lbfgs in (0, LBFGS):
        jcfg, pcfg = _configs(lbfgs)
        designs = jtrain.initial_designs(jmodel.net, N, key, jcfg)
        ref = jtrain.train_conditional(jmodel, jc, key, jcfg)
        counts = [m.launches for m in (rk4_population, lane_grad,
                                       tsit5_cohort)]
        port = ptrain.train_conditional(pmodel, pc, pcfg, designs=designs)
        assert counts == [m.launches for m in (rk4_population, lane_grad,
                                               tsit5_cohort)]
        out[lbfgs] = (port, ref)
    return out


def test_screen_losses_and_selection(runs):
    port, ref = runs[0]
    ps, rs = port.screen_losses.numpy(), np.asarray(ref.screen_losses)
    assert ps.shape == (G,)
    np.testing.assert_array_equal(np.isfinite(ps), np.isfinite(rs))
    np.testing.assert_allclose(ps, rs, rtol=1e-5)
    top = np.argsort(np.where(np.isfinite(rs), rs, np.inf), kind="stable")[:K]
    top_port = torch.argsort(torch.where(torch.isfinite(port.screen_losses),
                                         port.screen_losses, torch.inf),
                             stable=True)[:K].numpy()
    np.testing.assert_array_equal(top_port, top)


def test_adam_stage_and_tsit5_rerank(runs):
    port, ref = runs[0]
    np.testing.assert_allclose(port.objectives.numpy(),
                               np.asarray(ref.objectives), rtol=2e-2)
    np.testing.assert_allclose(port.nn_params.numpy(),
                               np.asarray(ref.nn_params), atol=1e-5)
    np.testing.assert_allclose(port.betas.numpy(), np.asarray(ref.betas),
                               atol=1e-5)
    np.testing.assert_allclose(port.loss_traces.numpy(),
                               np.asarray(ref.loss_traces), rtol=1e-4)
    np.testing.assert_array_equal(port.orientations.numpy(),
                                  np.asarray(ref.orientations))


def test_lbfgs_stage(runs):
    port, ref = runs[LBFGS]
    assert port.nn_params.shape == (K, 37) and port.betas.shape == (K, N, 1)
    np.testing.assert_allclose(port.loss_traces.numpy(),
                               np.asarray(ref.loss_traces), rtol=1e-4)
    np.testing.assert_allclose(port.objectives.numpy(),
                               np.asarray(ref.objectives), rtol=5e-2)
    assert (np.diff(port.objectives.numpy()) >= 0).all()


def test_timings_name_the_plain_route_on_the_cpu(runs):
    port, _ = runs[LBFGS]
    assert port.timings["screen_path"] == "plain"
    assert port.timings["refine_path"] == "plain"
    assert all(port.timings[k] >= 0
               for k in ("screen", "adam", "lbfgs", "final_eval"))


def test_latin_hypercube_equals_jax_bit_for_bit():
    a = latin_hypercube(np.random.default_rng(9), 50, 7, -2.0, 0.0)
    b = jax_lhs(np.random.default_rng(9), 50, 7, -2.0, 0.0)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= -2.0 and a.max() <= 0.0
    # one sample in each of the 50 strata of every dimension
    for d in range(7):
        assert len(np.unique(np.floor((a[:, d] + 2.0) / 2.0 * 50))) == 50


def test_initial_designs():
    net = chain(4, 2)
    cfg = ptrain.TrainConfig(initial_guesses=4000)
    gen = torch.Generator().manual_seed(3)
    nn, betas = ptrain.initial_designs(net, N, gen, cfg, seed=270523)
    jcfg = jtrain.TrainConfig(initial_guesses=4000)
    _, jbetas = jtrain.initial_designs(jax_chain(4, 2, "tanh"), N,
                                       jax.random.key(0), jcfg, seed=270523)
    np.testing.assert_array_equal(betas.numpy(), np.asarray(jbetas))
    assert nn.shape == (4000, 37) and nn.dtype == torch.float32
    i = 0
    for fi, fo in net.layer_dims:
        w, b = nn[:, i:i + fi * fo], nn[:, i + fi * fo:i + fi * fo + fo]
        bound = np.sqrt(6.0 / (fi + fo))
        assert float(w.abs().max()) <= bound and bool((b == 0).all())
        # uniform on ±bound: variance bound² / 3
        assert abs(float(w.var()) / (bound**2 / 3) - 1.0) < 0.05
        i += fi * fo + fo
    again = ptrain.initial_designs(net, N, torch.Generator().manual_seed(3),
                                   cfg, seed=270523)
    torch.testing.assert_close(again[0], nn, rtol=0, atol=0)


def test_config_defaults_match_the_jax_package():
    port = {f.name: f.default for f in dataclasses.fields(ptrain.TrainConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jtrain.TrainConfig)}
    assert set(port) <= set(ref)
    assert set(ref) - set(port) == {"use_pallas", "dispatch_chunk"}
    assert all(port[k] == ref[k] for k in port)


def test_raises_for_what_the_kernels_do_not_take():
    train, _ = load_npz("artifacts/ohashi.npz")
    s = train.subset(np.arange(3))
    pc = build_cohort(s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm,
                      "cpu")
    cfg = ptrain.TrainConfig(initial_guesses=8, selected_initials=2,
                             adam_iters=1, lbfgs_iters=0)
    for model, c in (
            (CPeptideModel(chain(4, 2)), dataclasses.replace(cfg, n_conditional=2)),
            (CPeptideModel(chain(4, 2)), dataclasses.replace(cfg, solver="tsit5")),
            (CPeptideModel(chain(8, 2)), cfg)):
        with pytest.raises(NotImplementedError):
            ptrain.train_conditional(model, pc, c, seed=1)
    # a kind that does not match the network's input count cannot be built;
    # the covariate model, whose kind does, trains
    with pytest.raises(ValueError):
        CPeptideModel(chain(4, 2, input_dims=3))
    with pytest.raises(ValueError):
        CPeptideModel(chain(4, 2), "conditional_covariate")
    res = ptrain.train_conditional(
        CPeptideModel(chain(4, 2, input_dims=3), "conditional_covariate"), pc,
        cfg, seed=1)
    assert res.nn_params.shape == (2, 41) and res.betas.shape == (2, 3, 1)
    assert torch.isfinite(res.screen_losses).any()
