"""PyTorch port: the frozen-network slice against the JAX package — the
(β, σ) re-estimation, the likelihood profiles, the confidence intervals and
the identifiability census."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.analysis import profiles as jprof
from conditional_ude_tpu.fit.train import fit_betas_sigma as jax_fit_betas_sigma
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu_torch.analysis import profiles as prof
from conditional_ude_tpu_torch.convert import load_candidates, params_from_jax
from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
from conditional_ude_tpu_torch.fit.train import fit_betas_sigma
from conditional_ude_tpu_torch.models import cpeptide as cp
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint

BOUNDS = (-4.74293851852417, 0.6972165107727051)   # artifacts/cude_fit.json


@pytest.fixture(scope="module")
def data():
    train, test = load_npz("artifacts/ohashi.npz")
    nn, _, _, _ = load_candidates("artifacts/cude_neural_parameters.npz")
    fit, meta = load_checkpoint("artifacts/cude_fit.npz")
    return train, test, nn[meta["best_model_index"]], fit


def _both(split):
    args = (split.glucose, split.timepoints, split.cpeptide, split.ages,
            split.t2dm)
    return cp.build_cohort(*args, device="cpu"), jcp.build_cohort(*args)


MODEL = cp.CPeptideModel(chain(4, 2))
JMODEL = jcp.CPeptideModel(kind="conditional",
                           net=jax_chain(4, 2, "tanh", input_dims=2))


def test_fit_betas_sigma_matches_jax(data):
    _, test, nn, _ = data
    c, jc = _both(test.subset(np.arange(8)))
    b, s, o = (t.numpy() for t in fit_betas_sigma(
        MODEL, torch.as_tensor(nn), c, initial_beta=-1.0, bounds=BOUNDS,
        lbfgs_iters=100))
    jb, js, jo = (np.asarray(a) for a in jax_fit_betas_sigma(
        JMODEL, jnp.asarray(nn), jc, -1.0, BOUNDS, 100))
    # the objective is the robust check: β moves along flat valleys
    np.testing.assert_allclose(o, jo, rtol=1e-4)
    np.testing.assert_allclose(b, jb, atol=2e-3)
    np.testing.assert_allclose(s, js, rtol=5e-3)


@pytest.mark.parametrize("mode", ["grid", "center", "generic_net"])
def test_profiles_match_jax(data, mode):
    _, test, nn, fit = data
    c, jc = _both(test.subset(np.arange(6)))
    sig = fit["sigma_test"][:6]
    kw = dict(lower=BOUNDS[0] - 1.0, upper=BOUNDS[1] + 1.0, steps=50,
              chunk=20)
    model, jmodel = MODEL, JMODEL
    if mode == "center":
        kw.update(lower=-10.0, upper=10.0, center=fit["beta_test"][:6])
    if mode == "generic_net":
        # not the kernel's network: both packages take their RK4 path
        model = cp.CPeptideModel(chain(4, 2, "relu"))
        jmodel = jcp.CPeptideModel(
            kind="conditional", net=jax_chain(4, 2, "relu", input_dims=2))
        assert not prof.fused_kernel_eligible(model)
    else:
        assert prof.fused_kernel_eligible(model)
    out = prof.cohort_beta_profiles(
        model, torch.as_tensor(nn), c, sigmas=sig,
        **{k: v for k, v in kw.items() if k != "center"},
        center=None if "center" not in kw else torch.as_tensor(kw["center"]))
    ref = jprof.cohort_beta_profiles(
        jmodel, jnp.asarray(nn), jc, sigmas=jnp.asarray(sig), use_pallas=False,
        **{k: (jnp.asarray(v) if k == "center" else v)
           for k, v in kw.items()})
    assert out.values.shape == (6, 50)
    np.testing.assert_allclose(out.grid.numpy(), np.asarray(ref.grid),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.values.numpy(), np.asarray(ref.values),
                               rtol=1e-4)
    np.testing.assert_allclose(out.minimum.numpy(), np.asarray(ref.minimum),
                               rtol=1e-4)


@pytest.mark.parametrize("method", sorted(prof.THRESHOLDS))
def test_intervals_and_census_identical(method):
    rng = np.random.default_rng(9)
    grid = np.linspace(-3.0, 3.0, 200, dtype=np.float32)
    centre = rng.uniform(-2.5, 2.5, 12)
    curv = rng.choice([0.0, 0.5, 20.0], 12)
    values = (curv[:, None] * (grid[None, :] - centre[:, None]) ** 2
              + rng.normal(0, 0.05, (12, 200))).astype(np.float32)
    values[3, :40] = np.inf            # failed solves at one edge
    values[4] = np.inf                 # nothing finite
    values[5, 100:] = 50.0             # open on the left only
    ci = prof.find_confidence_intervals(
        prof.Profile(torch.as_tensor(grid), torch.as_tensor(values),
                     torch.as_tensor(values).amin(1)), method)
    jci = jprof.find_confidence_intervals(
        jprof.Profile(jnp.asarray(grid), jnp.asarray(values),
                      jnp.min(jnp.asarray(values), axis=1)), method)
    np.testing.assert_array_equal(ci.lower, jci.lower)
    np.testing.assert_array_equal(ci.upper, jci.upper)
    census = prof.classify_identifiability(ci)
    np.testing.assert_array_equal(census, jprof.classify_identifiability(jci))
    assert set(census) == {"identifiable", "practically unidentifiable",
                           "unidentifiable"}
    one = prof.find_confidence_intervals(
        prof.Profile(torch.as_tensor(grid), torch.as_tensor(values[0]),
                     torch.as_tensor(values[0]).min()), method)
    assert (one.lower, one.upper) == (ci.lower[0], ci.upper[0])


def test_census_of_committed_fit(data):
    """All 117 subjects at the committed β̂/σ̂, Δβ ∈ [−10, 10] in 1000 steps:
    111 identifiable, 6 practically unidentifiable, as JAX on the CPU."""
    train, test, nn, fit = data
    both = OhashiSplit.concatenate(train, test)
    c = cp.build_cohort(both.glucose, both.timepoints, both.cpeptide,
                        both.ages, both.t2dm, device="cpu")
    p = prof.cohort_beta_profiles(
        MODEL, torch.as_tensor(nn), c,
        sigmas=np.concatenate([fit["sigma_train"], fit["sigma_test"]]),
        lower=-10.0, upper=10.0, steps=1000,
        center=np.concatenate([fit["beta_train"], fit["beta_test"]]))
    census = prof.classify_identifiability(
        prof.find_confidence_intervals(p, "cantelli95"))
    counts = {k: int((census == k).sum()) for k in np.unique(census)}
    want = json.load(open("results/exp02_metrics.json"))[
        "identifiability_census_all"]
    assert counts == want == {"identifiable": 111,
                              "practically unidentifiable": 6}
    # the committed scan was taken on the TPU: within 3 %
    np.testing.assert_allclose(p.values.numpy(), fit["delta_values"],
                               rtol=3e-2)


def test_params_from_jax_round_trip(data):
    nn = data[2]
    net = chain(4, 2)
    t = params_from_jax(nn, net, "cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), nn)
    jnet = jax_chain(4, 2, "tanh", input_dims=2)
    x = np.array([[0.0, 0.3], [2.5, 0.3], [6.0, 1.2]], np.float32)
    np.testing.assert_allclose(
        net.scalar(t, torch.as_tensor(x)).numpy(),
        np.asarray(jnet.scalar(jnp.asarray(t.numpy()), jnp.asarray(x))),
        rtol=1e-6)
    batch = params_from_jax(np.stack([nn, nn]), net, "cpu")
    assert batch.shape == (2, 37)
