"""PyTorch port: a reduced ``run_frozen_pipeline`` (4 candidates, 8 subjects
per set, 50 L-BFGS iterations) against the same calls in the JAX package,
and a reduced ``run_training_pipeline`` (the retrain path) on the CPU."""

import json
from pathlib import Path

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
from conditional_ude_tpu.fit.train import (
    evaluate_model,
    fit_betas_sigma,
    select_best,
)
from conditional_ude_tpu.models.cpeptide import CPeptideModel, build_cohort
from conditional_ude_tpu.nn import chain
from conditional_ude_tpu.utils.stats import spearman
from conditional_ude_tpu_torch.convert import load_candidates
from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
from conditional_ude_tpu_torch.fit.train import TrainConfig, train_conditional
from conditional_ude_tpu_torch.models.cpeptide import CPeptideModel as PortModel
from conditional_ude_tpu_torch.models.cpeptide import build_cohort as port_cohort
from conditional_ude_tpu_torch.nn import chain as port_chain
from conditional_ude_tpu_torch.pipeline import (
    SEED,
    run_frozen_pipeline,
    run_training_pipeline,
)
from conditional_ude_tpu_torch.utils.stats import stratified_split

R, N, ITERS, STEPS = 4, 8, 50, 50


def _counts(census):
    return {str(c): int((census == c).sum()) for c in np.unique(census)}


@pytest.fixture(scope="module")
def runs():
    port = run_frozen_pipeline("cpu", "artifacts", lbfgs_iters=ITERS,
                               candidates=R, subjects=N, profile_steps=STEPS,
                               census_steps=STEPS)

    # the same steps, composed from the JAX package
    train, test = load_npz("artifacts/ohashi.npz")
    nn, betas, idx_fit, orientations = load_candidates(
        "artifacts/cude_neural_parameters.npz")
    val = train.subset(np.setdiff1d(np.arange(len(train.ages)), idx_fit))
    train, val, test = (s.subset(np.arange(N)) for s in (train, val, test))

    def cohort(s):
        return build_cohort(s.glucose, s.timepoints, s.cpeptide, s.ages,
                            s.t2dm)

    model = CPeptideModel(kind="conditional",
                          net=chain(4, 2, "tanh", input_dims=2))
    objectives = evaluate_model(model, jnp.asarray(nn[:R]),
                                jnp.asarray(betas[:R]), cohort(val),
                                lbfgs_iters=ITERS)
    best = select_best(objectives)
    bb = betas[best].ravel()
    lb = bb.min() - 0.1 * abs(bb.min())
    ub = bb.max() + 0.1 * abs(bb.max())
    fits = [[np.asarray(a) for a in fit_betas_sigma(
        model, jnp.asarray(nn[best]), cohort(s), -1.0,
        (float(lb), float(ub)), ITERS)] for s in (train, test)]
    (b_tr, s_tr, o_tr), (b_te, s_te, o_te) = fits
    sse_te = (o_te - 2.5 * np.log(s_te**2)) * (2 * s_te**2)
    both = OhashiSplit.concatenate(train, test)
    b_all = np.concatenate([b_tr, b_te])
    p = cohort_beta_profiles(model, jnp.asarray(nn[best]), cohort(test),
                             sigmas=jnp.asarray(s_te), lower=float(lb) - 1.0,
                             upper=float(ub) + 1.0, steps=STEPS,
                             use_pallas=False)
    p_all = cohort_beta_profiles(
        model, jnp.asarray(nn[best]), cohort(both),
        sigmas=jnp.asarray(np.concatenate([s_tr, s_te])), lower=-10.0,
        upper=10.0, steps=STEPS, center=jnp.asarray(b_all), use_pallas=False)
    ref = dict(
        objectives=np.asarray(objectives), best=best, bounds=(lb, ub),
        b_train=b_tr, s_train=s_tr, b_test=b_te, s_test=s_te, sse_test=sse_te,
        rho=spearman(orientations[best] * b_all, both.first_phase),
        profile=np.asarray(p.values), delta=np.asarray(p_all.values),
        census_test=_counts(classify_identifiability(
            find_confidence_intervals(p, "cantelli95"))),
        census_all=_counts(classify_identifiability(
            find_confidence_intervals(p_all, "cantelli95"))))
    return port, ref


def test_selection(runs):
    port, ref = runs
    assert port.val_objectives.shape == (R, N)
    np.testing.assert_allclose(port.val_objectives, ref["objectives"],
                               rtol=1e-4)
    assert port.best == ref["best"]
    np.testing.assert_allclose(port.bounds, ref["bounds"], rtol=1e-6)


def test_reestimation(runs):
    port, ref = runs
    for split in ("train", "test"):
        np.testing.assert_allclose(getattr(port, f"b_{split}"),
                                   ref[f"b_{split}"], atol=2e-3)
        np.testing.assert_allclose(getattr(port, f"s_{split}"),
                                   ref[f"s_{split}"], rtol=5e-3)
    # SSE = (NLL − (n/2)·log σ²)·2σ² carries the σ tolerance twice
    np.testing.assert_allclose(port.sse_test, ref["sse_test"], rtol=1e-2)
    assert abs(port.spearman["first_phase"] - ref["rho"]) < 0.05


def test_sse_per_type(runs):
    """``metrics()`` carries the mean SSE of each NGT/IGT/T2DM class, as
    ``results/exp02_metrics.json`` does (``experiments/common.py:259-262``):
    the port's own per-class means, and the JAX fits' within the SSE's
    tolerance."""
    port, ref = runs
    m = port.metrics()
    train, test = (s.subset(np.arange(N))
                   for s in load_npz("artifacts/ohashi.npz"))
    for split, types, sse in (("train", train.types, port.sse_train),
                              ("test", test.types, port.sse_test)):
        got = m[f"{split}_sse_per_type"]
        assert set(got) == set(np.unique(types)) <= {"NGT", "IGT", "T2DM"}
        for kind, value in got.items():
            assert value == float(np.mean(sse[types == kind]))
    for kind, value in m["test_sse_per_type"].items():
        np.testing.assert_allclose(
            value, ref["sse_test"][test.types == kind].mean(), rtol=1e-2)
    json.dumps(m)


def test_retrain_split_is_the_artifacts_split():
    """The flagship's seed rebuilds the fit/validation split the committed
    candidates were trained on (57 fit and 25 validation subjects)."""
    train, _ = load_npz("artifacts/ohashi.npz")
    _, _, idx_fit, _ = load_candidates("artifacts/cude_neural_parameters.npz")
    fit, val = stratified_split(np.random.default_rng(SEED), train.types, 0.7)
    np.testing.assert_array_equal(fit, idx_fit)
    assert (len(fit), len(val)) == (57, 25)


@pytest.fixture(scope="module")
def retrain():
    """A reduced retrain path on the CPU (64 designs, 2 restarts, 3 Adam and
    3 L-BFGS steps; 5 L-BFGS steps in selection and refit, no scans)."""
    cfg = TrainConfig(initial_guesses=64, selected_initials=2, adam_iters=3,
                      lbfgs_iters=3)
    artifacts = sorted((p.name, p.stat().st_mtime_ns)
                       for p in Path("artifacts").iterdir())
    res = run_training_pipeline("cpu", "artifacts", config=cfg,
                                lbfgs_iters=5, profile_steps=0,
                                census_steps=0)
    assert sorted((p.name, p.stat().st_mtime_ns)
                  for p in Path("artifacts").iterdir()) == artifacts
    return cfg, res


def test_retrain_path_trains_on_the_fit_split(retrain):
    cfg, res = retrain
    tr = res.training
    assert tr.nn_params.shape == (2, 37) and tr.betas.shape == (2, 57, 1)
    assert tr.screen_losses.shape == (64,)
    assert res.val_objectives.shape == (2, 25)
    assert set(res.seconds) == {"train", "select", "refit", "outputs"}
    assert res.profile is None and res.census_all == {}
    assert res.b_train.shape == (82,) and res.b_test.shape == (35,)
    assert np.isfinite(res.sse_test).all()
    json.dumps(res.metrics())
    # the same seed gives the same training, called directly
    train, _ = load_npz("artifacts/ohashi.npz")
    fit, _ = stratified_split(np.random.default_rng(SEED), train.types, 0.7)
    s = train.subset(fit)
    direct = train_conditional(
        PortModel(port_chain(4, 2)),
        port_cohort(s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm,
                    "cpu"),
        cfg, generator=torch.Generator().manual_seed(SEED), seed=SEED)
    torch.testing.assert_close(direct.nn_params, tr.nn_params, rtol=0, atol=0)
    torch.testing.assert_close(direct.objectives, tr.objectives, rtol=0,
                               atol=0)


def test_profiles_and_census(runs):
    port, ref = runs
    assert port.profile.values.shape == (N, STEPS)
    assert port.delta_profile.values.shape == (2 * N, STEPS)
    # NLL = SSE/(2σ²) with each package's own fitted σ
    np.testing.assert_allclose(port.profile.values.numpy(), ref["profile"],
                               rtol=2e-2)
    np.testing.assert_allclose(port.delta_profile.values.numpy(),
                               ref["delta"], rtol=2e-2)
    assert port.census_test == ref["census_test"]
    assert port.census_all == ref["census_all"]
    assert set(port.seconds) == {"select", "refit", "profile_test", "census",
                                 "outputs"}
    assert port.metrics()["best_model_index"] == ref["best"]
