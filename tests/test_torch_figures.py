"""PyTorch port: the figure gallery (``figures_pipeline.py``) against the JAX
package's functions as ``experiments/exp_figures.py`` calls them
(``scripts/figures_reference.py``), at the JAX script's smoke sizes (8
subjects a split, 100 L-BFGS steps, 200 profile and CI points) or, where a
section fits nothing, at full size.

Tolerances (those ``chip_smoke.py`` holds the card to):
  * the median subjects: the subjects' MSEs are Tsit5 at rtol 1e-3 in both
    packages, whose step controls differ (the MSEs within rtol 0.1 +
    atol 2e-3 of each other); each type's pick equals JAX's where JAX's
    margin to its next candidate exceeds the port's miss of the distances
    to the median, and is else a subject JAX could pick within that miss
    (an even count has two equidistant middle subjects);
  * ``ci_bound_sims``: each CI bound within two points of the grid, the
    trajectories at the bounds rtol 1e-3 + atol 1e-4;
  * dose-response curves rtol 1e-4 + atol 1.6e-4 (exp02's table);
  * refits of the runner-up network and of the type means |Δβ| ≤ 1e-2,
    their Spearman ± 0.01;
  * trajectories and bands (cUDE, SAEM, suppression, symbolic, UDE,
    external) rtol 1e-4 + atol 1e-5; ``argmedian`` exactly,
    ``mann_whitney_u`` rtol 1e-12.

It also renders every figure function of ``utils/figures.py`` (each PNG over
1,000 bytes), runs the gallery's entry point twice into one ``--out``
(``data external``, then ``ablation``: the manifest merges), and runs every
section at smoke size with matplotlib hidden: all compute, nothing is
drawn, exit code 0.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.data.ohashi import load_npz as jax_load_npz
from conditional_ude_tpu.utils import stats as jstats
from conditional_ude_tpu_torch import figures_pipeline as fp
from conditional_ude_tpu_torch.convert import params_from_jax
from conditional_ude_tpu_torch.utils import figures, stats
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parent.parent
ART = REPO / "artifacts"
TRAJ = dict(rtol=1e-4, atol=1e-5)
CURVES = dict(rtol=1e-4, atol=1.6e-4)
CI_SIMS = dict(rtol=1e-3, atol=1e-4)
BETA_TOL = 1e-2


def _reference():
    spec = importlib.util.spec_from_file_location(
        "figures_reference", REPO / "scripts" / "figures_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return _reference()


@pytest.fixture(scope="module")
def smoke():
    """The gallery's inputs at the smoke sizes, and the JAX splits alike."""
    g = fp.Gallery("cpu", ART, fp.RESULTS, fp.SMOKE)
    train, test = jax_load_npz(ART / "ohashi.npz")
    return g, train.subset(np.arange(8)), test.subset(np.arange(8))


@pytest.fixture(scope="module")
def full():
    g = fp.Gallery("cpu", ART, fp.RESULTS, fp.FULL)
    return (g, *jax_load_npz(ART / "ohashi.npz"))


@pytest.fixture(scope="module")
def cude_smoke(smoke):
    g = smoke[0]
    return fp.section_cude(g)


def _medians_agree(types, got_err, want_err, got_idx, want_idx) -> None:
    """``got_idx`` against JAX's ``want_idx`` by JAX's margins."""
    np.testing.assert_allclose(got_err, want_err, rtol=0.1, atol=2e-3)
    present = [t for t in fp.TYPES if (types == t).any()]
    assert len(got_idx) == len(want_idx) == len(present)
    for t, gi, wi in zip(present, got_idx, want_idx):
        sel = np.flatnonzero(types == t)
        dw = np.abs(want_err[sel] - np.median(want_err[sel]))
        dg = np.abs(got_err[sel] - np.median(got_err[sel]))
        miss = float(np.max(np.abs(dg - dw)))
        srt = np.sort(dw)
        margin = srt[1] - srt[0] if sel.size > 1 else np.inf
        if margin > miss:
            assert gi == wi, (t, gi, wi, margin, miss)
        else:
            assert dw[np.flatnonzero(sel == gi)[0]] <= srt[0] + 2 * miss


def _ci_close(got: dict, want: dict, steps: int) -> None:
    """Each bound within two grid points, the trajectories at them close
    where both are finite, open sides the same."""
    step = 25.0 / (steps - 1)
    for key in ("lower", "upper"):
        a, b = np.asarray(got[key]), np.asarray(want[key])
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        assert np.all(np.abs(a[fin] - b[fin]) <= 2 * step + 1e-6), (a, b)
    np.testing.assert_array_equal(np.isnan(got["sims"]),
                                  np.isnan(want["sims"]))
    np.testing.assert_allclose(got["sims"], want["sims"], **CI_SIMS)


# ------------------------------------------------------------- statistics
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_argmedian_and_mann_whitney_match_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=11 + seed).astype(np.float32)
    y = rng.normal(0.3, 1.0, 9)
    if seed == 2:
        x[:4] = x[0]          # ties
    assert stats.argmedian(x) == jstats.argmedian(x)
    assert stats.argmedian(np.asarray([1.0, 3.0, 2.0, 4.0])) == 1
    np.testing.assert_allclose(stats.mann_whitney_u(x, y),
                               jstats.mann_whitney_u(x, y), rtol=1e-12)


def test_data_section_pvalues(full, ref):
    g, train, test = full
    got = fp.section_data(g)["pvalues"]
    want = ref.pvalues(train, test)
    assert {f"{a}-{b}" for a, b in got} == set(want)
    for (a, b), p in got.items():
        np.testing.assert_allclose(p, want[f"{a}-{b}"], rtol=1e-12)


# ------------------------------------------------------------------- cude
def test_cude_medians_and_ci_bound_sims(cude_smoke, smoke, ref):
    """``ci_bound_sims`` of the test medians (Cantelli-95, K4's plain
    version here) against JAX's scan, from the port's refit β's."""
    g, _, test = smoke
    a = cude_smoke
    mdl = ref.model()
    nn = ref.jnp.asarray(np.load(ART / "cude_neural_parameters.npz")[
        "nn_params"][a["best"]])
    c_test = ref.cohort(test)
    err = ref.errors(mdl, nn, a["b_test"], c_test, test.cpeptide)
    _medians_agree(test.types, a["err_test"], err, a["idx_med_test"],
                   ref.medians(test.types, err))
    want = ref.ci_bound_sims(mdl, nn, a["b_test"], a["s_test"], c_test,
                             a["idx_med_test"], g.dense_t,
                             g.sizes.ci_steps, "cantelli95")
    _ci_close(a["ci"], want, g.sizes.ci_steps)
    np.testing.assert_allclose(
        a["sims_test"], ref.dense_sims(mdl, nn, a["b_test"], c_test,
                                       g.dense_t), **TRAJ)


def test_cude_dose_response_curves(cude_smoke, ref):
    a = cude_smoke
    nn = ref.jnp.asarray(np.load(ART / "cude_neural_parameters.npz")[
        "nn_params"][a["best"]])
    want = ref.production_curves(ref.model().net, nn, a["beta_grid"],
                                 ref.jnp.asarray(a["dg_grid"]))
    assert a["nn_curves"].shape == (20, 100)
    np.testing.assert_allclose(a["nn_curves"], want, **CURVES)


def test_cude_runner_up_and_type_mean_refits(cude_smoke, smoke, ref):
    g, train, test = smoke
    a = cude_smoke
    z = np.load(ART / "cude_neural_parameters.npz")
    mdl = ref.model()
    nn2 = ref.jnp.asarray(z["nn_params"][a["second"]])
    bnds2 = ref.bounds(z["betas"][a["second"]])
    b2 = np.concatenate([ref.refit(mdl, nn2, ref.cohort(s), bnds2,
                                   g.sizes.re_iters) for s in (train, test)])
    assert np.max(np.abs(a["b2_all"] - b2)) <= BETA_TOL
    assert abs(a["rho2"] - ref.spearman(b2, a["b_all"])) <= 0.01
    nn = ref.jnp.asarray(z["nn_params"][a["best"]])
    want = ref.type_means(mdl, nn, test, ref.bounds(z["betas"][a["best"]]),
                          g.sizes.re_iters, g.dense_t)
    c = a["comparison"]
    assert np.max(np.abs(c["b_mean"] - want["b_mean"])) <= BETA_TOL
    np.testing.assert_allclose(c["sims_ude"], want["sims_ude"], **TRAJ)
    # the cUDE's curves at the JAX β's, so the refit's miss does not count
    sel = [test.types == t for t in c["type_names"]]
    mean = fp.build_cohort(
        np.stack([test.glucose[s].mean(axis=0) for s in sel]),
        test.timepoints, c["mean_c"],
        np.array([test.ages[s].mean() for s in sel]),
        np.array([t == "T2DM" for t in c["type_names"]]), "cpu")
    model, nn_t, _ = g.cude
    np.testing.assert_allclose(
        g.dense(model, nn_t, np.array(want["b_mean"]), mean),
        want["sims_cude"],
        **TRAJ)


@pytest.fixture(scope="module")
def ci_gallery():
    """Every subject, the CI grid at the smoke size: the median subjects of
    all three types from the committed fits."""
    return fp.Gallery("cpu", ART, fp.RESULTS, fp.Sizes(ci_steps=200))


def test_cude_ci_bound_sims_of_each_type(ci_gallery, full, ref):
    """The test medians of the committed (β, σ) refit (one a type) and
    their Cantelli-95 ``ci_bound_sims``."""
    g = ci_gallery
    _, _, test = full
    fit, meta = load_checkpoint(ART / "cude_fit.npz")
    nn_np = np.load(ART / "cude_neural_parameters.npz")["nn_params"][
        meta["best_model_index"]]
    model = fp.cude_model()
    nn = params_from_jax(nn_np, model.net, "cpu")
    err = g.mse(model, nn, fit["beta_test"], g.cohort_test, g.test.cpeptide)
    c_test = ref.cohort(test)
    want_err = ref.errors(ref.model(), ref.jnp.asarray(nn_np),
                          fit["beta_test"], c_test, test.cpeptide)
    idx = fp.median_index_per_type(g.test.types, err)
    _medians_agree(test.types, err, want_err, idx,
                   ref.medians(test.types, want_err))
    got = fp.ci_bound_sims(g, model, nn, fit["beta_test"], fit["sigma_test"],
                           g.cohort_test, idx)
    want = ref.ci_bound_sims(ref.model(), ref.jnp.asarray(nn_np),
                             fit["beta_test"], fit["sigma_test"], c_test,
                             idx, g.dense_t, 200, "cantelli95")
    _ci_close(got, want, 200)


def test_covariate_ci_bound_sims(ci_gallery, full, ref):
    """Raue-95 ``ci_bound_sims`` on the covariate model (K4c's plain
    version) from the committed fit, the test medians of each type."""
    g = ci_gallery
    _, _, test = full
    zc, meta = load_checkpoint(ART / "cude_covariate_fit.npz")
    nn_np = np.load(ART / "cude_covariate_neural_parameters.npz")[
        "nn_params"][meta["best_model_index"]]
    want = ref.covariate(test, 200)
    idx = fp.median_index_per_type(
        g.test.types, zc["sse_test"] / len(test.timepoints))
    assert list(idx) == want["idx_med_test"] and len(idx) == 3
    model = fp.cude_model(3)
    got = fp.ci_bound_sims(g, model, params_from_jax(nn_np, model.net, "cpu"),
                           zc["beta_test"], zc["sigma_test"], g.cohort_test,
                           idx, method="raue95")
    _ci_close(got, want["ci"], 200)


# ----------------------------------------------- the sections at full size
def test_ude_external_and_symbolic_trajectories(full, ref):
    g, train, test = full
    np.testing.assert_allclose(fp.section_ude(g)["sims"],
                               ref.ude(test)["sims"], **TRAJ)
    np.testing.assert_allclose(fp.section_external(g)["sims"],
                               ref.external()["sims"], **TRAJ)
    fit, meta = load_checkpoint(ART / "cude_fit.npz")
    model = fp.cude_model()
    nn = params_from_jax(np.load(ART / "cude_neural_parameters.npz")[
        "nn_params"][meta["best_model_index"]], model.net, "cpu")
    g.cude = (model, nn, fit["beta_train"])
    got, want = fp.section_symbolic(g), ref.symbolic(train, test)
    np.testing.assert_allclose(got["sims"], want["sims"], **TRAJ)
    np.testing.assert_allclose(got["err"], want["err"], rtol=1e-4,
                               atol=1e-8)
    assert list(got["idx_med"]) == want["idx_med"]
    for key in ("nn_curves", "sym_curves", "disc_curves"):
        np.testing.assert_allclose(got[key], want[key], **CURVES)


def test_suppression_trajectories(full, ref):
    got, want = fp.section_suppression(full[0]), ref.suppression()
    assert got["restart"] == want["restart"]
    np.testing.assert_array_equal(got["idx"], want["idx"])
    np.testing.assert_allclose(got["ys"], want["ys"], **TRAJ)


def test_saem_posterior_bands(full, ref):
    g, train, test = full
    got, want = fp.section_saem(g)["bands"], ref.saem(train, test)
    assert set(got) == set(want)
    for t, w in want.items():
        assert got[t]["subject"] == w["subject"]
        for key in ("p05", "p95", "median"):
            np.testing.assert_allclose(got[t][key], w[key], **TRAJ)


# -------------------------------------------------- the figure functions
def _figure_calls(rng):
    types = np.array(["NGT"] * 5 + ["IGT"] * 3 + ["T2DM"] * 4)
    tp = np.array([0.0, 30.0, 60.0, 90.0, 120.0])
    obs = rng.uniform(0.5, 2.0, (len(types), 5))
    dense_t = np.linspace(0, 120, 25)
    sims = rng.uniform(0.5, 2.0, (len(types), 25))
    dg = np.linspace(0, 8, 40)
    curves = np.outer(np.linspace(0.5, 2, 6), np.tanh(dg / 4))
    grid = np.linspace(-4, 1, 50)
    band = {t: {"p05": sims[0] - 0.2, "p95": sims[0] + 0.2,
                "median": sims[0], "mean": sims[0]} for t in fp.TYPES}
    per_type = {t: obs[0] for t in fp.TYPES}
    return {
        "error_violins": lambda: figures.error_violins(
            rng.uniform(0.01, 0.5, len(types)), types),
        "model_fit_panels": lambda: figures.model_fit_panels(
            tp, obs, sims, types, indices=[0, 5, 8], dense_t=dense_t,
            ci_simulations={0: (sims[1], None), 1: (None, sims[2])}),
        "correlation_scatter": lambda: figures.correlation_scatter(
            rng.uniform(-2, 0, len(types)), rng.uniform(0, 100, len(types)),
            types, rho=-0.64),
        "loss_trace": lambda: figures.loss_trace(
            rng.uniform(0.1, 1, (3, 50)).cumsum(axis=1)),
        "data_overview": lambda: figures.data_overview(tp, obs * 5, obs,
                                                       types),
        "clamp_insulin_illustration": lambda:
            figures.clamp_insulin_illustration(
                np.array([0, 5, 10, 15, 60, 75, 90.0]),
                rng.uniform(5, 80, (len(types), 7)), types),
        "fit_grid": lambda: figures.fit_grid(tp, obs, dense_t, sims, types,
                                             ncols=4),
        "quantile_fit_band": lambda: figures.quantile_fit_band(
            dense_t, sims, tp, obs),
        "dose_response": lambda: figures.dose_response(
            dg, curves, np.linspace(-2, 0, 6)),
        "dose_response_compare": lambda: figures.dose_response_compare(
            dg, curves[:3], curves[:3] * 1.1, np.linspace(-2, 0, 3)),
        "beta_distribution": lambda: figures.beta_distribution(
            rng.uniform(-2, 0, len(types)), types),
        "likelihood_curves": lambda: figures.likelihood_curves(
            grid, (grid[None, :] + rng.uniform(-1, 1, (5, 1))) ** 2, 7.16,
            types=types[:5]),
        "candidate_beta_grid": lambda: figures.candidate_beta_grid(
            rng.uniform(-2, 0, (6, len(types))),
            rng.uniform(0, 100, len(types)), ncols=3),
        "ablation_curve": lambda: figures.ablation_curve(
            np.linspace(0.1, 1, 10), rng.uniform(0.2, 0.8, 10),
            band=(np.full(10, 0.1), np.full(10, 0.9))),
        "selection_sensitivity": lambda: figures.selection_sensitivity(
            [0.0, 0.01, 0.1, 1.0], {"valid_loss": [0.5, 0.6, np.nan, 0.7],
                                    "valid_rho": [0.8, 0.8, 0.9, 0.85]}),
        "pareto_front": lambda: figures.pareto_front(
            [1, 3, 7, 11, 16], [0.06, 0.02, 0.005, 0.004, 0.0035],
            chosen=16),
        "comparison_panels": lambda: figures.comparison_panels(
            dense_t, sims[:3], sims[3:6], tp, obs[:3], 0.1 * obs[:3],
            list(fp.TYPES)),
        "age_distributions": lambda: figures.age_distributions(
            rng.uniform(30, 70, len(types)), types,
            {("NGT", "IGT"): 0.2, ("NGT", "T2DM"): 0.01}),
        "scatter_compare": lambda: figures.scatter_compare(
            rng.uniform(-2, 0, 12), rng.uniform(-2, 0, 12), "MLE", "MAP",
            types=types),
        "replication_strip": lambda: figures.replication_strip(
            {"a": [0.1, 0.2, 0.3], "b": [0.4, 0.5, 0.45]},
            canonical={"a": 0.2}, xlim=(-1, 1), refline=0.0),
        "correlation_panels": lambda: figures.correlation_panels(
            rng.uniform(0.1, 1, len(types)),
            [("age", rng.uniform(30, 70, len(types))),
             ("isi", rng.uniform(0, 10, len(types)))], types),
        "band_panels": lambda: figures.band_panels(
            dense_t, band, tp, per_type, obs_err=per_type, center="mean"),
        "quantile_ci_panels": lambda: figures.quantile_ci_panels(
            dense_t, [("25%", sims[0], sims[1], None, obs[0]),
                      ("50%", sims[2], None, None, obs[1])], tp),
    }


FIGURES = sorted(_figure_calls(np.random.default_rng(0)))


@pytest.mark.parametrize("name", FIGURES)
def test_figure_renders(name, tmp_path):
    build = _figure_calls(np.random.default_rng(2705))[name]
    path = tmp_path / f"{name}.png"
    figures.save(build(), path)
    assert path.stat().st_size > 1000


def test_every_figure_function_is_rendered():
    public = {n for n, f in vars(figures).items()
              if callable(f) and not n.startswith("_")
              and getattr(f, "__module__", "") == figures.__name__}
    assert public - {"save", "available"} == set(FIGURES)


# ----------------------------------------------------- the entry point
def _gallery(out: Path, *args, hide_matplotlib: bool = False):
    """The gallery at --smoke with ``--out out.parent``: its outputs land in
    ``out``, the ``smoke`` directory there."""
    code = ("import sys\n"
            + ("sys.modules['matplotlib'] = None\n" if hide_matplotlib
               else "")
            + "from conditional_ude_tpu_torch.__main__ import main\n"
            "main(sys.argv[1:])\n")
    return subprocess.run(
        [sys.executable, "-c", code, "--experiment", "exp_figures",
         "--smoke", "--device", "cpu", "--out", str(out.parent), *args],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "2",
             "MPLCONFIGDIR": str(out.parent)})


def test_gallery_smoke_and_manifest_merge(tmp_path):
    out = tmp_path / "gallery" / "smoke"
    r = _gallery(out, "--sections", "data", "external")
    assert r.returncode == 0, r.stderr[-2000:]
    manifest = json.loads((out / fp.MANIFEST).read_text())
    assert json.loads(r.stdout.strip().splitlines()[-1]) == manifest
    assert {"data_overview.png", "supp_age.png",
            "model_fit_external.png"} <= set(manifest["rendered"])
    for f in manifest["rendered"]:
        assert (out / "figures" / f).stat().st_size > 1000
    r = _gallery(out, "--sections", "ablation")
    assert r.returncode == 0, r.stderr[-2000:]
    merged = json.loads((out / fp.MANIFEST).read_text())
    assert set(manifest["rendered"]) < set(merged["rendered"])
    assert "performance_less_data.png" in merged["rendered"]
    assert merged["count"] == len(merged["rendered"])
    assert '{"launches": {}}' in r.stderr


def test_gallery_without_matplotlib_computes_every_section(tmp_path):
    out = tmp_path / "gallery" / "smoke"
    r = _gallery(out, hide_matplotlib=True)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {
        "rendered": [], "count": 0}
    assert not (out / "figures").exists()
    seconds = json.loads(next(line for line in r.stderr.splitlines()
                              if line.startswith('{"stage_seconds"')))
    assert set(seconds["stage_seconds"]) == set(fp.SECTIONS)
    assert r.stderr.count(fp.NO_MATPLOTLIB) >= 30


def test_gallery_refuses_to_run_without_out(capsys):
    from conditional_ude_tpu_torch.__main__ import main
    with pytest.raises(SystemExit):
        main(["--experiment", "exp_figures", "--device", "cpu"])
    assert "--out" in capsys.readouterr().err
