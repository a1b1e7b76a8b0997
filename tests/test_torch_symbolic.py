"""PyTorch port: the symbolic refits (``models/symbolic.py``,
``analysis/profiles.py::likelihood_profile``, ``data/fujita.py``) against
the JAX package on the CPU.

Tolerances: the productions and ``beta_to_k`` rtol 1e-5; the (k, σ) and
(b, σ) fits at 100 L-BFGS steps objective rtol 1e-4, parameter rtol 2e-3
and σ rtol 5e-3 (the β/σ limits of ``tests/test_torch_frozen.py``, the
parameter limit made relative since k runs to hundreds; one subject where
JAX on the CPU stops early is held to the committed fit); the Tsit5
profiles' trajectories rtol 2e-2 / atol 1e-3 (the JAX suite's Tsit5
tolerance), their NLL within what trajectories at that tolerance can
change, and the same census; the RK4 profile rtol 1e-4
(``tests/test_torch_frozen.py``'s profile limit).

Run as a script, the file runs the JAX package's exp03, exp04 and
exp_symreg_production fits at full size on the CPU (117 Ohashi subjects and
the 20 of Fujita, 1000 L-BFGS steps, the 10,000-point profiles and their
census) and prints, as one JSON line, how far they are from the committed
fits ``artifacts/symreg_fit.npz``, ``symreg_external_fit.npz`` and
``discovered_fit.npz``, which came from a TPU, with every Ohashi
subject's (b, σ, objective) of the discovered model's fit (~10 minutes):

    python tests/test_torch_symbolic.py
"""

import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":      # pytest's conftest does both for the tests
    sys.path.insert(0, str(REPO))
    jax.config.update("jax_platforms", "cpu")

from conditional_ude_tpu.analysis import profiles as jprof  # noqa: E402
from conditional_ude_tpu.fit import losses as jlosses  # noqa: E402
from conditional_ude_tpu.models import cpeptide as jcp  # noqa: E402
from conditional_ude_tpu.models import symbolic as jsym  # noqa: E402
from conditional_ude_tpu.utils.stats import spearman  # noqa: E402
from conditional_ude_tpu_torch import symbolic_pipeline  # noqa: E402
from conditional_ude_tpu_torch.analysis import profiles as prof  # noqa: E402
from conditional_ude_tpu_torch.data.fujita import load_fujita_npz  # noqa: E402
from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz  # noqa: E402
from conditional_ude_tpu_torch.fit.losses import sse  # noqa: E402
from conditional_ude_tpu_torch.models import cpeptide as cp  # noqa: E402
from conditional_ude_tpu_torch.models import symbolic as sym  # noqa: E402

ART = REPO / "artifacts"


def _jax_cohorts():
    """The 117 Ohashi subjects (training split first) and the 20 of
    Fujita as JAX cohorts, read from the committed ``.npz`` files."""
    both = OhashiSplit.concatenate(*load_npz(ART / "ohashi.npz"))
    ohashi = jcp.build_cohort(both.glucose, both.timepoints, both.cpeptide,
                              both.ages, both.t2dm)
    with np.load(ART / "fujita.npz") as f:
        fujita = jcp.build_cohort(f["glucose"], f["timepoints"],
                                  f["cpeptide"], f["ages"],
                                  np.zeros(len(f["ages"]), bool))
    return both, ohashi, fujita


def _sse(objs, sigmas, n_t):
    return (objs - (n_t / 2) * np.log(sigmas**2)) * (2 * sigmas**2)


def _tsit5_profile(model, key, cohort, sigmas, grid):
    """NLL of every subject at every grid point, Tsit5 at the JAX defaults,
    in chunks of 250 points (``experiments/exp03_symreg.py:72-85``)."""
    chunk = jax.jit(jax.vmap(
        lambda ind, d, s, g: jax.vmap(
            lambda x: jlosses.sse(model, {key: x}, ind, cohort.timepoints, d)
            / (2.0 * s**2))(g),
        in_axes=(0, 0, 0, None)))
    parts = [np.asarray(chunk(cohort.individuals, cohort.cpeptide,
                              jnp.asarray(sigmas), grid[i:i + 250]))
             for i in range(0, grid.shape[0], 250)]
    return np.concatenate(parts, axis=1)


def _census(grid, values):
    ci = jprof.find_confidence_intervals(
        jprof.Profile(grid=np.asarray(grid), values=values,
                      minimum=values.min(axis=1)), "cantelli95")
    census = jprof.classify_identifiability(ci)
    return {str(c): int((census == c).sum()) for c in np.unique(census)}


def _miss(got, want):
    """Largest relative difference and the subject it belongs to."""
    rel = np.abs(np.asarray(got) / np.asarray(want) - 1.0)
    i = int(np.argmax(rel))
    return {"max_rel": float(rel[i]), "subject": i,
            "n_over_2pct": int((rel > 0.02).sum())}


def reference() -> dict:
    """The JAX package's three symbolic experiments at full size on the
    CPU, against the committed fits and metrics."""
    both, ohashi, fujita = _jax_cohorts()
    out = {}
    t0 = time.perf_counter()
    ks, sk, ok = map(np.asarray, jsym.fit_k_sigma(ohashi, lbfgs_iters=1000))
    sse = _sse(ok, sk, 5)
    fit = np.load(ART / "symreg_fit.npz")
    metrics = json.loads((REPO / "results" / "exp03_metrics.json").read_text())
    values = _tsit5_profile(jsym.symbolic_model(), "k", ohashi, sk,
                            jnp.linspace(0.0, 1000.0, 10_000))
    out["exp03"] = {
        "k": _miss(ks, fit["ks"]), "sigma": _miss(sk, fit["sigmas"]),
        "spearman_first_phase": spearman(ks, both.first_phase),
        "committed_spearman_first_phase":
            metrics["spearman"]["first_phase"],
        "sse_mean": float(sse.mean()),
        "census": _census(jnp.linspace(0.0, 1000.0, 10_000), values),
        "committed_census": metrics["identifiability_census"],
        "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    kf, sf, of = map(np.asarray, jsym.fit_k_sigma(
        fujita, lbfgs_iters=1000, solver_max_steps=512))
    fit = np.load(ART / "symreg_external_fit.npz")
    out["exp04"] = {"k": _miss(kf, fit["ks"]),
                    "sigma": _miss(sf, fit["sigmas"]),
                    "mse_mean": float((_sse(of, sf, 14) / 14).mean()),
                    "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    bs, sb, ob = map(np.asarray, jsym.fit_b_sigma(ohashi, lbfgs_iters=1000))
    bf, sbf, obf = map(np.asarray, jsym.fit_b_sigma(
        fujita, lbfgs_iters=1000, solver_max_steps=512))
    fit = np.load(ART / "discovered_fit.npz")
    metrics = json.loads((REPO / "results"
                          / "exp_symreg_production_metrics.json").read_text())
    values = _tsit5_profile(jsym.discovered_model(), "b", ohashi, sb,
                            jnp.linspace(1e-3, 10.0, 10_000))
    out["symreg_production"] = {
        "b": _miss(bs, fit["bs"]), "sigma": _miss(sb, fit["sigmas"]),
        "b_fujita": _miss(bf, fit["bs_fujita"]),
        "sigma_fujita": _miss(sbf, fit["sigmas_fujita"]),
        "spearman_first_phase": spearman(bs, both.first_phase),
        "committed_spearman_first_phase":
            metrics["spearman"]["first_phase"],
        "fujita_mse_mean": float((_sse(obf, sbf, 14) / 14).mean()),
        # every Ohashi subject's (b, σ, objective), to hold a row of the
        # port's fit on the card to
        "ohashi_rows": np.stack([bs, sb, ob], axis=1).tolist(),
        "census": _census(jnp.linspace(1e-3, 10.0, 10_000), values),
        "committed_census": metrics["identifiability_census"],
        "seconds": time.perf_counter() - t0}
    return out


# -- the tests -----------------------------------------------------------------

def test_productions_and_beta_to_k_match_jax():
    rng = np.random.default_rng(4)
    dg = rng.uniform(-3.0, 12.0, 200).astype(np.float32)
    k = rng.uniform(0.5, 400.0, 200).astype(np.float32)
    b = rng.uniform(0.01, 3.0, 200).astype(np.float32)
    for fn, theta in (("symbolic_production", k),
                      ("discovered_production", b)):
        out = getattr(sym, fn)(torch.as_tensor(dg), torch.as_tensor(theta))
        ref = getattr(jsym, fn)(jnp.asarray(dg), jnp.asarray(theta))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)
        assert (out.numpy()[dg <= 0] == 0).all()
    np.testing.assert_allclose(sym.beta_to_k(torch.as_tensor(b)).numpy(),
                               np.asarray(jsym.beta_to_k(jnp.asarray(b))),
                               rtol=1e-5)


@pytest.fixture(scope="module")
def cohorts():
    """Both packages' cohorts: 8 Ohashi subjects of the three types, and
    the first 4 of Fujita."""
    both = OhashiSplit.concatenate(*load_npz(ART / "ohashi.npz"))
    s = both.subset(SUBJECTS)
    f = load_fujita_npz(ART / "fujita.npz")
    out = {}
    for name, args in (
            ("ohashi", (s.glucose, s.timepoints, s.cpeptide, s.ages,
                        s.t2dm)),
            ("fujita", (f.glucose[:4], f.timepoints, f.cpeptide[:4],
                        f.ages[:4], f.t2dm[:4]))):
        out[name] = (cp.build_cohort(*args, device="cpu"),
                     jcp.build_cohort(*args))
    return out


# JAX on the CPU stops the (k, σ) fit of Ohashi subject 2 at k = 39.9996,
# hardly off its start of 40, at objective −5.213688; the port reaches
# k = 39.877 at −5.214230, as the TPU did (``symreg_fit.npz``: k = 39.874,
# σ = 0.21405).  That subject is held to the committed fit instead, and to
# an objective below JAX's (ROADMAP Queue 3).
JAX_CPU_STOPS = {("ohashi", "fit_k_sigma"): 2}
SUBJECTS = [0, 1, 2, 40, 60, 85, 100, 116]     # of the 117, both splits


@pytest.mark.parametrize("fit", ["fit_k_sigma", "fit_b_sigma"])
@pytest.mark.parametrize("cohort", ["ohashi", "fujita"])
def test_fits_match_jax(cohorts, fit, cohort):
    c, jc = cohorts[cohort]
    kw = dict(lbfgs_iters=100)
    if cohort == "fujita":
        kw["solver_max_steps"] = 512
    theta, sig, obj = (t.numpy() for t in getattr(sym, fit)(c, **kw))
    jtheta, jsig, jobj = (np.asarray(a) for a in getattr(jsym, fit)(jc, **kw))
    assert np.isfinite(obj).all()
    rows = np.ones(c.n, bool)
    stop = JAX_CPU_STOPS.get((cohort, fit))
    if stop is not None:
        rows[stop] = False
        committed = np.load(ART / "symreg_fit.npz")
        i = SUBJECTS[stop]
        assert obj[stop] < jobj[stop]
        np.testing.assert_allclose(theta[stop], committed["ks"][i], rtol=2e-3)
        np.testing.assert_allclose(sig[stop], committed["sigmas"][i],
                                   rtol=5e-3)
    np.testing.assert_allclose(obj[rows], jobj[rows], rtol=1e-4)
    np.testing.assert_allclose(theta[rows], jtheta[rows], rtol=2e-3)
    np.testing.assert_allclose(sig[rows], jsig[rows], rtol=5e-3)


def _jax_trajectories(model, key, cohort, grid):
    """``ys[N, S, T]`` of every subject at every grid point (Tsit5, the JAX
    defaults)."""
    return np.asarray(jax.vmap(lambda ind: jax.vmap(
        lambda x: jcp.simulate(model, {key: x}, ind, cohort.timepoints).ys[
            :, 0])(grid))(cohort.individuals))


@pytest.mark.parametrize("head", ["symbolic", "discovered"])
def test_tsit5_profiles_and_census_match_jax(cohorts, head):
    """exp03's k-profile (exp_symreg_production's b-profile) at 200 points,
    Tsit5 at the JAX defaults in chunks of 250.  Each NLL is held to the
    change that trajectories within the Tsit5 tolerance (rtol 2e-2, atol
    1e-3) can make to it: an NLL near its minimum is a small sum of
    squares, which two adaptive solves change by more than 2 %.  At k = 0
    the production is NaN at t = 0 and the NLL inf in both packages."""
    c, jc = cohorts["ohashi"]
    sig = np.linspace(0.1, 0.4, c.n).astype(np.float32)
    lo, hi = (0.0, 1000.0) if head == "symbolic" else (1e-3, 10.0)
    key = "k" if head == "symbolic" else "b"
    model, jmodel = (getattr(m, f"{head}_model")() for m in (sym, jsym))
    out = prof.cohort_beta_profiles(
        model, None, c, sigmas=sig, lower=lo, upper=hi, steps=200,
        chunk=symbolic_pipeline.PROFILE_CHUNK, solver="tsit5")
    grid = jnp.linspace(lo, hi, 200)
    ref = _tsit5_profile(jmodel, key, jc, sig, grid)
    np.testing.assert_allclose(out.grid.numpy(), np.asarray(grid), rtol=1e-6)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(out.values.numpy()), fin)
    if head == "symbolic":
        assert not fin[:, 0].any() and fin[:, 1:].all()
    ys = _jax_trajectories(jmodel, key, jc, grid)
    data = np.asarray(jc.cpeptide)[:, None, :]
    tol = 1e-3 + 2e-2 * np.abs(ys)
    bound = ((2.0 * np.abs(ys - data) + tol) * tol).sum(-1) \
        / (2.0 * sig[:, None] ** 2)
    port_ys = cp.simulate_cohort(model, None, torch.as_tensor(np.array(
        grid))[:, None].expand(-1, c.n), c, solver="tsit5").ys[..., 0]
    np.testing.assert_allclose(port_ys.numpy().transpose(1, 0, 2)[fin],
                               ys[fin], rtol=2e-2, atol=1e-3)
    diff = np.abs(out.values.numpy()[fin] - ref[fin])
    assert (diff <= bound[fin] + 1e-5 * np.abs(ref[fin])).all()
    census = prof.classify_identifiability(
        prof.find_confidence_intervals(out, "cantelli95"))
    assert _counts(census) == _census(grid, ref)


def _counts(census):
    return {str(c): int((census == c).sum()) for c in np.unique(census)}


def test_likelihood_profile_matches_jax(cohorts):
    """exp04's profile of one Fujita subject over [k − 25, k + 1000], RK4
    at 8 substeps, and its Cantelli-95 interval."""
    c, jc = cohorts["fujita"]
    i, k, sigma = 1, 48.45909, 0.3056813      # symreg_external_fit.npz
    one = symbolic_pipeline._row(c, i)
    model, jmodel = sym.symbolic_model(), jsym.symbolic_model()

    def loss(grid):
        return sse(model, None, grid[:, None], one, substeps=8)[:, 0]

    ind = jax.tree.map(lambda a: a[i], jc.individuals)

    def jloss(x):
        return jlosses.sse(jmodel, {"k": x}, ind, jc.timepoints,
                           jc.cpeptide[i], solver="rk4", substeps=8,
                           max_steps=512)

    out = prof.likelihood_profile(loss, k - 25.0, k + 1000.0, steps=200,
                                  sigma=sigma)
    ref = jprof.likelihood_profile(jloss, k - 25.0, k + 1000.0, steps=200,
                                   sigma=sigma)
    np.testing.assert_allclose(out.grid.numpy(), np.asarray(ref.grid),
                               rtol=1e-6)
    np.testing.assert_allclose(out.values.numpy(), np.asarray(ref.values),
                               rtol=1e-4)
    np.testing.assert_allclose(float(out.minimum), float(ref.minimum),
                               rtol=1e-4)
    ci = prof.find_confidence_intervals(out, "cantelli95")
    jci = jprof.find_confidence_intervals(ref, "cantelli95")
    assert (ci.lower, ci.upper) == (jci.lower, jci.upper)
    assert np.isfinite(ci.lower) and np.isfinite(ci.upper)


def test_fujita_cohort_from_npz(cohorts):
    """The cohort read from ``artifacts/fujita.npz`` in both packages: the
    tables copied to rows, every subject non-diabetic and 29, and ΔG
    measured from absolute t = 0, not from the first knot at −10: at t = 0
    each subject's steady state does not move."""
    f = load_fujita_npz(ART / "fujita.npz")
    assert f.glucose.shape == f.cpeptide.shape == (20, 14)
    assert f.glucose.flags["C_CONTIGUOUS"] and f.cpeptide.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(f.timepoints, [-10, 0, 10, 20, 30, 45, 60,
                                                 75, 90, 120, 150, 180, 210,
                                                 240])
    assert (f.ages == 29).all() and not f.t2dm.any()
    c = cp.build_cohort(f.glucose, f.timepoints, f.cpeptide, f.ages, f.t2dm,
                        "cpu")
    jc = jcp.build_cohort(f.glucose, f.timepoints, f.cpeptide, f.ages, f.t2dm)
    for name in ("k0", "k1", "k2", "c0"):
        np.testing.assert_allclose(getattr(c, name).numpy(),
                                   np.asarray(getattr(jc.individuals, name)),
                                   rtol=1e-6)
    model = sym.symbolic_model()
    k = torch.full((20,), 40.0)
    at0 = model.rhs(0.0, c.u0, None, k, c)
    assert float(at0.abs().max()) < 1e-6
    moved = f.glucose[:, 0] != f.glucose[:, 1]      # glucose(−10) ≠ glucose(0)
    assert moved.any()
    wrong = sym.symbolic_production(
        torch.as_tensor(f.glucose[:, 1] - f.glucose[:, 0], dtype=torch.float32),
        k)
    assert float(wrong[torch.as_tensor(moved)].abs().max()) > 1e-3
    res = cp.simulate_cohort(model, None, k, c)
    jres = jax.vmap(lambda ind: jcp.simulate(
        jsym.symbolic_model(), {"k": jnp.float32(40.0)}, ind, jc.timepoints,
        solver="rk4"))(jc.individuals)
    np.testing.assert_allclose(res.ys.numpy(), np.asarray(jres.ys),
                               rtol=1e-5, atol=1e-6)


def test_quantile_subject_breaks_the_median_tie_to_the_lower_index():
    """The median of 20 SSEs is the midpoint of the two middle subjects, so
    both are nearest it; in float32 the rounding of that midpoint picks
    one (JAX on the CPU subject 10 of Fujita, the port's own fit 15), in
    float64 the tie is exact and goes to the lower index, the committed
    fit's subject 10."""
    assert symbolic_pipeline.quantile_subject(
        np.array([1.0, 3.0, 2.0, 4.0], np.float32), 0.5) == 1
    fit = np.load(ART / "symreg_external_fit.npz")
    sse_vals = _sse(fit["objectives"], fit["sigmas"], 14)
    committed = json.loads((REPO / "results"
                            / "exp04_metrics.json").read_text())
    for q, want in committed["profile_ci_quantile_subjects"].items():
        assert symbolic_pipeline.quantile_subject(sse_vals, float(q)) \
            == want["subject"]


@pytest.mark.parametrize("run", ["run_exp03", "run_exp04",
                                 "run_symreg_production"])
def test_symbolic_pipelines_reduced(run):
    """Each experiment end to end at a reduced depth (5 L-BFGS steps, 20
    profile points): the JAX experiment script's metrics keys, and fits of every
    subject."""
    res = getattr(symbolic_pipeline, run)("cpu", ART, lbfgs_iters=5,
                                          profile_steps=20)
    name = {"run_exp03": "exp03", "run_exp04": "exp04",
            "run_symreg_production": "exp_symreg_production"}[run]
    committed = json.loads((REPO / "results"
                            / f"{name}_metrics.json").read_text())
    assert set(committed) <= set(res.metrics)
    committed_fit = np.load(ART / res.checkpoint)
    assert set(res.fits) == set(committed_fit)
    for key, arr in res.fits.items():
        assert arr.shape == committed_fit[key].shape and arr.dtype == np.float32
        assert np.isfinite(arr).all()
    census = res.metrics.get("identifiability_census")
    if census is not None:
        assert sum(census.values()) == 117


if __name__ == "__main__":
    print(json.dumps(reference()))
