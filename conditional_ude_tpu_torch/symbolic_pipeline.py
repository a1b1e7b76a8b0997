"""The symbolic refits end to end (counterpart of
``experiments/exp03_symreg.py``, ``experiments/exp04_symreg_external.py``
and ``experiments/exp_symreg_production.py``): the mechanistic equations
fitted subject by subject, the chain's last link from the learned network
to an equation.

* ``run_exp03``: (k, σ) of the symbolic model on all 117 Ohashi subjects;
  k's Spearman correlations with the clamp indices, and each subject's
  k-profile over [0, 1000] (10,000 points, Tsit5) with its Cantelli-95
  census;
* ``run_exp04``: (k, σ) on the 20 subjects of the Fujita cohort, and the
  profiles of the subjects at the 25/50/75 % SSE quantiles over
  [k − 25, k + 1000] (RK4, 8 substeps) with their confidence intervals,
  and each of these subjects simulated at k and at its CI's bounds, the
  arrays of ``model_fit_external_quantiles.png``;
* ``run_symreg_production``: (b, σ) of the in-repo discovered equation on
  Ohashi and on Fujita, and the b-profiles over [1e-3, 10] with their
  census.

The fits are RK4 at 16 substeps; the Ohashi profiles follow the JAX
experiment scripts, whose ``sse`` defaults to Tsit5.  Each run returns the
script's metrics and the arrays of its fit checkpoint.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from conditional_ude_tpu_torch.analysis.profiles import (
    classify_identifiability,
    cohort_beta_profiles,
    find_confidence_intervals,
    likelihood_profile,
)
from conditional_ude_tpu_torch.data.fujita import load_fujita_npz
from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
from conditional_ude_tpu_torch.fit.losses import sse
from conditional_ude_tpu_torch.models.cpeptide import (
    Cohort,
    build_cohort,
    simulate,
)
from conditional_ude_tpu_torch.models.symbolic import (
    discovered_model,
    fit_b_sigma,
    fit_k_sigma,
    symbolic_model,
)
from conditional_ude_tpu_torch.pipeline import (
    _cohort,
    _counts,
    _Stages,
    dense_grid,
    first_subjects,
    sse_per_type,
)
from conditional_ude_tpu_torch.utils.stats import spearman

PROFILE_CHUNK = 250     # grid points per profile chunk (the JAX experiment scripts')
# --smoke (experiments/exp03_symreg.py:39,49,66, exp04_symreg_external.py
# :29,34,64, exp_symreg_production.py:52,62,82): the first subjects of each
# Ohashi split (of the Fujita cohort for exp04), the fits' L-BFGS steps and
# the profiles' points
SMOKE_SUBJECTS = {"exp03": 8, "exp04": 4, "symreg_production": 8}
SMOKE_SIZES = dict(lbfgs_iters=100, profile_steps=200)


@dataclasses.dataclass
class SymbolicResult:
    metrics: dict                    # the JAX experiment script's metrics keys
    fits: dict[str, np.ndarray]      # the arrays of its fit checkpoint
    checkpoint: str                  # that checkpoint's file name
    figure: dict | None = None       # exp04: its CI-bound trajectories


def _sse(objectives, sigmas, n_t: int) -> np.ndarray:
    """The SSE back-converted from the σ-NLL."""
    return (objectives - (n_t / 2) * np.log(sigmas**2)) * (2 * sigmas**2)


def _numpy(*tensors):
    return tuple(t.cpu().numpy() for t in tensors)


def _ohashi(artifacts_dir: Path, dev: torch.device, subjects: int | None):
    both = OhashiSplit.concatenate(*first_subjects(
        *load_npz(artifacts_dir / "ohashi.npz"), subjects))
    return both, _cohort(both, dev)


def _fujita(artifacts_dir: Path, dev: torch.device,
            subjects: int | None = None) -> Cohort:
    f = load_fujita_npz(artifacts_dir / "fujita.npz")
    n = slice(subjects)
    return build_cohort(f.glucose[n], f.timepoints, f.cpeptide[n], f.ages[n],
                        f.t2dm[n], dev)


def _correlations(theta: np.ndarray, both: OhashiSplit) -> dict[str, float]:
    return {"first_phase": spearman(theta, both.first_phase),
            "age": spearman(theta, both.ages),
            "insulin_sensitivity": spearman(theta, both.insulin_sensitivity)}


def _census(model, cohort: Cohort, sigmas: np.ndarray, lower: float,
            upper: float, steps: int) -> dict[str, int]:
    """Cantelli-95 census of every subject's Tsit5 profile of its θ."""
    prof = cohort_beta_profiles(model, None, cohort, sigmas=sigmas,
                                lower=lower, upper=upper, steps=steps,
                                chunk=PROFILE_CHUNK, solver="tsit5")
    return _counts(classify_identifiability(
        find_confidence_intervals(prof, "cantelli95")))


def run_exp03(device: torch.device | str, artifacts_dir: str | Path,
              lbfgs_iters: int = 1000, profile_steps: int = 10_000,
              subjects: int | None = None) -> SymbolicResult:
    """Experiment 03 on ``device`` (the first ``subjects`` of each Ohashi
    split, as ``--smoke`` cuts them)."""
    dev = torch.device(device)
    both, cohort = _ohashi(Path(artifacts_dir), dev, subjects)
    stage = _Stages(dev)
    with stage("fit"):
        ks, sigmas, objs = _numpy(*fit_k_sigma(cohort,
                                               lbfgs_iters=lbfgs_iters))
    sse_vals = _sse(objs, sigmas, both.timepoints.shape[0])
    census = {}
    if profile_steps:
        with stage("profile"):
            census = _census(symbolic_model(), cohort, sigmas, 0.0, 1000.0,
                             profile_steps)
    return SymbolicResult(metrics={
        "k_mean": float(ks.mean()),
        "k_median": float(np.median(ks)),
        "sse_per_type": sse_per_type(both.types, sse_vals),
        "spearman": _correlations(ks, both),
        "identifiability_census": census,
        "stage_seconds": stage.seconds,
    }, fits={"ks": ks, "sigmas": sigmas, "objectives": objs},
        checkpoint="symreg_fit.npz")


def run_exp04(device: torch.device | str, artifacts_dir: str | Path,
              lbfgs_iters: int = 1000, profile_steps: int = 10_000,
              subjects: int | None = None) -> SymbolicResult:
    """Experiment 04 on ``device`` (the first ``subjects`` of the Fujita
    cohort, as ``--smoke`` cuts them)."""
    dev = torch.device(device)
    cohort = _fujita(Path(artifacts_dir), dev, subjects)
    stage = _Stages(dev)
    with stage("fit"):
        ks, sigmas, objs = _numpy(*fit_k_sigma(
            cohort, lbfgs_iters=lbfgs_iters, solver_max_steps=512))
    n_t = cohort.timepoints.shape[0]
    sse_vals = _sse(objs, sigmas, n_t)
    model = symbolic_model()

    quantile_ci, panels = {}, {}
    t_obs = cohort.timepoints
    dense_t = dense_grid(t_obs)
    with stage("profile"):
        for q in (0.25, 0.5, 0.75):
            i = quantile_subject(sse_vals, q)
            one = _row(cohort, i)

            def loss_k(grid: torch.Tensor) -> torch.Tensor:
                with torch.no_grad():
                    return sse(model, None, grid[:, None], one,
                               substeps=8)[:, 0]

            prof = likelihood_profile(loss_k, float(ks[i]) - 25.0,
                                      float(ks[i]) + 1000.0,
                                      steps=profile_steps,
                                      sigma=float(sigmas[i]), device=dev)
            ci = find_confidence_intervals(prof, "cantelli95")
            quantile_ci[str(q)] = {"subject": i, "k": float(ks[i]),
                                   "ci_lower": float(ci.lower),
                                   "ci_upper": float(ci.upper)}
            panels[str(q)] = ci_trajectories(model, one, dense_t, ks[i],
                                             ci.lower, ci.upper)
            panels[str(q)]["observed"] = one.cpeptide[0].cpu().numpy()
    return SymbolicResult(metrics={
        "n_subjects": int(cohort.n),
        "k_mean": float(ks.mean()),
        "k_median": float(np.median(ks)),
        "k_quantiles": {q: float(np.quantile(ks, float(q)))
                        for q in ("0.25", "0.5", "0.75")},
        "profile_ci_quantile_subjects": quantile_ci,
        "mse_mean": float((sse_vals / n_t).mean()),
        "all_finite": bool(np.isfinite(objs).all()),
        "stage_seconds": stage.seconds,
    }, fits={"ks": ks, "sigmas": sigmas, "objectives": objs},
        checkpoint="symreg_external_fit.npz",
        figure={"dense_t": dense_t, "timepoints": t_obs, "panels": panels})


def ci_trajectories(model, one: Cohort, dense_t: np.ndarray, k: float,
                    lower: float, upper: float) -> dict:
    """One subject simulated on ``dense_t`` (RK4, 4 substeps) at ``k`` and
    at its CI's bounds (``experiments/exp04_symreg_external.py:113-122``):
    ``{"fit": [T], "lower", "upper": [T] or None where the CI is open}``."""
    thetas = [k] + [b for b in (lower, upper) if np.isfinite(b)]
    with torch.no_grad():
        ys = simulate(model, None, np.asarray(thetas, np.float32), one,
                      dense_t, solver="rk4", substeps=4).ys[..., 0]
    ys = list(ys.cpu().numpy())
    return {"fit": ys.pop(0),
            "lower": ys.pop(0) if np.isfinite(lower) else None,
            "upper": ys.pop(0) if np.isfinite(upper) else None}


def draw_external_quantiles(figure: dict, path: Path) -> None:
    """exp04's ``model_fit_external_quantiles.png`` from ``run_exp04``'s
    ``figure``."""
    from conditional_ude_tpu_torch.utils import figures

    figures.save(figures.quantile_ci_panels(
        figure["dense_t"],
        [(f"{int(float(q) * 100)}%", p["fit"], p["lower"], p["upper"],
          p["observed"]) for q, p in figure["panels"].items()],
        figure["timepoints"]), path)


def run_symreg_production(device: torch.device | str,
                          artifacts_dir: str | Path, lbfgs_iters: int = 1000,
                          profile_steps: int = 10_000,
                          subjects: int | None = None) -> SymbolicResult:
    """The discovered equation's refits (``exp_symreg_production``) on
    ``device`` (the first ``subjects`` of each Ohashi split, as ``--smoke``
    cuts them; the Fujita cohort whole, as the JAX script fits it)."""
    dev = torch.device(device)
    artifacts_dir = Path(artifacts_dir)
    both, cohort = _ohashi(artifacts_dir, dev, subjects)
    fujita = _fujita(artifacts_dir, dev)
    stage = _Stages(dev)
    with stage("fit"):
        bs, sigmas, objs = _numpy(*fit_b_sigma(cohort,
                                               lbfgs_iters=lbfgs_iters))
    n_t = both.timepoints.shape[0]
    sse_vals = _sse(objs, sigmas, n_t)
    census = {}
    if profile_steps:
        with stage("profile"):
            census = _census(discovered_model(), cohort, sigmas, 1e-3, 10.0,
                             profile_steps)
    with stage("fit_fujita"):
        bs_f, sig_f, objs_f = _numpy(*fit_b_sigma(
            fujita, lbfgs_iters=lbfgs_iters, solver_max_steps=512))
    n_tf = fujita.timepoints.shape[0]
    mse_f = _sse(objs_f, sig_f, n_tf) / n_tf
    return SymbolicResult(metrics={
        "equation": "0.1817*dG / (b^2*(dG + 5.507) + 2.99)",
        "b_mean": float(bs.mean()),
        "b_median": float(np.median(bs)),
        "mse_per_type": sse_per_type(both.types, sse_vals / n_t),
        "spearman": _correlations(bs, both),
        "identifiability_census": census,
        "fujita_external": {"n": int(len(bs_f)),
                            "mse_mean": float(mse_f.mean()),
                            "mse_median": float(np.median(mse_f)),
                            "b_median": float(np.median(bs_f))},
        "stage_seconds": stage.seconds,
    }, fits={"bs": bs, "sigmas": sigmas, "objectives": objs,
             "bs_fujita": bs_f, "sigmas_fujita": sig_f,
             "objectives_fujita": objs_f},
        checkpoint="discovered_fit.npz")


def quantile_subject(values: np.ndarray, q: float) -> int:
    """The subject whose value is nearest the ``q`` quantile
    (``experiments/exp04_symreg_external.py:91-92``), in float64: the
    median of an even count is the midpoint of the two middle subjects, an
    exact tie that goes to the lower index, where float32 distances would
    break it by rounding."""
    values = np.asarray(values, np.float64)
    return int(np.argmin(np.abs(values - np.quantile(values, q))))


def _row(cohort: Cohort, i: int) -> Cohort:
    """Individual ``i`` of ``cohort`` as a one-row cohort."""
    return dataclasses.replace(cohort, **{
        f.name: getattr(cohort, f.name)[i:i + 1]
        for f in dataclasses.fields(cohort) if f.name != "timepoints"})
