"""The figure gallery end to end (counterpart of ``experiments/exp_figures.py``):
the paper's figures from the committed fits and results, section by
section.

Each section is a function that computes its figures' arrays from the
artifacts directory and the committed ``results/`` (both read, never
written) and returns them as a dict of numpy arrays, or None when its input
is missing (a note says so); a ``draw_*`` function of the same section turns
those arrays into named figures through ``utils/figures.py``.  Where
matplotlib cannot be imported (the card's machine has none) every section
still computes and nothing is drawn.

* ``data``: the cohort overview and the per-type ages with their three
  Mann-Whitney p-values;
* ``cude``: the selected network's fits, median subjects and their
  profile-CI-bound trajectories (``ci_bound_sims``: three subjects × the
  grid, K4 on the card), correlations, dose-response curves, likelihood
  curves, the candidates' β's, the runner-up network's refit, and the
  cUDE-against-UDE fits of the type means;
* ``covariate``: the covariate model's median fits and CI-bound
  trajectories (Raue-95, K4c on the card) and correlations;
* ``ude``, ``symbolic``, ``external``, ``ablation``, ``suppression``,
  ``saem``, ``replication``: the remaining figures of those experiments.

The cohorts and the Fujita cohort come from ``artifacts/ohashi.npz`` and
``artifacts/fujita.npz``.  The clamp insulin lies only in the reference's
raw CSV files: its figure is drawn when ``data_dir`` holds
``ohashi_csv/ohashi_clamp_blood.csv`` (``data/ohashi.py::load_clamp_insulin``)
and skipped with a note otherwise.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from conditional_ude_tpu_torch.analysis.profiles import (
    THRESHOLDS,
    cohort_beta_profiles,
    find_confidence_intervals,
)
from conditional_ude_tpu_torch.convert import params_from_jax
from conditional_ude_tpu_torch.data.fujita import load_fujita_npz
from conditional_ude_tpu_torch.data.ohashi import (
    OhashiSplit,
    load_clamp_insulin,
    load_npz,
)
from conditional_ude_tpu_torch.fit.train import fit_betas, fit_betas_sigma
from conditional_ude_tpu_torch.models import suppression as sup
from conditional_ude_tpu_torch.models.cpeptide import (
    Cohort,
    CPeptideModel,
    build_cohort,
    simulate,
    simulate_cohort,
)
from conditional_ude_tpu_torch.models.symbolic import (
    beta_to_k,
    discovered_production,
    fit_k_sigma,
    symbolic_model,
    symbolic_production,
)
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.pipeline import (
    TYPES,
    _cohort,
    _Stages,
    dense_grid,
    ude_model,
    widened_bounds,
)
from conditional_ude_tpu_torch.suppression_pipeline import (
    DATA_SEED,
    FULL as SUPPRESSION_SIZES,
    GROUP_MEANS,
    TIMEPOINTS as SUPPRESSION_TIMEPOINTS,
)
from conditional_ude_tpu_torch.utils import figures
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint
from conditional_ude_tpu_torch.utils.stats import (
    argmedian,
    mann_whitney_u,
    spearman,
)

REPO = Path(__file__).resolve().parent.parent
RESULTS = REPO / "results"
SECTIONS = ("data", "cude", "covariate", "ude", "symbolic", "external",
            "ablation", "suppression", "saem", "replication")
MANIFEST = "exp_figures_manifest.json"
NO_MATPLOTLIB = "matplotlib is not installed: its arrays were computed"


@dataclasses.dataclass(frozen=True)
class Sizes:
    subjects: int | None = None   # the first subjects of each split
    re_iters: int = 1000          # L-BFGS steps of the refits
    prof_steps: int = 2000        # the likelihood curves' scan (no census)
    ci_steps: int = 10_000        # ci_bound_sims' grid over Δβ ∈ [-10, 15]


FULL = Sizes()
SMOKE = Sizes(subjects=8, re_iters=100, prof_steps=200, ci_steps=200)


def note(kind: str, name: str, why: str = "") -> None:
    print(f"[{kind}] {name}" + (f": {why}" if why else ""), file=sys.stderr)


def _t(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _read_csv(path: Path) -> list[dict]:
    with path.open() as f:
        return list(csv.DictReader(f))


def rows(cohort: Cohort, idx) -> Cohort:
    """The individuals ``idx`` of ``cohort`` as a cohort of their own."""
    sel = torch.as_tensor(np.atleast_1d(idx), device=cohort.device)
    return dataclasses.replace(cohort, **{
        f.name: getattr(cohort, f.name)[sel]
        for f in dataclasses.fields(cohort) if f.name != "timepoints"})


def median_index_per_type(types: np.ndarray, errors: np.ndarray) -> np.ndarray:
    """The median-error subject of each type present (``argmedian``)."""
    idx = []
    for t in TYPES:
        sel = np.flatnonzero(types == t)
        if sel.size:
            idx.append(int(sel[argmedian(errors[sel])]))
    return np.asarray(idx, int)


class Gallery:
    """What the sections share: the device, the inputs' folders, the sizes,
    the cohorts and the 2-minute grid; the cUDE section leaves its network
    here for the symbolic section's overlays."""

    def __init__(self, device, artifacts_dir: Path, results_dir: Path,
                 sizes: Sizes, data_dir: Path | None = None):
        self.dev = torch.device(device)
        self.data_dir = data_dir
        self.art, self.results, self.sizes = (Path(artifacts_dir),
                                              Path(results_dir), sizes)
        train, test = load_npz(self.art / "ohashi.npz")
        if sizes.subjects is not None:
            train, test = (s.subset(np.arange(min(sizes.subjects,
                                                  len(s.ages))))
                           for s in (train, test))
        self.train, self.test = train, test
        self.both = OhashiSplit.concatenate(train, test)
        self.cohort_train, self.cohort_test, self.cohort_all = (
            _cohort(s, self.dev) for s in (train, test, self.both))
        self.dense_t = dense_grid(train.timepoints)
        self.cude = None    # (model, nn_best, b_train) once the cUDE ran

    def dense(self, model, nn, lanes, cohort: Cohort, saveat=None):
        """Every lane of ``cohort`` on ``saveat`` (the 2-minute grid by
        default), RK4 at 4 substeps: ``[..., N, T]``."""
        saveat = self.dense_t if saveat is None else saveat
        with torch.no_grad():
            return _np(simulate_cohort(model, nn, lanes, cohort,
                                       saveat=saveat, solver="rk4",
                                       substeps=4).ys[..., 0])

    def mse(self, model, nn, lanes, cohort: Cohort, observed) -> np.ndarray:
        """Each subject's MSE at its lane on the observation grid, Tsit5 at
        the JAX defaults (the JAX ``simulate_cohort``'s)."""
        with torch.no_grad():
            ys = simulate_cohort(model, nn, lanes, cohort,
                                 solver="tsit5").ys[..., 0]
        return np.mean((_np(ys) - observed) ** 2, axis=1)


def cude_model(input_dims: int = 2) -> CPeptideModel:
    kind = "conditional_covariate" if input_dims == 3 else "conditional"
    return CPeptideModel(chain(4, 2, "tanh", input_dims=input_dims), kind)


def ci_bound_sims(g: Gallery, model: CPeptideModel, nn: torch.Tensor,
                  betas, sigmas, cohort: Cohort, idx,
                  method: str = "cantelli95") -> dict:
    """Profile-CI-bound trajectories of the subjects ``idx``
    (``experiments/exp_figures.py:94-130``): their β-profiles over
    Δβ ∈ [−10, 15] around each β̂ in one ``cohort_beta_profiles`` call
    (``center=β̂``, 8 substeps; K4 or K4c on the card, one launch a chunk
    of 500 points × the subjects), the threshold crossings by ``method``,
    and each subject simulated at β̂ + each finite bound on the 2-minute
    grid (RK4, 4 substeps).

    Returns ``{"lower", "upper": Δβ [n] (±inf where open), "beta": β̂ [n],
    "sims": [n, 2, T] (NaN rows where open)}``."""
    idx = np.asarray(idx, int)
    b_sel = np.asarray(betas, np.float32)[idx]
    s_sel = np.asarray(sigmas, np.float32)[idx]
    sub = rows(cohort, idx)
    prof = cohort_beta_profiles(model, nn, sub, sigmas=s_sel, lower=-10.0,
                                upper=15.0, steps=g.sizes.ci_steps,
                                center=b_sel, substeps=8)
    ci = find_confidence_intervals(prof, method)
    sims = np.full((len(idx), 2, len(g.dense_t)), np.nan, np.float32)
    for pos in range(len(idx)):
        for side, delta in enumerate((ci.lower[pos], ci.upper[pos])):
            if np.isfinite(delta):
                beta = np.float32(float(b_sel[pos]) + delta)
                with torch.no_grad():
                    sims[pos, side] = _np(simulate(
                        model, nn, beta, rows(sub, pos), g.dense_t,
                        solver="rk4", substeps=4).ys[..., 0])
    return {"lower": np.asarray(ci.lower), "upper": np.asarray(ci.upper),
            "beta": b_sel, "sims": sims}


def _ci_curves(ci: dict) -> dict:
    """``model_fit_panels``' ``ci_simulations`` from :func:`ci_bound_sims`."""
    return {pos: tuple(None if np.isnan(s).all() else s
                       for s in ci["sims"][pos])
            for pos in range(len(ci["beta"]))}


# ---------------------------------------------------------------- sections
def section_data(g: Gallery) -> dict:
    """The cohort overview, the clamp insulin where ``g.data_dir`` holds
    the raw CSV files, and the ages' Mann-Whitney p-values
    (``exp_figures.py:133-162``)."""
    csv_dir = Path(g.data_dir or ".") / "ohashi_csv"
    clamp = None
    if (csv_dir / "ohashi_clamp_blood.csv").exists():
        clamp = load_clamp_insulin(csv_dir)
    else:
        note("skip", "illustration_clamp_insulin.png",
             "[Errno 2] No such file or directory: "
             f"'{csv_dir / 'ohashi_clamp_blood.csv'}' (no --data-dir with "
             "the reference's raw CSV files)")
    b = g.both
    pvals = {}
    for x, y in (("NGT", "IGT"), ("NGT", "T2DM"), ("IGT", "T2DM")):
        xa, xb = b.ages[b.types == x], b.ages[b.types == y]
        if xa.size and xb.size:
            pvals[(x, y)] = mann_whitney_u(xa, xb)
    return {"timepoints": b.timepoints, "glucose": b.glucose,
            "cpeptide": b.cpeptide, "types": b.types, "ages": b.ages,
            "pvalues": pvals, "clamp_insulin": clamp}


def draw_data(a: dict):
    yield "data_overview.png", lambda: figures.data_overview(
        a["timepoints"], a["glucose"], a["cpeptide"], a["types"])
    if a["clamp_insulin"] is not None:
        yield "illustration_clamp_insulin.png", \
            lambda: figures.clamp_insulin_illustration(*a["clamp_insulin"])
    yield "supp_age.png", lambda: figures.age_distributions(
        a["ages"], a["types"], a["pvalues"])


def _best_index(g: Gallery, objectives: np.ndarray, n_cand: int) -> int:
    """The selected candidate: ``cude_fit``'s metadata, else exp02's
    metrics, else the least training objective (``exp_figures.py
    :172-193``)."""
    best = None
    try:
        best = load_checkpoint(g.art / "cude_fit.npz")[1].get(
            "best_model_index")
    except Exception:
        pass
    if best is None:
        try:
            best = json.loads((g.results / "exp02_metrics.json").read_text()
                              )["best_model_index"]
        except Exception:
            best = int(np.argmin(objectives))
    return min(int(best), n_cand - 1)


def production_curves(model: CPeptideModel, nn: torch.Tensor, beta_grid,
                      dg_grid) -> np.ndarray:
    """The network's production over ``dg_grid`` at each β of
    ``beta_grid``: ``[B, G]``."""
    dev = nn.device
    with torch.no_grad():
        return _np(model.production(nn, _t(beta_grid, dev)[:, None])(
            _t(dg_grid, dev)))


def section_cude(g: Gallery) -> dict | None:
    """``exp_figures.py:164-423``."""
    path = g.art / "cude_neural_parameters.npz"
    if not path.exists():
        note("skip", "cude section", f"{path} missing")
        return None
    tr, te, dev, it = g.train, g.test, g.dev, g.sizes.re_iters
    model = cude_model()
    z = np.load(path)
    candidates, betas_cand = z["nn_params"], z["betas"]
    best = _best_index(g, z["objectives"], candidates.shape[0])
    nn_best = params_from_jax(candidates[best], model.net, dev)
    lb, ub = widened_bounds(betas_cand[best])
    out = {"best": best, "bounds": (lb, ub)}

    fit_path = g.art / "cude_fit.npz"
    b_train = b_test = zf = None
    if fit_path.exists():
        zf = np.load(fit_path)
        b_train, s_train = zf["beta_train"], zf["sigma_train"]
        b_test, s_test = zf["beta_test"], zf["sigma_test"]
    refit = (b_train is None or len(b_train) != len(tr.ages)
             or len(b_test) != len(te.ages))
    if refit:
        def reestimate(c):
            b, s, _ = fit_betas_sigma(model, nn_best, c, initial_beta=-1.0,
                                      bounds=(lb, ub), lbfgs_iters=it)
            return _np(b), _np(s)

        (b_train, s_train), (b_test, s_test) = (
            reestimate(g.cohort_train), reestimate(g.cohort_test))
    out.update(b_train=b_train, s_train=s_train, b_test=b_test,
               s_test=s_test, refit=refit)
    g.cude = (model, nn_best, b_train)

    out["sims_train"] = g.dense(model, nn_best, b_train, g.cohort_train)
    out["sims_test"] = g.dense(model, nn_best, b_test, g.cohort_test)
    out["err_train"] = g.mse(model, nn_best, b_train, g.cohort_train,
                             tr.cpeptide)
    out["err_test"] = g.mse(model, nn_best, b_test, g.cohort_test,
                            te.cpeptide)
    out["idx_med_train"] = median_index_per_type(tr.types, out["err_train"])
    out["idx_med_test"] = median_index_per_type(te.types, out["err_test"])
    out["ci"] = ci_bound_sims(g, model, nn_best, b_test, s_test,
                              g.cohort_test, out["idx_med_test"])

    both = g.both
    b_all = np.concatenate([b_train, b_test])
    out.update(b_all=b_all, types_all=both.types)
    out["correlations"] = {
        name: (vals, spearman(np.exp(b_all), vals)) for name, vals in (
            ("first_phase", both.first_phase), ("age", both.ages),
            ("insulin_sensitivity", both.insulin_sensitivity),
            ("second_phase", both.second_phase),
            ("disposition_index", both.disposition_indices))}

    # the dose-response sweep over β's quantiles
    out["beta_grid"] = np.quantile(b_train, np.linspace(0.05, 0.95, 20))
    out["dg_grid"] = np.linspace(0.0, np.ptp(tr.glucose, axis=1).max(),
                                 100).astype(np.float32)
    out["nn_curves"] = production_curves(model, nn_best, out["beta_grid"],
                                         out["dg_grid"])

    # the likelihood curves: exp02's Δβ census over all subjects when it
    # fits the cohorts, else a test-profile scan here
    n_all = len(both.ages)
    if zf is not None and "delta_values" in zf.files \
            and zf["delta_values"].shape[0] == n_all:
        p_grid, p_values = zf["delta_grid"], zf["delta_values"]
    elif zf is not None and not refit and "profile_values" in zf.files:
        p_grid, p_values = zf["profile_grid"], zf["profile_values"]
    else:
        prof = cohort_beta_profiles(model, nn_best, g.cohort_test,
                                    sigmas=s_test, lower=lb - 1.0,
                                    upper=ub + 1.0,
                                    steps=g.sizes.prof_steps)
        p_grid, p_values = _np(prof.grid), _np(prof.values)
    out.update(p_grid=p_grid, p_values=p_values,
               lk_types=both.types if p_values.shape[0] == n_all
               else te.types)

    # every candidate's training β's against the fit split's first phase
    idx_fit = np.asarray(z["idx_fit"])
    bc = betas_cand[..., 0] if betas_cand.ndim == 3 else betas_cand
    if bc.shape[-1] == len(idx_fit) and idx_fit.max() < len(tr.ages):
        out["candidate_betas"] = (bc, tr.first_phase[idx_fit])
    else:
        note("skip", "other_betas.png", "candidate β count != fit-split size")

    # the runner-up network's refit of every subject (figure_s8)
    if candidates.shape[0] > 1:
        order = np.argsort(np.asarray(z["objectives"]))
        second = int(order[1]) if int(order[0]) == best else int(order[0])
        nn_second = params_from_jax(candidates[second], model.net, dev)
        lb2, ub2 = widened_bounds(betas_cand[second])
        b2 = [_np(fit_betas(model, nn_second, c, initial_beta=-1.0,
                            bounds=(lb2, ub2), lbfgs_iters=it)[0])
              for c in (g.cohort_train, g.cohort_test)]
        b2_all = np.concatenate(b2)
        out.update(second=second, b2_all=b2_all,
                   rho2=spearman(b2_all, b_all))
    else:
        note("skip", "second_best_correlation.png",
             "single-candidate artifact")

    # the cUDE against the UDE on each type's mean test curve
    ude_p = g.art / "ude_neural_parameters.npz"
    if ude_p.exists():
        names = [t for t in TYPES if (te.types == t).any()]
        sel = [te.types == t for t in names]
        mean_c = np.stack([te.cpeptide[s].mean(axis=0) for s in sel])
        mean_cohort = build_cohort(
            np.stack([te.glucose[s].mean(axis=0) for s in sel]),
            te.timepoints, mean_c,
            np.array([te.ages[s].mean() for s in sel]),
            np.array([t == "T2DM" for t in names]), dev)
        b_mean = _np(fit_betas(model, nn_best, mean_cohort,
                               initial_beta=-1.0, bounds=(lb, ub),
                               lbfgs_iters=it)[0])
        ude = ude_model()
        nn_ude = params_from_jax(np.load(ude_p)["nn_params"][0], ude.net,
                                 dev)
        out["comparison"] = {
            "type_names": names, "mean_c": mean_c,
            "ste_c": np.stack([te.cpeptide[s].std(axis=0) / np.sqrt(s.sum())
                               for s in sel]),
            "b_mean": b_mean,
            "sims_cude": g.dense(model, nn_best, b_mean, mean_cohort),
            "sims_ude": g.dense(ude, nn_ude, None, mean_cohort)}
    else:
        note("skip", "comparison.png", "ude artifact missing")
    out.update(timepoints=tr.timepoints, dense_t=g.dense_t,
               types_train=tr.types, types_test=te.types,
               c_train=tr.cpeptide, c_test=te.cpeptide)
    return out


def draw_cude(a: dict):
    tp, dt = a["timepoints"], a["dense_t"]
    yield "model_fit_train_median.png", lambda: figures.model_fit_panels(
        tp, a["c_train"], a["sims_train"], a["types_train"],
        indices=a["idx_med_train"], dense_t=dt)
    yield "model_fit_test_median.png", lambda: figures.model_fit_panels(
        tp, a["c_test"], a["sims_test"], a["types_test"],
        indices=a["idx_med_test"], dense_t=dt,
        ci_simulations=_ci_curves(a["ci"]))
    yield "model_fit_test_all.png", lambda: figures.fit_grid(
        tp, a["c_test"], dt, a["sims_test"], a["types_test"])
    yield "model_fit_error.png", lambda: figures.error_violins(
        a["err_test"], a["types_test"], ylabel="test MSE")
    eb, types = np.exp(a["b_all"]), a["types_all"]
    yield "beta_distribution.png", lambda: figures.beta_distribution(
        a["b_all"], types)
    vals, rho = a["correlations"]["first_phase"]
    yield "correlation.png", lambda: figures.correlation_scatter(
        eb, vals, types, xlabel="exp(β)", ylabel="First-phase clamp",
        rho=rho)
    for name in ("age", "insulin_sensitivity", "second_phase",
                 "disposition_index"):
        vals, rho = a["correlations"][name]
        yield f"correlation_sup_{name}.png", \
            lambda vals=vals, rho=rho, name=name: figures.correlation_scatter(
                eb, vals, types, xlabel="exp(β)",
                ylabel=name.replace("_", " "), rho=rho)
    yield "dose_response.png", lambda: figures.dose_response(
        a["dg_grid"], a["nn_curves"], a["beta_grid"])
    yield "likelihood_curves.png", lambda: figures.likelihood_curves(
        a["p_grid"], a["p_values"], THRESHOLDS["cantelli95"],
        types=a["lk_types"])
    if "candidate_betas" in a:
        yield "other_betas.png", lambda: figures.candidate_beta_grid(
            *a["candidate_betas"])
    if "b2_all" in a:
        e2 = np.exp(a["b2_all"])
        yield "second_best_correlation.png", lambda: figures.scatter_compare(
            e2, eb, "exp(β) model 2", "exp(β) model 1", identity=False)
        yield "second_best_correlation_comparison.png", \
            lambda: figures.correlation_scatter(
                e2, eb, types, xlabel="exp(β) model 2",
                ylabel="exp(β) model 1", rho=a["rho2"])
    if "comparison" in a:
        c = a["comparison"]
        yield "comparison.png", lambda: figures.comparison_panels(
            dt, c["sims_cude"], c["sims_ude"], tp, c["mean_c"], c["ste_c"],
            c["type_names"])


def section_covariate(g: Gallery) -> dict | None:
    """``exp_figures.py:425-508``: the covariate model's median fits, their
    Raue-95 CI-bound trajectories (K4c) and correlations."""
    fit_p = g.art / "cude_covariate_fit.npz"
    art_p = g.art / "cude_covariate_neural_parameters.npz"
    if not (fit_p.exists() and art_p.exists()):
        note("skip", "covariate section", f"{fit_p} missing (rerun exp07)")
        return None
    tr, te = g.train, g.test
    zc, meta = load_checkpoint(fit_p)
    b_train, b_test = zc["beta_train"], zc["beta_test"]
    if len(b_train) != len(tr.ages) or len(b_test) != len(te.ages):
        note("skip", "covariate section",
             "fit sizes do not match the cohorts")
        return None
    model = cude_model(3)
    cand = np.load(art_p)["nn_params"]
    best = min(int(meta.get("best_model_index", 0)), cand.shape[0] - 1)
    nn = params_from_jax(cand[best], model.net, g.dev)
    b_all = np.concatenate([b_train, b_test])
    both = g.both
    err = np.asarray(zc["sse_test"]) / len(te.timepoints)
    idx = median_index_per_type(te.types, err)
    s_test = zc["sigma_test"] if "sigma_test" in zc else np.ones_like(b_test)
    return {
        "best": best, "b_all": b_all, "types_all": both.types,
        "first_phase": (both.first_phase,
                        spearman(np.exp(b_all), both.first_phase)),
        "others": [("age", both.ages),
                   ("insulin sensitivity", both.insulin_sensitivity),
                   ("disposition index", both.disposition_indices)],
        "sims_test": g.dense(model, nn, b_test, g.cohort_test),
        "err_test": err, "idx_med_test": idx,
        "ci": ci_bound_sims(g, model, nn, b_test, s_test, g.cohort_test, idx,
                            method="raue95"),
        "timepoints": te.timepoints, "dense_t": g.dense_t,
        "c_test": te.cpeptide, "types_test": te.types}


def draw_covariate(a: dict):
    eb, types = np.exp(a["b_all"]), a["types_all"]
    fp, rho = a["first_phase"]
    yield "covariate_correlation.png", lambda: figures.correlation_scatter(
        eb, fp, types, xlabel="exp(β) (covariate)",
        ylabel="First-phase clamp", rho=rho)
    panels = dict(indices=a["idx_med_test"], dense_t=a["dense_t"])
    yield "model_fit_test_covariate_median.png", \
        lambda: figures.model_fit_panels(a["timepoints"], a["c_test"],
                                         a["sims_test"], a["types_test"],
                                         **panels)
    yield "supplementary_covariate.png", lambda: figures.model_fit_panels(
        a["timepoints"], a["c_test"], a["sims_test"], a["types_test"],
        ci_simulations=_ci_curves(a["ci"]), **panels)
    yield "correlations_other_cude.png", lambda: figures.correlation_panels(
        eb, a["others"], types, xlabel="exp(β) (covariate)")


def section_ude(g: Gallery) -> dict | None:
    """``exp_figures.py:510-531``: the UDE on every test subject."""
    path = g.art / "ude_neural_parameters.npz"
    if not path.exists():
        note("skip", "ude section", f"{path} missing")
        return None
    model = ude_model()
    nn = params_from_jax(np.load(path)["nn_params"][0], model.net, g.dev)
    te = g.test
    return {"sims": g.dense(model, nn, None, g.cohort_test),
            "ngt": np.flatnonzero(te.types == "NGT"),
            "timepoints": te.timepoints, "dense_t": g.dense_t,
            "c_test": te.cpeptide, "types_test": te.types}


def draw_ude(a: dict):
    tp, dt, c, s, types = (a["timepoints"], a["dense_t"], a["c_test"],
                           a["sims"], a["types_test"])
    yield "model_fit_ude_test.png", lambda: figures.fit_grid(tp, c, dt, s,
                                                             types)
    ngt = a["ngt"]
    if ngt.size:
        yield "model_fit_ude_test_ngt.png", lambda: figures.fit_grid(
            tp, c[ngt], dt, s[ngt], types[ngt], ncols=min(6, ngt.size))


def section_symbolic(g: Gallery) -> dict:
    """``exp_figures.py:533-636``: the symbolic and discovered equations
    against the network, the symbolic fits of every subject, and the GP
    search's Pareto front."""
    both, dev = g.both, g.dev
    out = {}
    if g.cude is not None:
        model, nn, b_train = g.cude
        beta_grid = np.quantile(b_train, [0.1, 0.5, 0.9])
        dg = np.linspace(0.0, np.ptp(g.train.glucose, axis=1).max(),
                         100).astype(np.float32)
        eb = torch.exp(_t(beta_grid, dev))[:, None]
        with torch.no_grad():
            out.update(
                beta_grid=beta_grid, dg_grid=dg,
                nn_curves=production_curves(model, nn, beta_grid, dg),
                sym_curves=_np(symbolic_production(_t(dg, dev),
                                                   beta_to_k(eb))),
                disc_curves=_np(discovered_production(_t(dg, dev), eb)))
    n = len(both.ages)
    sym_fit = g.art / "symreg_fit.npz"
    zs = np.load(sym_fit) if sym_fit.exists() else None
    if zs is not None and zs["ks"].shape[0] == n:
        ks = zs["ks"]
    else:
        ks = _np(fit_k_sigma(g.cohort_all, lbfgs_iters=g.sizes.re_iters)[0])
    sym = symbolic_model()
    sims = g.dense(sym, None, ks, g.cohort_all)
    err = np.mean((g.dense(sym, None, ks, g.cohort_all, both.timepoints)
                   - both.cpeptide) ** 2, axis=1)
    out.update(ks=ks, sims=sims, err=err,
               idx_med=median_index_per_type(both.types, err),
               k_rho=spearman(ks, both.first_phase),
               first_phase=both.first_phase, types_all=both.types,
               timepoints=both.timepoints, dense_t=g.dense_t,
               c_all=both.cpeptide)
    front = g.results / "symbolic_regression_result.csv"
    if front.exists():
        r = _read_csv(front)
        out["pareto"] = ([int(x["complexity"]) for x in r],
                         [float(x["loss"]) for x in r])
    else:
        note("skip", "symbolic_regression_pareto.png", f"{front} missing")
    disc = g.art / "discovered_fit.npz"
    if not disc.exists():
        note("skip", "discovered_correlation.png", f"{disc} missing")
    elif np.load(disc)["bs"].shape[0] != n:
        note("skip", "discovered_correlation.png",
             f"artifact has {np.load(disc)['bs'].shape[0]} subjects, "
             f"cohort has {n} (stale/smoke artifact)")
    else:
        bs = np.load(disc)["bs"]
        out["discovered"] = (bs, spearman(bs, both.first_phase))
    return out


def draw_symbolic(a: dict):
    if "nn_curves" in a:
        yield "dose_response_neural_symbolic.png", \
            lambda: figures.dose_response_compare(
                a["dg_grid"], a["nn_curves"], a["sym_curves"], a["beta_grid"])
    yield "symbolic_regression_internal.png", lambda: figures.model_fit_panels(
        a["timepoints"], a["c_all"], a["sims"], a["types_all"],
        indices=a["idx_med"], dense_t=a["dense_t"])
    yield "symbolic_correlation.png", lambda: figures.correlation_scatter(
        a["ks"], a["first_phase"], a["types_all"], xlabel="k",
        ylabel="First-phase clamp", rho=a["k_rho"])
    if "pareto" in a:
        yield "symbolic_regression_pareto.png", \
            lambda: figures.pareto_front(*a["pareto"])
    if "nn_curves" in a:
        yield "dose_response_neural_discovered.png", \
            lambda: figures.dose_response_compare(
                a["dg_grid"], a["nn_curves"], a["disc_curves"],
                a["beta_grid"])
    if "discovered" in a:
        bs, rho = a["discovered"]
        yield "discovered_correlation.png", \
            lambda: figures.correlation_scatter(
                bs, a["first_phase"], a["types_all"], xlabel="b (discovered)",
                ylabel="First-phase clamp", rho=rho)


def section_external(g: Gallery) -> dict:
    """``exp_figures.py:638-672``: the symbolic model on the Fujita cohort."""
    f = load_fujita_npz(g.art / "fujita.npz")
    cohort = build_cohort(f.glucose, f.timepoints, f.cpeptide, f.ages,
                          f.t2dm, g.dev)
    ext = g.art / "symreg_external_fit.npz"
    ze = np.load(ext) if ext.exists() else None
    if ze is not None and ze["ks"].shape[0] == len(f.ages):
        ks = ze["ks"]
    else:
        ks = _np(fit_k_sigma(cohort, lbfgs_iters=g.sizes.re_iters)[0])
    dense = dense_grid(f.timepoints)
    return {"ks": ks, "dense_t": dense, "timepoints": f.timepoints,
            "cpeptide": f.cpeptide,
            "sims": g.dense(symbolic_model(), None, ks, cohort, dense)}


def draw_external(a: dict):
    yield "model_fit_external.png", lambda: figures.quantile_fit_band(
        a["dense_t"], a["sims"], a["timepoints"], a["cpeptide"],
        title="Fujita external cohort")


def section_ablation(g: Gallery) -> dict | None:
    """``exp_figures.py:674-693``: exp05's across-seed median and IQR."""
    path = g.results / "exp05_ablation.csv"
    if not path.exists():
        note("skip", "performance_less_data.png", f"{path} missing")
        return None
    by_frac = {}
    for r in _read_csv(path):
        by_frac.setdefault(float(r["fraction"]), []).append(
            float(r["test_sse_median"]))
    fracs = sorted(by_frac)
    return {"fractions": fracs,
            "median": [float(np.median(by_frac[f])) for f in fracs],
            "lo": [float(np.percentile(by_frac[f], 25)) for f in fracs],
            "hi": [float(np.percentile(by_frac[f], 75)) for f in fracs]}


def draw_ablation(a: dict):
    yield "performance_less_data.png", lambda: figures.ablation_curve(
        a["fractions"], a["median"], band=(a["lo"], a["hi"]))


def section_suppression(g: Gallery) -> dict | None:
    """``exp_figures.py:695-761``: θ̂ against the true p4 at λ = 0.1, the
    fitted UDE on its regenerated training data, and the selection rules'
    robustness."""
    path = g.art / "suppression_lambda=0.1.npz"
    if not path.exists():
        note("skip", "suppression section", f"{path} missing")
        return None
    z, meta = load_checkpoint(path)
    best = int(np.argmin(z["objectives"]))
    thetas, gt = np.asarray(z["thetas"][best]), np.asarray(z["gt_train"])
    tp = SUPPRESSION_TIMEPOINTS
    data, gt_regen = sup.generate_data(
        GROUP_MEANS, SUPPRESSION_SIZES.train, tp,
        noise_multiplicative=float(meta.get("noise", 0.1)),
        rng=np.random.default_rng(DATA_SEED), device=g.dev)
    out = {"gt": gt, "thetas": thetas, "restart": best}
    if gt.shape == gt_regen.shape and np.allclose(gt, gt_regen):
        dense = np.linspace(0.0, 30.0, 61).astype(np.float32)
        net = sup.suppression_net(depth=5, width=3)
        with torch.no_grad():
            ys = sup.simulate_population(
                net, _t(z["nn_params"][best], g.dev)[None],
                _t(thetas, g.dev)[None], _t(data[:, :, 0], g.dev)[None],
                dense).ys[0]
        out.update(timepoints=tp, dense_t=dense, data=data, ys=_np(ys),
                   idx=np.argsort(gt)[[0, len(gt) // 2, len(gt) - 1]])
    else:
        note("skip", "suppression_model_fit.png",
             "artifact ground truth does not match regenerated data")
    sens = g.results / "suppression_selection_sensitivity.csv"
    if sens.exists():
        r = _read_csv(sens)
        lams = sorted({float(x["lambda"]) for x in r})
        by_rule = {}
        for rule in ("valid_loss", "valid_rho", "combined_rank"):
            rho = {float(x["lambda"]): float(x["test_rho"]) for x in r
                   if x["rule"] == rule}
            by_rule[rule] = [rho.get(lam, float("nan")) for lam in lams]
        out["sensitivity"] = (lams, by_rule)
    else:
        note("skip", "suppression_selection_sensitivity.png",
             f"{sens} missing")
    return out


def _suppression_fit(a: dict):
    fig = figures.model_fit_panels(
        a["timepoints"], a["data"][:, 2, :], a["ys"][:, :, 2],
        np.asarray(["NGT"] * len(a["gt"])), indices=a["idx"],
        dense_t=a["dense_t"])
    for ax in fig.axes:
        ax.set_ylabel("state u₃")
    return fig


def draw_suppression(a: dict):
    yield "suppression_correlation.png", lambda: figures.scatter_compare(
        a["gt"], a["thetas"], "ground-truth p₄", "fitted θ", identity=False)
    if "ys" in a:
        yield "suppression_model_fit.png", lambda: _suppression_fit(a)
    if "sensitivity" in a:
        yield "suppression_selection_sensitivity.png", \
            lambda: figures.selection_sensitivity(*a["sensitivity"])


def section_saem(g: Gallery) -> dict | None:
    """``exp_figures.py:763-845``: SAEM's MAPs against its MLEs, its
    traces, and the posterior-predictive band of each type's median-MAP
    subject from its committed chain."""
    path = g.art / "saem_fit.npz"
    if not path.exists():
        note("skip", "saem section", f"{path} missing (rerun exp06)")
        return None
    z = np.load(path)
    both = g.both
    n = len(both.ages)
    out = {"beta_mle": z["beta_mle"], "beta_map": z["beta_map"],
           "types_all": both.types if z["beta_map"].shape[0] == n else None}
    if z["beta_map"].shape[0] == n:
        out["correlation"] = (both.first_phase, spearman(
            np.exp(z["beta_map"]), both.first_phase))
    for key in ("nll_trace", "acceptance_trace"):
        if key in z:
            out[key] = z[key]
    if "beta_chains" in z and z["beta_chains"].shape[0] == n:
        model = cude_model()
        nn = params_from_jax(z["nn_params"], model.net, g.dev)
        chains, maps = z["beta_chains"], z["beta_map"]
        bands = {}
        for t in TYPES:
            sel = np.flatnonzero(both.types == t)
            if not sel.size:
                continue
            i = int(sel[np.argsort(maps[sel])[len(sel) // 2]])
            with torch.no_grad():
                sols = _np(simulate(model, nn, np.asarray(chains[i],
                                                          np.float32),
                                    rows(g.cohort_all, i), g.dense_t,
                                    solver="rk4", substeps=4).ys[..., 0])
            bands[t] = {"subject": i,
                        "p05": np.quantile(sols, 0.05, axis=0),
                        "p95": np.quantile(sols, 0.95, axis=0),
                        "median": np.median(sols, axis=0),
                        "observed": both.cpeptide[i]}
        out.update(bands=bands, dense_t=g.dense_t,
                   timepoints=both.timepoints)
    return out


def draw_saem(a: dict):
    yield "saem_map_vs_mle.png", lambda: figures.scatter_compare(
        a["beta_mle"], a["beta_map"], "MLE β", "MAP β", types=a["types_all"])
    if "correlation" in a:
        fp, rho = a["correlation"]
        yield "saem_correlation.png", lambda: figures.correlation_scatter(
            np.exp(a["beta_map"]), fp, a["types_all"],
            xlabel="exp(β) (SAEM MAP)", ylabel="First-phase clamp", rho=rho)
    if "nll_trace" in a:
        yield "saem_nll_trace.png", lambda: figures.loss_trace(
            a["nll_trace"], ylabel="population NLL")
    if "acceptance_trace" in a:
        def acceptance():
            fig = figures.loss_trace(a["acceptance_trace"],
                                     ylabel="MCMC acceptance")
            fig.axes[0].set_yscale("linear")
            return fig

        yield "saem_acceptance_trace.png", acceptance
    if "bands" in a:
        b = a["bands"]
        yield "saem_posterior_predictive.png", lambda: figures.band_panels(
            a["dense_t"], b, a["timepoints"],
            {t: v["observed"] for t, v in b.items()})


def section_replication(g: Gallery) -> dict | None:
    """``exp_figures.py:847-890``: exp02_seeds' spread, gauge-aligned."""
    path = g.results / "exp02_seeds.csv"
    if not path.exists():
        note("skip", "replication section",
             f"{path} missing (run exp02_seeds)")
        return None
    r = _read_csv(path)
    sgn = [-1.0 if float(x["spearman_first_phase"]) > 0 else 1.0 for x in r]

    def aligned(key):
        return [s * float(x[key]) for s, x in zip(sgn, r)]

    canon_rho = canon = None
    try:
        m = json.loads((g.results / "exp02_metrics.json").read_text())
        canon_rho = {"β vs first-phase ρ": m["spearman"]["first_phase"],
                     "β vs age ρ": m["spearman"]["age"],
                     "β vs ISI ρ": m["spearman"]["insulin_sensitivity"]}
        canon = {"test SSE (mean)": m["test_sse_mean"]}
    except Exception:
        pass
    return {"spearman": {"β vs first-phase ρ": aligned("spearman_first_phase"),
                         "β vs age ρ": aligned("spearman_age"),
                         "β vs ISI ρ": aligned("spearman_isi")},
            "canonical_spearman": canon_rho,
            "sse": {"test SSE (mean)": [float(x["test_sse_mean"]) for x in r],
                    "test SSE (median)": [float(x["test_sse_median"])
                                          for x in r]},
            "canonical_sse": canon}


def draw_replication(a: dict):
    yield "replication_spearman.png", lambda: figures.replication_strip(
        a["spearman"], canonical=a["canonical_spearman"],
        xlabel="Spearman ρ (gauge-aligned)", xlim=(-1, 1), refline=0.0)
    yield "replication_sse.png", lambda: figures.replication_strip(
        a["sse"], canonical=a["canonical_sse"], xlabel="held-out error")


STEPS = {"data": (section_data, draw_data),
         "cude": (section_cude, draw_cude),
         "covariate": (section_covariate, draw_covariate),
         "ude": (section_ude, draw_ude),
         "symbolic": (section_symbolic, draw_symbolic),
         "external": (section_external, draw_external),
         "ablation": (section_ablation, draw_ablation),
         "suppression": (section_suppression, draw_suppression),
         "saem": (section_saem, draw_saem),
         "replication": (section_replication, draw_replication)}


@dataclasses.dataclass
class GalleryRun:
    arrays: dict[str, dict]       # each section run: its figures' arrays
    rendered: list[str]           # the figures drawn in this run
    seconds: dict[str, float]     # wall-clock of each section
    manifest: dict | None         # what was written to out (merged)


def run_exp_figures(device: torch.device | str, artifacts_dir: str | Path,
                    out: str | Path | None = None, sections=None,
                    smoke: bool = False,
                    results_dir: str | Path = RESULTS,
                    data_dir: str | Path | None = None) -> GalleryRun:
    """The gallery on ``device``: each section of ``sections`` (all by
    default) in ``SECTIONS``' order computed from ``artifacts_dir`` and
    ``results_dir``; with ``out``, the figures drawn into ``out/figures``
    (when matplotlib is there) and ``out/exp_figures_manifest.json``
    merged with the figures an earlier run left there.  ``smoke`` takes
    the JAX script's smoke sizes (``SMOKE``); ``data_dir``, the raw CSV
    files' folder, gives the clamp insulin's figure."""
    unknown = set(sections or ()) - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}; choose from "
                         f"{SECTIONS}")
    g = Gallery(device, Path(artifacts_dir), Path(results_dir),
                SMOKE if smoke else FULL,
                None if data_dir is None else Path(data_dir))
    stage = _Stages(g.dev)
    draw = out is not None and figures.available()
    outdir = None if out is None else Path(out) / "figures"
    arrays, rendered = {}, []
    for name in SECTIONS:
        if sections is not None and name not in sections:
            continue
        compute, drawer = STEPS[name]
        with stage(name):
            a = compute(g)
        if a is None:
            continue
        arrays[name] = a
        for fig_name, build in drawer(a):
            if draw:
                figures.save(build(), outdir / fig_name)
                rendered.append(fig_name)
                note("figure", fig_name)
            else:
                note("skip", fig_name, NO_MATPLOTLIB if out is not None
                     else "no --out to draw into")
    if outdir is not None and "cude" in arrays:
        # exp02 draws this one into its own --out (02-conditional.jl:592-658)
        if (outdir / "sampled_simulations.png").exists():
            rendered.append("sampled_simulations.png")
        else:
            note("skip", "sampled_simulations.png",
                 "drawn by exp02 with --out; run it first")
    manifest = None if out is None else write_manifest(Path(out), rendered)
    return GalleryRun(arrays=arrays, rendered=rendered,
                      seconds=stage.seconds, manifest=manifest)


def write_manifest(out: Path, rendered: list[str]) -> dict:
    """``out/exp_figures_manifest.json``: this run's figures and those of
    an earlier manifest there whose files still exist
    (``exp_figures.py:892-906``)."""
    path = out / MANIFEST
    names = set(rendered)
    try:
        prev = json.loads(path.read_text())["rendered"]
        names |= {f for f in prev if (out / "figures" / f).exists()}
    except (OSError, ValueError, KeyError):
        pass
    manifest = {"rendered": sorted(names), "count": len(names)}
    out.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(manifest, indent=2))
    return manifest
