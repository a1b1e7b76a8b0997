"""Publication-figure functions (counterpart of
``conditional_ude_tpu/utils/figures.py``): the reference's palette and the
figure vocabulary of its experiment scripts, in matplotlib.

Every figure function takes numpy arrays and returns a figure; ``save``
writes it.  matplotlib is imported by ``_plt()`` when one runs, never when this
module is imported, so the package imports without it (the card's machine
has none); ``available()`` says whether it can be imported.  The gallery
(``figures_pipeline.py``) computes every figure's arrays whether or not it
can draw them.
"""

from __future__ import annotations

import itertools
from pathlib import Path

import numpy as np

# reference palette (src/figures.jl:4-13; 02-conditional.jl COLORS)
COLORS = {
    "NGT": (1 / 255, 101 / 255, 157 / 255),
    "IGT": (201 / 255, 78 / 255, 0 / 255),
    "T2DM": (1 / 255, 120 / 255, 80 / 255),
}
MARKERS = {"NGT": "o", "IGT": "^", "T2DM": "s"}
TYPES = ("NGT", "IGT", "T2DM")


def _plt():
    """``matplotlib.pyplot`` on the Agg backend (raises ImportError when
    matplotlib is not installed)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def available() -> bool:
    """Whether matplotlib can be imported here."""
    try:
        _plt()
    except ImportError:
        return False
    return True


def save(fig, path: str | Path, dpi: int = 300) -> None:
    """Write ``fig`` to ``path`` (its folder made) and close it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    _plt().close(fig)


def error_violins(errors: np.ndarray, types: np.ndarray, ylabel="MSE"):
    """Per-type error distributions (``01-non-conditional.jl`` fig 1)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(4, 3))
    present = [t for t in TYPES if (types == t).any()]
    data = [errors[types == t] for t in present]
    parts = ax.violinplot(data, showmedians=True)
    for body, t in zip(parts["bodies"], present):
        body.set_facecolor(COLORS[t])
        body.set_alpha(0.7)
    ax.set_xticks(range(1, len(present) + 1), present)
    ax.set_ylabel(ylabel)
    return fig


def model_fit_panels(timepoints, observations, simulations, types,
                     indices=None, dense_t=None, ci_simulations=None):
    """Observed points + simulated curves for selected individuals
    (``02-conditional.jl`` figs 2-3).  ``simulations[N, T]`` on
    ``dense_t`` (defaults to ``timepoints``).

    ``ci_simulations`` — optional ``{position: (lower_curve|None,
    upper_curve|None)}`` keyed by panel position: the profile-CI-bound
    trajectories the reference draws dotted around the median fit
    (``02-conditional.jl:186-208``); a ``None`` curve marks an open
    (unidentifiable) CI side."""
    plt = _plt()
    idx = np.arange(len(types)) if indices is None else np.asarray(indices)
    n = len(idx)
    fig, axes = plt.subplots(1, n, figsize=(2.2 * n, 2.4), sharey=True)
    if n == 1:
        axes = [axes]
    t_sim = timepoints if dense_t is None else dense_t
    for pos, (ax, i) in enumerate(zip(axes, idx)):
        t = types[i]
        if ci_simulations is not None and pos in ci_simulations:
            for bound in ci_simulations[pos]:
                if bound is not None:
                    ax.plot(t_sim, bound, color=COLORS.get(t, "k"),
                            lw=0.9, ls=":", alpha=0.6)
        ax.plot(t_sim, simulations[i], color=COLORS.get(t, "k"), lw=1.5)
        ax.scatter(timepoints, observations[i], s=14,
                   color=COLORS.get(t, "k"), marker=MARKERS.get(t, "o"))
        ax.set_title(str(t), fontsize=9)
        ax.set_xlabel("time (min)")
    axes[0].set_ylabel("C-peptide (nmol/L)")
    return fig


def correlation_scatter(betas, index_values, types, xlabel="β",
                        ylabel="clamp index", rho: float | None = None):
    """β vs clamp-index scatter with per-type colors/markers
    (``02-conditional.jl`` fig 4)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(3.2, 3))
    for t in TYPES:
        sel = types == t
        if sel.any():
            ax.scatter(np.asarray(betas)[sel], np.asarray(index_values)[sel],
                       s=16, color=COLORS[t], marker=MARKERS[t], label=t)
    if rho is not None:
        ax.set_title(f"ρ = {rho:.2f}", fontsize=9)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=7)
    return fig


def loss_trace(traces: np.ndarray, labels=None, ylabel="loss"):
    """Optimization / SAEM diagnostic traces."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(4, 2.6))
    traces = np.atleast_2d(np.asarray(traces))
    for i, tr in enumerate(traces):
        ax.plot(tr, lw=1,
                label=None if labels is None else labels[i])
    ax.set_xlabel("iteration")
    ax.set_ylabel(ylabel)
    ax.set_yscale("log")
    if labels is not None:
        ax.legend(fontsize=7)
    return fig


def data_overview(timepoints, glucose, cpeptide, types):
    """Per-type mean ± sd of the raw glucose and c-peptide curves
    (``02-conditional.jl`` eccb ``data``/``glucose`` figures)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(7, 2.8))
    for ax, (arr, label) in zip(axes, [(np.asarray(glucose), "Glucose (mmol/L)"),
                                       (np.asarray(cpeptide),
                                        "C-peptide (nmol/L)")]):
        for t in TYPES:
            sel = np.asarray(types) == t
            if not sel.any():
                continue
            m, s = arr[sel].mean(axis=0), arr[sel].std(axis=0)
            ax.errorbar(timepoints, m, yerr=s, color=COLORS[t],
                        marker=MARKERS[t], ms=3, lw=1.2, capsize=2, label=t)
        ax.set_xlabel("time (min)")
        ax.set_ylabel(label)
    axes[0].legend(fontsize=7)
    return fig


def clamp_insulin_illustration(timepoints, insulin, types):
    """Mean ± SEM clamp insulin curves for NGT vs T2DM with the 1st/2nd
    phase cut at 10 min (``00-prepare-data.jl:145-165``)."""
    plt = _plt()
    insulin = np.asarray(insulin)
    fig, ax = plt.subplots(figsize=(3.6, 3.2))
    for t in ("NGT", "T2DM"):
        sel = np.asarray(types) == t
        if not sel.any():
            continue
        m = insulin[sel].mean(axis=0)
        sem = insulin[sel].std(axis=0) / np.sqrt(sel.sum())
        ax.fill_between(timepoints, np.full_like(m, m[0]), m,
                        color=COLORS[t], alpha=0.3)
        ax.errorbar(timepoints, m, yerr=sem, color=COLORS[t],
                    marker=MARKERS[t], ms=4, lw=1.5, capsize=2, label=t)
    ax.axvline(10, color="k", ls="--", lw=0.8)
    ylim = ax.get_ylim()
    ax.text(2, 0.9 * ylim[1], "1st phase", fontsize=7)
    ax.text(45, 0.9 * ylim[1], "2nd phase", fontsize=7)
    ax.set_xlabel("time (min)")
    ax.set_ylabel("Insulin (mU/L)")
    ax.legend(fontsize=7, loc="center right")
    return fig


def fit_grid(timepoints, observations, dense_t, simulations, types,
             ncols: int = 7, titles=None):
    """All-subjects grid of fits (``model_fit_test_all``,
    ``02-conditional.jl`` supplementary)."""
    plt = _plt()
    n = len(types)
    nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(1.7 * ncols, 1.6 * nrows),
                             sharex=True, sharey=True, squeeze=False)
    for i in range(nrows * ncols):
        ax = axes[i // ncols, i % ncols]
        if i >= n:
            ax.axis("off")
            continue
        t = types[i]
        ax.plot(dense_t, simulations[i], color=COLORS.get(t, "k"), lw=1.2)
        ax.scatter(timepoints, observations[i], s=8,
                   color=COLORS.get(t, "k"), marker=MARKERS.get(t, "o"))
        ax.set_title(str(t) if titles is None else str(titles[i]), fontsize=7)
    return fig


def quantile_fit_band(dense_t, simulations, timepoints, observations,
                      color="tab:blue", title=None):
    """Population quantile band: 5-95% band + median of ``simulations[N,T]``
    over the observed quantiles (``04-symreg-external.jl`` quantile fits)."""
    plt = _plt()
    sims = np.asarray(simulations)
    obs = np.asarray(observations)
    fig, ax = plt.subplots(figsize=(3.6, 2.8))
    ax.fill_between(dense_t, np.quantile(sims, 0.05, axis=0),
                    np.quantile(sims, 0.95, axis=0), color=color, alpha=0.25)
    ax.plot(dense_t, np.median(sims, axis=0), color=color, lw=1.5)
    ax.errorbar(timepoints, np.median(obs, axis=0),
                yerr=np.vstack([np.median(obs, 0) - np.quantile(obs, 0.05, 0),
                                np.quantile(obs, 0.95, 0) - np.median(obs, 0)]),
                fmt="ko", ms=3, lw=0.8, capsize=2)
    ax.set_xlabel("time (min)")
    ax.set_ylabel("C-peptide (nmol/L)")
    if title:
        ax.set_title(title, fontsize=9)
    return fig


def dose_response(dg_grid, curves, beta_values, cmap="viridis",
                  ylabel="production"):
    """NN production vs ΔG for a sweep of β (``figure_1/dose_response``).

    ``curves[K, G]`` over ``dg_grid[G]``, one line per ``beta_values[K]``,
    colored by β."""
    plt = _plt()
    import matplotlib.cm as cm
    from matplotlib.colors import Normalize

    curves = np.asarray(curves)
    bv = np.asarray(beta_values)
    norm = Normalize(bv.min(), bv.max() if bv.max() > bv.min()
                     else bv.min() + 1)
    mapper = cm.ScalarMappable(norm=norm, cmap=cmap)
    fig, ax = plt.subplots(figsize=(3.4, 2.8))
    for b, c in zip(bv, curves):
        ax.plot(dg_grid, c, color=mapper.to_rgba(b), lw=1)
    fig.colorbar(mapper, ax=ax, label="β")
    ax.set_xlabel("ΔG (mmol/L)")
    ax.set_ylabel(ylabel)
    return fig


def dose_response_compare(dg_grid, nn_curves, sym_curves, beta_values):
    """NN vs symbolic-equation production overlays
    (``supplementary/dose_response_neural_symbolic``)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(3.6, 2.8))
    nn_curves, sym_curves = np.asarray(nn_curves), np.asarray(sym_curves)
    for i, b in enumerate(np.asarray(beta_values)):
        ax.plot(dg_grid, nn_curves[i], color="k", lw=1,
                label="neural" if i == 0 else None)
        ax.plot(dg_grid, sym_curves[i], color=COLORS["IGT"], lw=1, ls="--",
                label="symbolic" if i == 0 else None)
    ax.set_xlabel("ΔG (mmol/L)")
    ax.set_ylabel("production")
    ax.legend(fontsize=7)
    return fig


def beta_distribution(betas, types, xlabel="β"):
    """Per-type histogram of the fitted conditional parameters
    (``supplementary/beta_distribution``)."""
    plt = _plt()
    betas = np.asarray(betas)
    fig, ax = plt.subplots(figsize=(3.6, 2.6))
    bins = np.histogram_bin_edges(betas, bins=20)
    for t in TYPES:
        sel = np.asarray(types) == t
        if sel.any():
            ax.hist(betas[sel], bins=bins, color=COLORS[t], alpha=0.55,
                    label=t)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("count")
    ax.legend(fontsize=7)
    return fig


def likelihood_curves(grid, profiles, threshold: float, types=None,
                      max_panels: int = 16):
    """Small-multiple likelihood profiles with the CI threshold line
    (``supplementary/likelihood_curves``).

    ``profiles[N, S]`` NLL values over ``grid[S]``; each panel draws the
    profile minus its minimum and the Δ-threshold."""
    plt = _plt()
    profiles = np.asarray(profiles)
    n = min(len(profiles), max_panels)
    ncols = int(np.ceil(np.sqrt(n)))
    nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(1.9 * ncols, 1.7 * nrows),
                             sharex=True)
    axes = np.atleast_1d(np.asarray(axes)).ravel()
    for i in range(len(axes)):
        ax = axes[i]
        if i >= n:
            ax.axis("off")
            continue
        t = None if types is None else types[i]
        prof = profiles[i] - profiles[i].min()
        ax.plot(grid, prof, color=COLORS.get(t, "k"), lw=1)
        ax.axhline(threshold, color="gray", ls="--", lw=0.8)
        ax.set_ylim(0, 4 * threshold)
        if t is not None:
            ax.set_title(str(t), fontsize=7)
    return fig


def candidate_beta_grid(betas_candidates, index_values, ncols: int = 5):
    """Per-candidate β-vs-clamp scatter grid with correlation-sign shading
    (``supplementary/other_betas``, ``02-conditional.jl:427-441``)."""
    from .stats import spearman

    plt = _plt()
    bc = np.asarray(betas_candidates)
    iv = np.asarray(index_values)
    n = bc.shape[0]
    nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(1.9 * ncols, 1.8 * nrows),
                             sharex=False, sharey=True)
    axes = np.atleast_1d(np.asarray(axes)).ravel()
    for i in range(len(axes)):
        ax = axes[i]
        if i >= n:
            ax.axis("off")
            continue
        rho = spearman(np.exp(bc[i]), iv)
        shade = COLORS["T2DM"] if rho > 0 else COLORS["IGT"]
        ax.set_facecolor((*shade, 0.1))
        ax.scatter(np.exp(bc[i]), iv, s=6, color="k", alpha=0.9)
        ax.set_title(f"Model {i + 1} (ρ={rho:.2f})", fontsize=6)
    return fig


def ablation_curve(fractions, sse_values, ylabel="test SSE (median)",
                   band=None):
    """Performance vs training-data fraction
    (``supplementary/performance-less-data``).

    ``band``: optional ``(lo, hi)`` arrays (e.g. across-seed IQR) drawn as
    a shaded envelope around the central curve."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(3.6, 2.6))
    if band is not None:
        lo, hi = band
        ax.fill_between(np.asarray(fractions, float),
                        np.asarray(lo, float), np.asarray(hi, float),
                        color=COLORS["NGT"], alpha=0.2, lw=0,
                        label="IQR across seeds")
        ax.legend(frameon=False, fontsize=6)
    ax.plot(fractions, sse_values, "o-", color=COLORS["NGT"], ms=4)
    ax.set_xlabel("fraction of training data")
    ax.set_ylabel(ylabel)
    return fig


def selection_sensitivity(lambdas, rho_by_rule: dict):
    """Suppression restart-selection robustness: test-stage Spearman ρ vs
    λ per selection rule (``exp_suppression --selection-sensitivity``).
    NaN entries (degenerate λ) break the lines naturally."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(4.2, 2.8))
    # cycle, not zip-truncate: a fourth selection rule must still be drawn
    palette = itertools.cycle(
        [COLORS["NGT"], COLORS["IGT"], COLORS["T2DM"]])
    for (rule, rho), c in zip(rho_by_rule.items(), palette):
        ax.plot(np.asarray(lambdas, float), np.asarray(rho, float), "o-",
                color=c, ms=4, label=rule)
    ax.axhline(0.0, color="0.7", lw=0.8, zorder=0)
    ax.set_xscale("symlog", linthresh=1e-2)
    ax.set_xlabel("λ (L2 regularization)")
    ax.set_ylabel("test-stage Spearman ρ")
    ax.legend(frameon=False, fontsize=7)
    return fig


def pareto_front(complexities, losses, chosen: int | None = None):
    """Symbolic-regression Pareto front (complexity vs loss), mirroring the
    reference's PySR result table
    (``symbolic-regression/results/symbolic_regression_result.csv``)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(3.4, 2.6))
    ax.plot(complexities, losses, "o-", color="k", ms=4)
    if chosen is not None:
        i = list(complexities).index(chosen)
        ax.plot([chosen], [losses[i]], "o", color=COLORS["IGT"], ms=8,
                mfc="none", mew=2)
    ax.set_xlabel("equation complexity")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    return fig


def comparison_panels(dense_t, sims_cude, sims_ude, timepoints,
                      mean_obs, ste_obs, type_names):
    """Side-by-side cUDE-vs-UDE fits of the per-type test means
    (``02-conditional.jl:716-795``): left panel conditional, right panel
    non-conditional, one curve + errorbar series per type."""
    plt = _plt()
    fig, (ax_c, ax_u) = plt.subplots(1, 2, figsize=(6.4, 2.8), sharey=True)
    for i, t in enumerate(type_names):
        for ax, sims in ((ax_c, sims_cude), (ax_u, sims_ude)):
            ax.plot(dense_t, sims[i], color=COLORS.get(t, "k"), lw=1.6,
                    label=t)
            ax.errorbar(timepoints, mean_obs[i], yerr=ste_obs[i], fmt="none",
                        ecolor=COLORS.get(t, "k"), elinewidth=0.8,
                        capsize=2)
            ax.scatter(timepoints, mean_obs[i], s=18,
                       color=COLORS.get(t, "k"), marker=MARKERS.get(t, "o"))
    ax_c.set_title("cUDE", fontsize=10)
    ax_u.set_title("UDE", fontsize=10)
    for ax in (ax_c, ax_u):
        ax.set_xlabel("time (min)")
    ax_c.set_ylabel("C-peptide (nmol/L)")
    ax_u.legend(fontsize=7)
    return fig


def age_distributions(ages, types, pvalues: dict | None = None):
    """Per-type age distributions with pairwise Mann-Whitney p-values
    (the reference's supplementary age figure; tests from
    ``00-prepare-data.jl:34-36``)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(4, 3))
    present = [t for t in TYPES if (types == t).any()]
    data = [np.asarray(ages)[types == t] for t in present]
    parts = ax.violinplot(data, showmedians=True)
    for body, t in zip(parts["bodies"], present):
        body.set_facecolor(COLORS[t])
        body.set_alpha(0.7)
    ax.set_xticks(range(1, len(present) + 1), present)
    ax.set_ylabel("age (years)")
    if pvalues:
        txt = "\n".join(f"{a} vs {b}: p={p:.3f}"
                        for (a, b), p in pvalues.items())
        ax.text(0.02, 0.98, txt, transform=ax.transAxes, fontsize=7,
                va="top")
    return fig


def scatter_compare(x, y, xlabel, ylabel, types=None, identity=True):
    """Generic estimator-comparison scatter (SAEM MAP vs MLE,
    ``06-saem.jl`` figures)."""
    plt = _plt()
    x, y = np.asarray(x), np.asarray(y)
    fig, ax = plt.subplots(figsize=(3, 3))
    if types is None:
        ax.scatter(x, y, s=14, color="k", alpha=0.8)
    else:
        for t in TYPES:
            sel = np.asarray(types) == t
            if sel.any():
                ax.scatter(x[sel], y[sel], s=14, color=COLORS[t],
                           marker=MARKERS[t], label=t)
        ax.legend(fontsize=7)
    if identity:
        lo = min(x.min(), y.min())
        hi = max(x.max(), y.max())
        ax.plot([lo, hi], [lo, hi], color="gray", lw=0.8, ls="--")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return fig


def replication_strip(metric_rows, canonical=None, xlabel="value",
                      xlim=None, refline=None):
    """Across-seed replication dot strip (beyond-parity figure; no
    reference counterpart — single-seed Julia runs cannot afford one).

    ``metric_rows``: ordered ``{row label: per-seed values}``;
    ``canonical``: optional ``{row label: single-run value}`` drawn as an
    open black diamond.  Seed dots share one hue (seeds are exchangeable
    replicates, not identities); mean ± sd is direct-labeled per row.
    """
    plt = _plt()
    rows = list(metric_rows)
    fig, ax = plt.subplots(figsize=(4.6, 0.75 + 0.55 * len(rows)))
    if refline is not None:
        ax.axvline(refline, color="0.8", lw=0.8, zorder=0)
    for i, name in enumerate(rows):
        vals = np.asarray(metric_rows[name], float)
        y = len(rows) - 1 - i
        ax.scatter(vals, np.full(vals.shape, y, float), s=22,
                   color=COLORS["NGT"], alpha=0.85, zorder=3,
                   label="seeds" if i == 0 else None)
        if canonical and name in canonical:
            ax.scatter([canonical[name]], [y], s=46, marker="D",
                       facecolors="none", edgecolors="k", lw=1.2, zorder=4,
                       label="canonical seed" if i == 0 else None)
        ax.annotate(f"{vals.mean():.3f} ± {vals.std(ddof=1):.3f}",
                    (0.99, y + 0.22), xycoords=("axes fraction", "data"),
                    ha="right", fontsize=7, color="0.35")
    ax.set_yticks(range(len(rows)))
    ax.set_yticklabels(rows[::-1], fontsize=8)
    ax.set_ylim(-0.6, len(rows) - 0.25)
    if xlim is not None:
        ax.set_xlim(*xlim)
    ax.set_xlabel(xlabel, fontsize=8)
    ax.legend(fontsize=7, loc="lower left", frameon=False)
    return fig


def correlation_panels(x, panels, types, xlabel="exp(β)"):
    """One β-vs-index scatter a panel, ``panels`` ``[(name, values)]``,
    each titled with its Spearman ρ (``correlations_other_cude``,
    ``07-covariate-inclusion.jl:378-451``)."""
    from .stats import spearman

    plt = _plt()
    x = np.asarray(x)
    fig, axes = plt.subplots(1, len(panels), figsize=(2.8 * len(panels), 2.8))
    axes = np.atleast_1d(axes)
    for ax, (name, vals) in zip(axes, panels):
        vals = np.asarray(vals)
        for t in TYPES:
            sel = np.asarray(types) == t
            if sel.any():
                ax.scatter(x[sel], vals[sel], s=14, color=COLORS[t],
                           marker=MARKERS[t], label=t)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(name)
        ax.set_title(f"ρ = {spearman(x, vals):.2f}", fontsize=9)
    axes[0].legend(fontsize=7)
    fig.tight_layout()
    return fig


def band_panels(dense_t, bands, timepoints, observations,
                ylabel="C-peptide (nmol/L)", obs_err=None, center="median",
                figsize=(7.5, 2.6)):
    """One panel a type: a 5-95 % band, its centre line and the observed
    points (``saem_posterior_predictive``, exp02's
    ``sampled_simulations``).

    ``bands``: ``{type: {"p05", "p95", center: [T]}}`` over ``dense_t``;
    ``observations``: ``{type: [T_obs]}``, with ``obs_err`` ``{type:
    [T_obs]}`` drawn as error bars when given."""
    plt = _plt()
    fig, axes = plt.subplots(1, len(TYPES), figsize=figsize, sharey=True)
    for ax, t in zip(axes, TYPES):
        if t not in bands:
            ax.axis("off")
            continue
        b = bands[t]
        ax.fill_between(dense_t, b["p05"], b["p95"], color=COLORS[t],
                        alpha=0.3)
        ax.plot(dense_t, b[center], color=COLORS[t], lw=1.4)
        if obs_err is None:
            ax.scatter(timepoints, observations[t], s=14, color="k",
                       zorder=3)
        else:
            ax.errorbar(timepoints, observations[t], yerr=obs_err[t],
                        fmt="ko", ms=3, lw=0.8)
        ax.set_title(t, fontsize=9)
        ax.set_xlabel("time (min)")
    axes[0].set_ylabel(ylabel)
    return fig


def quantile_ci_panels(dense_t, panels, timepoints, ylabel="C-peptide (nM)"):
    """One panel a quantile subject: its fit, the trajectories at its
    profile CI's bounds (dotted; None where the CI is open) and its
    observations (``04-symreg-external.jl``'s external-validation figure).

    ``panels``: ``[(title, fit[T], lower[T] | None, upper[T] | None,
    observations[T_obs])]``."""
    plt = _plt()
    fig, axes = plt.subplots(1, len(panels), figsize=(2.8 * len(panels), 2.8),
                             sharey=True)
    axes = np.atleast_1d(axes)
    for ax, (title, mid, lo, hi, obs) in zip(axes, panels):
        for bound in (lo, hi):
            if bound is not None:
                ax.plot(dense_t, bound, color=COLORS["NGT"], lw=1.0, ls=":",
                        alpha=0.6)
        ax.plot(dense_t, mid, color=COLORS["NGT"], lw=1.8)
        ax.scatter(timepoints, obs, s=12, color="k", zorder=3)
        ax.set_title(title, fontsize=9)
        ax.set_xlabel("time (min)")
    axes[0].set_ylabel(ylabel)
    return fig
