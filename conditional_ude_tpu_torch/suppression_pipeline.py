"""The suppression-model experiment end to end (counterpart of
``experiments/exp_suppression.py``): the simulated recovery example.

1. Three synthetic populations from the known 3-state ODE, numpy-seeded
   27052023 and drawn in the JAX script's order: 37 training subjects, 30
   noisy and 30 noise-free validation subjects (group means p4 ∈ {0.5, 2.5,
   5, 7.5, 10, 12.5}), then the 10,000 candidate θ vectors of the
   validation refits.
2. The λ sweep (λ ∈ {0, 1e-3, 1e-2, 0.1, 1}, or the 13-point fine grid):
   one batch of (λ × restart) rows (``fit_suppression_sweep``), so a run
   at several λ's gives each λ the numbers of a run at that λ alone; the
   designs come from a CPU ``torch.Generator`` seeded ``seed``.
3. The frozen-network θ refits of every restart on both validation sets,
   every (λ, set, restart) a row of one L-BFGS, and each restart's
   Spearman of θ̂ with the true p4.
4. The test stage at λ = 0.01: the restart of least validation loss and
   the one of greatest validation ρ, each refitted per subject (θ, σ) on 60
   fresh subjects from a 1,000-point θ grid, and the test Spearman of each.
   ``selection_sensitivity`` runs it instead for the three selection rules
   at every λ of the committed fine grid (``results/suppression_sweep_fine
   .csv`` and the artifacts, read only), all fits rows of one L-BFGS.

No kernel serves this model: every solve is eager PyTorch.  Outputs go
only into ``out``, in the JAX script's formats and file names.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from conditional_ude_tpu_torch.models.suppression import (
    SuppressionFitConfig,
    fit_suppression_sweep,
    generate_data,
    suppression_net,
    validate_suppression,
    validate_suppression_sigma_batch,
)
from conditional_ude_tpu_torch.pipeline import SEED, _Stages
from conditional_ude_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from conditional_ude_tpu_torch.utils.stats import spearman

DATA_SEED = 27052023
TIMEPOINTS = np.linspace(0.0, 30.0, 8)
GROUP_MEANS = (0.5, 2.5, 5.0, 7.5, 10.0, 12.5)
LAMBDAS = (0.0, 0.001, 0.01, 0.1, 1.0)
RULES = ("valid_loss", "valid_rho", "combined_rank")
SENSITIVITY_NOTE = (
    "best-validation-loss selection (suppression/figures.jl:27-41) is "
    "gauge-blind: at mid-lambda it picks theta-inverted restarts (test rho "
    "~ -0.8); rho-aware rules are robust across lambda")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Population sizes, candidate counts and the fit's depth.  The
    validation refits and the test stage take ``fit.lbfgs_iters`` L-BFGS
    steps, as in the JAX script."""

    train: tuple[int, ...] = (15, 3, 3, 3, 3, 10)
    valid: tuple[int, ...] = (5, 5, 5, 5, 5, 5)
    n_test: int = 60
    valid_inits: int = 10_000
    test_inits: int = 1000
    test_lambda: float = 0.01
    lambdas: tuple[float, ...] = LAMBDAS
    fit: SuppressionFitConfig = SuppressionFitConfig()


FULL = Sizes()
# --smoke (experiments/exp_suppression.py:131-157,247,274,281)
SMOKE = Sizes(train=(3, 1, 1, 1, 1, 2), valid=(2, 2, 2, 2, 2, 2), n_test=12,
              valid_inits=50, test_inits=64, test_lambda=0.1,
              lambdas=(0.0, 0.1),
              fit=SuppressionFitConfig(initial_space=50, select_best_n=3,
                                       adam_iters=30, lbfgs_iters=30))


def fine_lambdas() -> list[float]:
    """The reference's init_run grid and the test_run extremes: 13 points,
    10^[-1.8:0.2:-0.6] rounded to 12 digits (so 10^-1 is the main sweep's
    0.1) with {0, 0.01, 1, 10, 100, 1000}."""
    return sorted({0.0, 0.01, 1.0, 10.0, 100.0, 1000.0}
                  | {round(float(10.0 ** e), 12)
                     for e in np.linspace(-1.8, -0.6, 7)})


@dataclasses.dataclass
class SuppressionRun:
    metrics: dict                   # the JAX script's keys and stage_seconds
    rows: list[dict]                # one a (λ, restart), the CSV's columns
    fits: dict                      # λ → the npz's arrays
    sensitivity: list[dict]         # the selection-sensitivity rows
    seconds: dict
    # --test-only: each stored restart's loss_valid and correlation_valid
    revalidated: list[dict] = dataclasses.field(default_factory=list)


def write_csv(path: Path, rows: list[dict]) -> None:
    """``rows`` under their first row's keys (nothing for no rows)."""
    if not rows:
        return
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def read_csv(path: Path) -> list[dict]:
    """The rows of a sweep or sensitivity CSV, ``restart`` an int, ``rule``
    a string, the rest floats."""
    def value(k, v):
        return int(v) if k == "restart" else v if k == "rule" else float(v)

    with path.open() as f:
        return [{k: value(k, v) for k, v in r.items()}
                for r in csv.DictReader(f)]


def write_metrics(path: Path, metrics: dict) -> None:
    path.write_text(json.dumps(metrics, indent=2, default=float))


def _tag(lambdas, fine: bool, subset) -> str:
    return ("_fine" if fine else "" if subset is None
            else "_" + "_".join(str(lam) for lam in lambdas))


def _sweep_rows(net, sweep, lambdas, data, cfg, dev, stage):
    """Validate every restart of every λ on both validation sets (rows of
    one L-BFGS) and make the per-restart rows."""
    n_lam, r, p = sweep.nn_params.shape
    nn = sweep.nn_params.reshape(n_lam * r, p)
    valid = torch.as_tensor(data["valid"], device=dev)
    nonoise = torch.as_tensor(data["nonoise"], device=dev)
    sets = torch.cat([valid.expand(n_lam * r, *valid.shape),
                      nonoise.expand(n_lam * r, *nonoise.shape)])
    with stage("validate"):
        theta, obj = validate_suppression(
            net, torch.cat([nn, nn]), sets, TIMEPOINTS,
            data["theta_inits_valid"], lbfgs_iters=cfg.lbfgs_iters)
    theta, obj = theta.cpu().numpy(), obj.cpu().numpy()
    thetas_train = sweep.thetas.cpu().numpy()
    objectives = sweep.objectives.cpu().numpy()
    rows = []
    for li, lam in enumerate(lambdas):
        for k in range(r):
            v, nv = li * r + k, n_lam * r + li * r + k
            rows.append({
                "lambda": lam, "restart": k,
                "correlation_train": spearman(data["gt_train"],
                                              thetas_train[li, k]),
                "loss_train": float(objectives[li, k]),
                "correlation_valid": spearman(data["gt_valid"], theta[v]),
                "loss_valid": float(obj[v]),
                "correlation_valid_nonoise": spearman(data["gt_nonoise"],
                                                      theta[nv]),
                "loss_valid_nonoise": float(obj[nv]),
            })
            print(rows[-1], file=sys.stderr)
    return rows


def _test_rhos(net, nn: np.ndarray, data_test, gt_test, theta_grid,
               lbfgs_iters: int, dev) -> list[float]:
    """Test Spearman of each network of ``nn[K, P]``: every (network,
    subject) pair a row of one (θ, σ) L-BFGS."""
    xs, _ = validate_suppression_sigma_batch(
        net, torch.as_tensor(nn, dtype=torch.float32, device=dev),
        data_test, TIMEPOINTS, theta_grid, lbfgs_iters)
    xs = xs.cpu().numpy()
    return [spearman(gt_test, xs[k, :, 0]) for k in range(xs.shape[0])]


def _sensitivity(net, artifacts_dir: Path, fine_rows: list[dict],
                 data_test, gt_test, theta_grid, lbfgs_iters, dev):
    """The selection-rule × λ map: each rule's restart at every λ, and the
    test Spearman of each distinct (λ, restart), fitted together."""
    lams = sorted({r["lambda"] for r in fine_rows})
    picks = []
    for lam in lams:
        lrows = sorted((r for r in fine_rows if r["lambda"] == lam),
                       key=lambda r: r["restart"])
        loss_v = np.asarray([r["loss_valid"] for r in lrows])
        rho_v = np.asarray([r["correlation_valid"] for r in lrows])
        rank_sum = (np.argsort(np.argsort(loss_v))
                    + np.argsort(np.argsort(-rho_v)))
        for rule, sel in zip(RULES, (int(np.argmin(loss_v)),
                                     int(np.argmax(rho_v)),
                                     int(np.argmin(rank_sum)))):
            picks.append((lam, rule, sel, float(loss_v[sel]),
                          float(rho_v[sel])))
    distinct = sorted({(lam, sel) for lam, _, sel, _, _ in picks})
    nn = np.stack([load_checkpoint(
        artifacts_dir / f"suppression_lambda={lam}.npz")[0]["nn_params"][sel]
        for lam, sel in distinct])
    rho = dict(zip(distinct, _test_rhos(net, nn, data_test, gt_test,
                                        theta_grid, lbfgs_iters, dev)))
    rows = []
    for lam, rule, sel, loss, rho_valid in picks:
        rows.append({"lambda": lam, "rule": rule, "restart": sel,
                     "valid_loss": loss, "valid_rho": rho_valid,
                     "test_rho": float(rho[(lam, sel)])})
        print(rows[-1], file=sys.stderr)
    return lams, rows


def sensitivity_block(lams: list[float], rows: list[dict]) -> dict:
    """The ``selection_sensitivity`` metrics of the JAX script: each rule's
    test ρ summarised NaN-robustly (a NaN ρ is a degenerate λ, whose flat
    network makes every θ fit equal)."""
    by_rule = {rule: np.asarray([r["test_rho"] for r in rows
                                 if r["rule"] == rule]) for rule in RULES}
    return {
        "lambdas": lams,
        "rules": {rule: {
            "test_rho_mean": float(np.nanmean(v)),
            "test_rho_min": float(np.nanmin(v)),
            "test_rho_max": float(np.nanmax(v)),
            "test_abs_rho_mean": float(np.nanmean(np.abs(v))),
            "n_gauge_inverted": int(np.nansum(v < 0)),
            "n_degenerate_lambda": int(np.isnan(v).sum()),
            "best_lambda": float(lams[int(np.nanargmax(v))])}
            for rule, v in by_rule.items()},
        "note": SENSITIVITY_NOTE,
        "rows": rows,
    }


def run_exp_suppression(device: torch.device | str,
                        artifacts_dir: str | Path, out: Path | None = None,
                        sizes: Sizes = FULL, noise: float = 0.1,
                        lambdas=None, fine: bool = False,
                        no_test_stage: bool = False, test_only: bool = False,
                        selection_sensitivity: bool = False,
                        seed: int = SEED) -> SuppressionRun:
    """exp_suppression on ``device``, its outputs written into ``out`` (if
    given).  ``lambdas`` replaces the sweep's λ's (``fine`` takes the fine
    grid); ``test_only`` skips the sweep and revalidates the artifact of
    the test λ in ``artifacts_dir``; ``selection_sensitivity`` skips it and
    maps the selection rules over the committed fine grid, read from
    ``results/`` beside ``artifacts_dir``."""
    dev = torch.device(device)
    artifacts_dir = Path(artifacts_dir)
    results_dir = artifacts_dir.parent / "results"
    cfg = sizes.fit
    net = suppression_net(depth=5, width=3)
    stage = _Stages(dev)
    rng = np.random.default_rng(DATA_SEED)
    data = {}
    with stage("data"):
        for name, group, nz in (("train", sizes.train, noise),
                                ("valid", sizes.valid, noise),
                                ("nonoise", sizes.valid, 0.0)):
            data[name], data[f"gt_{name}"] = generate_data(
                GROUP_MEANS, group, TIMEPOINTS, noise_multiplicative=nz,
                rng=rng, device=dev)
        data["theta_inits_valid"] = rng.uniform(
            size=(sizes.valid_inits, data["valid"].shape[0])
        ).astype(np.float32)

    lams = list(fine_lambdas() if fine else sizes.lambdas)
    if lambdas is not None:
        lams = list(lambdas)
    summary: dict = {}
    if test_only or selection_sensitivity:
        lams = []
        if out is not None and (out / "exp_suppression_metrics.json").exists():
            summary = json.loads(
                (out / "exp_suppression_metrics.json").read_text())
    rows, fits = [], {}
    if lams:
        with stage("train"):
            sweep = fit_suppression_sweep(
                net, data["train"], TIMEPOINTS, lams, cfg, device=dev,
                generator=torch.Generator().manual_seed(seed))
        rows = _sweep_rows(net, sweep, lams, data, cfg, dev, stage)
        for li, lam in enumerate(lams):
            fits[lam] = {"nn_params": sweep.nn_params[li].cpu().numpy(),
                         "thetas": sweep.thetas[li].cpu().numpy(),
                         "objectives": sweep.objectives[li].cpu().numpy(),
                         "gt_train": data["gt_train"]}
            lam_rows = [r for r in rows if r["lambda"] == lam]
            summary[str(lam)] = {
                "best_correlation_train": max(r["correlation_train"]
                                              for r in lam_rows),
                "best_correlation_valid": max(r["correlation_valid"]
                                              for r in lam_rows)}
            if out is not None:
                save_checkpoint(out / f"suppression_lambda={lam}.npz",
                                fits[lam], metadata={"lambda": lam,
                                                     "noise": noise})
    tag = _tag(lams, fine, lambdas)
    run = SuppressionRun(summary, rows, fits, [], stage.seconds)
    if out is not None:
        write_csv(out / f"suppression_sweep{tag}.csv", rows)
    if no_test_stage:
        summary["stage_seconds"] = dict(stage.seconds)
        if out is not None:
            write_metrics(out / f"exp_suppression_metrics{tag}.json",
                          summary)
        return run

    test_lambda = sizes.test_lambda
    if lams and test_lambda not in lams:
        test_lambda = lams[-1]
    if lams:
        nn_test = fits[test_lambda]["nn_params"]
    else:
        nn_test = load_checkpoint(
            artifacts_dir / f"suppression_lambda={test_lambda}.npz"
        )[0]["nn_params"]
    lam_rows = [r for r in rows if r["lambda"] == test_lambda]
    if not lam_rows and not selection_sensitivity:
        # --test-only: the selection's quantities from a revalidation of
        # the stored restarts
        with stage("validate"):
            theta_v, obj_v = validate_suppression(
                net, torch.as_tensor(nn_test, device=dev), data["valid"],
                TIMEPOINTS, data["theta_inits_valid"],
                lbfgs_iters=cfg.lbfgs_iters)
        theta_v, obj_v = theta_v.cpu().numpy(), obj_v.cpu().numpy()
        lam_rows = [{"loss_valid": float(obj_v[k]),
                     "correlation_valid": spearman(data["gt_valid"],
                                                   theta_v[k])}
                    for k in range(len(obj_v))]
        run.revalidated = lam_rows

    per_group = max(1, sizes.n_test // len(GROUP_MEANS))
    data_test, gt_test = generate_data(
        GROUP_MEANS, [per_group] * len(GROUP_MEANS), TIMEPOINTS,
        noise_multiplicative=noise, rng=rng, device=dev)
    theta_grid = rng.uniform(size=sizes.test_inits).astype(np.float32)

    if selection_sensitivity:
        with stage("sensitivity"):
            lams_fine, run.sensitivity = _sensitivity(
                net, artifacts_dir,
                read_csv(results_dir / "suppression_sweep_fine.csv"),
                data_test, gt_test, theta_grid, cfg.lbfgs_iters, dev)
        summary["selection_sensitivity"] = sensitivity_block(
            lams_fine, run.sensitivity)
        summary["stage_seconds"] = dict(stage.seconds)
        if out is not None:
            write_csv(out / "suppression_selection_sensitivity.csv",
                      run.sensitivity)
            write_metrics(out / "exp_suppression_metrics.json", summary)
        return run

    best_r = int(np.argmin([r["loss_valid"] for r in lam_rows]))
    best_r_rho = int(np.argmax([r["correlation_valid"] for r in lam_rows]))
    picked = sorted({best_r, best_r_rho})
    with stage("test_stage"):
        rho = dict(zip(picked, _test_rhos(net, nn_test[picked], data_test,
                                          gt_test, theta_grid,
                                          cfg.lbfgs_iters, dev)))
    print(f"test-stage θ-recovery (λ={test_lambda}): by-loss restart "
          f"{best_r} ρ={rho[best_r]:.3f}; by-valid-ρ restart {best_r_rho} "
          f"ρ={rho[best_r_rho]:.3f}", file=sys.stderr)
    summary["test_stage"] = {
        "lambda": test_lambda, "n_test": int(len(gt_test)),
        "spearman": rho[best_r],
        "selected_restart": best_r,
        "spearman_best_valid_rho_restart": rho[best_r_rho],
        "best_valid_rho_restart": best_r_rho,
    }
    summary["stage_seconds"] = dict(stage.seconds)
    if out is not None:
        write_csv(out / "suppression_sweep.csv", rows)
        write_metrics(out / "exp_suppression_metrics.json", summary)
    return run


def merge_fine_outputs(out: Path) -> dict:
    """Merge the per-λ partial outputs in ``out`` (``--lambdas <λ>
    --no-test-stage``, one run a λ) into ``suppression_sweep_fine.csv`` and
    ``exp_suppression_metrics_fine.json``, with the main metrics' test stage
    when ``out`` holds them (``experiments/exp_suppression.py:34-73``)."""
    rows, summary, missing = [], {}, []
    for lam in fine_lambdas():
        mpath = out / f"exp_suppression_metrics_{lam}.json"
        cpath = out / f"suppression_sweep_{lam}.csv"
        if not (mpath.exists() and cpath.exists()):
            missing.append(lam)
            continue
        summary[str(lam)] = json.loads(mpath.read_text())[str(lam)]
        rows += read_csv(cpath)
    if missing:
        raise SystemExit(f"--merge-fine: missing per-λ partials for "
                         f"{missing}; run `--lambdas <λ> --no-test-stage` "
                         "for each first")
    main = out / "exp_suppression_metrics.json"
    if main.exists():
        test_stage = json.loads(main.read_text()).get("test_stage")
        if test_stage is not None:
            summary["test_stage"] = test_stage
    rows.sort(key=lambda r: (r["lambda"], r["restart"]))
    write_csv(out / "suppression_sweep_fine.csv", rows)
    write_metrics(out / "exp_suppression_metrics_fine.json", summary)
    return summary
