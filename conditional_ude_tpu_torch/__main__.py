"""Run one experiment of the package and print its metrics as one JSON line.

    python -m conditional_ude_tpu_torch                 # exp02, frozen candidates, on the card
    python -m conditional_ude_tpu_torch --retrain       # train anew, then the same stages
    python -m conditional_ude_tpu_torch --covariate     # exp07: age as a third input
    python -m conditional_ude_tpu_torch --xl            # exp02_xl: 96 candidates, guarded selection
    python -m conditional_ude_tpu_torch --xl --retrain --inits 400000 --restarts 2304
    python -m conditional_ude_tpu_torch --experiment exp01 [--retrain]   # the non-conditional UDE
    python -m conditional_ude_tpu_torch --experiment exp03               # symbolic refits, Ohashi
    python -m conditional_ude_tpu_torch --experiment exp04               # symbolic refits, Fujita
    python -m conditional_ude_tpu_torch --experiment symreg_production   # the discovered equation
    python -m conditional_ude_tpu_torch --experiment exp02_seeds --out runs/seeds [--seeds 11 22 ...]
    python -m conditional_ude_tpu_torch --experiment exp02_seeds --out runs/seeds --merge
    python -m conditional_ude_tpu_torch --experiment exp05 --out runs/exp05 [--ablation-seeds 5]
    python -m conditional_ude_tpu_torch --experiment exp06 [--retrain]   # SAEM, the cUDE
    python -m conditional_ude_tpu_torch --experiment exp06a              # SAEM, the symbolic model
    python -m conditional_ude_tpu_torch --experiment exp06b              # SAEM, the discovered equation
    python -m conditional_ude_tpu_torch --experiment exp_advi [--restarts N] [--seed S]   # ADVI
    python -m conditional_ude_tpu_torch --experiment exp_suppression --out runs/sup   # the λ sweep
    python -m conditional_ude_tpu_torch --experiment exp_suppression --test-only --out runs/sup
    python -m conditional_ude_tpu_torch --experiment exp_suppression --selection-sensitivity --out runs/sup
    python -m conditional_ude_tpu_torch --experiment exp_symreg_search --search-seeds 3 --out runs/symreg
    python -m conditional_ude_tpu_torch --experiment exp_symreg_search --smoke --out runs/symreg_smoke
    python -m conditional_ude_tpu_torch --experiment exp_figures --out runs/gallery [--sections cude saem] [--smoke] [--data-dir D]
    python -m conditional_ude_tpu_torch --experiment exp00 --data-dir D --out runs/etl   # the ETL of the raw CSVs
    python -m conditional_ude_tpu_torch --experiment exp_parity --data-dir D [--weights W] [--smoke]
    python -m conditional_ude_tpu_torch --out runs/exp02   # also write the metrics and outputs there
    python -m conditional_ude_tpu_torch --device cpu    # the plain versions, on the CPU
    python -m conditional_ude_tpu_torch --experiment exp07 --smoke --out runs/ci   # any experiment at its CI sizes

``--experiment exp07``, ``exp02_xl`` and ``exp_symreg_production`` name
the JAX scripts: they are ``--covariate``, ``--xl`` and
``symreg_production``.

``--smoke`` runs an experiment at the JAX script's ``--smoke`` sizes (its CI
mode) as it runs on a clean checkout, whose ``artifacts/smoke/`` holds
nothing: the first 8 subjects of each split (exp04: 4 Fujita subjects;
exp05 the whole cohorts), tiny multi-starts and step counts, and training
wherever the JAX script would train into that empty cache (exp01, exp02,
exp07, exp02_xl, exp02_seeds, exp06's pre-train).  exp_advi takes the JAX
script's fallback for its missing candidates, two Glorot networks at β = −1;
exp02's outputs leave out the UDE comparison, whose weights are missing.
Its outputs go to ``DIR/smoke`` of ``--out DIR``.  Every experiment but
exp00 has it.

With ``--out DIR`` the run writes its metrics (``<experiment>_metrics.json``)
and its outputs into DIR: exp02's canonical fits (``cude_fit.npz``: the
(β, σ, SSE) refits, the test profile and the Δβ census) and exp07's
(``cude_covariate_fit.npz``), which the gallery reads from an artifacts
directory, exp02's dose-response table
(``ohashi_production.csv``) and band figure
(``figures/sampled_simulations.png``), exp04's CI-bound trajectories
(``figures/model_fit_external_quantiles.png``; the figures only where
matplotlib is installed), exp01's retrained networks
(``ude_neural_parameters.npz``), the symbolic fits (``symreg_fit.npz``,
``symreg_external_fit.npz``, ``discovered_fit.npz``), exp02_seeds' records
(``exp02_seed_<s>.json``) and candidates
(``seeds/cude_neural_parameters_<s>.npz``), exp05's rows
(``exp05_ablation.csv``), and exp06's fit (``saem_fit.npz``), dose-response
grid (``neural_simulations.csv``) and, with ``--retrain``, pre-train
(``saem_pretrain.npz``), and exp_advi's posteriors
(``advi_cude_results.npz``, ``advi_test_posteriors.npz``), and
exp_suppression's sweep (``suppression_sweep*.csv``, one
``suppression_lambda=<λ>.npz`` a λ, ``suppression_selection_sensitivity
.csv``), and exp_symreg_search's fronts (``symbolic_regression_result
.csv``, one ``symbolic_regression_result_seed<s>.csv`` a search seed when
there are several), in the JAX package's formats.  exp_figures, the
gallery, needs ``--out``: it computes every section's arrays from
``--artifacts`` and the committed ``results/``, draws ``figures/*.png``
into DIR where matplotlib is installed (else it notes each figure it
skips), and writes ``exp_figures_manifest.json`` there, merged with the
figures an earlier run left; its JSON line is that manifest.  It never writes
into the artifacts directory or ``results/``, which hold the JAX package's
reference.  exp02_seeds and exp05 always train; exp02_seeds prints one
JSON line a seed.  exp06, exp06a and exp06b write their metrics with the
JAX keys only and print their stage seconds on the standard error;
exp_advi's, exp_suppression's and exp_symreg_search's metrics carry their
``stage_seconds`` (exp_symreg_search: each GP run's) in place of the JAX
scripts' timers.

``--data-dir D`` is the reference repository's raw-data folder (``D
/ohashi_csv``, ``D/fujita_csv``, and beside it ``D/../source_data``).
exp00, the ETL, needs it and ``--out``: it writes ``ohashi.npz``,
``fujita.npz`` and ``exp00_metrics.json`` there.  exp_parity needs it: it
refits (β, σ) on its cohorts at the reference's trained network
(``--weights``, by default ``D/../source_data/cude_neural_parameters
.jld2``; reading it needs h5py) and checks RK4 against Tsit5.  With it,
exp_advi runs its cross-check against ``D/../source_data/advi`` (JLD2,
h5py) where that folder exists, and exp_figures draws the clamp insulin
from ``D/ohashi_csv``.

Last, on the standard error, the kernels the run launched:
``{"launches": {module: count}}``.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import sys
from pathlib import Path

import torch

from conditional_ude_tpu_torch import (
    ablation,
    advi_pipeline,
    etl_pipeline,
    figures_pipeline,
    parity_pipeline,
    saem_pipeline,
    seeds,
    suppression_pipeline,
    symreg_pipeline,
)
from conditional_ude_tpu_torch.fit.train import TrainConfig
from conditional_ude_tpu_torch.ops import (
    lane_grad,
    population_grad,
    rk4_cohort,
    rk4_population,
    tsit5_cohort,
)
from conditional_ude_tpu_torch.pipeline import (
    SEED,
    SMOKE_STAGES,
    SMOKE_TRAIN,
    SMOKE_UDE,
    SMOKE_XL_INITS,
    draw_sampled_bands,
    fit_export,
    run_frozen_pipeline,
    run_training_pipeline,
    run_ude_pipeline,
    script_metrics,
)
from conditional_ude_tpu_torch.symbolic_pipeline import (
    SMOKE_SIZES,
    SMOKE_SUBJECTS as SMOKE_SYMBOLIC,
    draw_external_quantiles,
    run_exp03,
    run_exp04,
    run_symreg_production,
)
from conditional_ude_tpu_torch.utils import figures
from conditional_ude_tpu_torch.utils.checkpoint import save_checkpoint

REPO = Path(__file__).resolve().parent.parent
ARTIFACTS = REPO / "artifacts"
SYMBOLIC = {"exp03": run_exp03, "exp04": run_exp04,
            "symreg_production": run_symreg_production}
SAEM = {"exp06": saem_pipeline.run_exp06, "exp06a": saem_pipeline.run_exp06a,
        "exp06b": saem_pipeline.run_exp06b}
# the JAX scripts' names of exp02's variants and of symreg_production
ALIASES = {"exp07": ("exp02", "covariate"), "exp02_xl": ("exp02", "xl"),
           "exp_symreg_production": ("symreg_production", None)}
EXPERIMENTS = ("exp00", "exp01", "exp02", "exp02_seeds", "exp05", *SAEM,
               "exp_advi", "exp_suppression", "exp_symreg_search",
               "exp_figures", "exp_parity", *SYMBOLIC, *ALIASES)
XL_RESTARTS = 96        # --xl --retrain's restarts unless --restarts says


def out_dir(out: Path | None, artifacts: Path) -> Path | None:
    """``out``, made, unless it is, or lies in, the reference's artifacts
    or results."""
    if out is None:
        return None
    out = out.resolve()
    for ref in (artifacts.resolve(), (REPO / "results").resolve()):
        if out == ref or ref in out.parents:
            raise SystemExit(f"--out {out}: {ref} holds the JAX package's "
                             "reference; name another directory")
    out.mkdir(parents=True, exist_ok=True)
    return out


def _write_csv(path: Path, header: list[str], rows) -> None:
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows([float(v) for v in row] for row in rows)


def _draw(draw, arrays, out: Path, name: str) -> None:
    """``draw(arrays, out/figures/name)`` where matplotlib is installed,
    else a note that the figure was skipped."""
    if figures.available():
        draw(arrays, out / "figures" / name)
        print(f"[figure] {name}", file=sys.stderr)
    else:
        print(f"[skip] {name}: {figures_pipeline.NO_MATPLOTLIB}",
              file=sys.stderr)


def launches() -> dict[str, int]:
    """The kernels launched in this process so far, by module (a 3-input
    body apart), those launched at least once."""
    out = {}
    for mod in (rk4_cohort, rk4_population, lane_grad, tsit5_cohort,
                population_grad):
        short = mod.__name__.rsplit(".", 1)[1]
        for tag, count in (("", mod.launches), (" (3-input)",
                                                mod.launches_age)):
            if count:
                out[short + tag] = count
    return out


def _advi_crosscheck(args, run, smoke: bool = False) -> None:
    """exp_advi's section 3 where ``--data-dir``'s ``../source_data/advi``
    exists, but at ``smoke``: its statistics into ``run.metrics``; else
    the JAX script's line that it skipped."""
    advi_dir = (None if args.data_dir is None
                else args.data_dir.parent / "source_data" / "advi")
    if smoke or advi_dir is None or not advi_dir.exists():
        why = ("smoke run" if smoke else "no --data-dir"
               if advi_dir is None else f"not found at {advi_dir}")
        print(f"[exp_advi] reference ADVI cross-check skipped ({why})",
              file=sys.stderr)
        return
    from conditional_ude_tpu_torch.data.jld2 import load_reference_advi
    from conditional_ude_tpu_torch.data.ohashi import load_npz

    train, _ = load_npz(args.artifacts / "ohashi.npz")
    stats = advi_pipeline.reference_crosscheck(
        args.device, load_reference_advi(advi_dir), train)
    run.metrics["reference_advi_crosscheck"] = stats
    print(f"[exp_advi] reference ADVI cross-check: median quantile-corr "
          f"{stats['quantile_corr_per_restart_median']:.3f}, offset "
          f"{stats['quantile_offset_median']:.3f}", file=sys.stderr)


def main(argv=None) -> None:
    _main(argv)
    print(json.dumps({"launches": launches()}), file=sys.stderr)


def parser() -> argparse.ArgumentParser:
    """The entry point's flags."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--experiment", default="exp02", choices=EXPERIMENTS,
                   help="exp02 (default; --covariate and --xl select exp07 "
                        "and exp02_xl), exp00 (the ETL of the raw CSV "
                        "files), exp_parity (the refit at the reference's "
                        "weights), exp01 (the non-conditional UDE), "
                        "exp02_seeds (exp02's retrain at several seeds), "
                        "exp05 (the less-data ablation), exp06, exp06a or "
                        "exp06b (SAEM on the cUDE, the symbolic model and "
                        "the discovered equation), exp07 and exp02_xl "
                        "(--covariate and --xl), exp_advi (ADVI "
                        "posteriors of the cUDE), exp_suppression (the "
                        "simulated suppression model), exp_symreg_search "
                        "(the GP search for closed-form equations of the "
                        "production surface), exp_figures (the figure "
                        "gallery), exp03, exp04 or "
                        "symreg_production (exp_symreg_production; the "
                        "symbolic refits)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--artifacts", type=Path, default=ARTIFACTS,
                   help="directory holding ohashi.npz, fujita.npz and the "
                        "trained candidates (cude_neural_parameters.npz, "
                        "cude_covariate_neural_parameters.npz, "
                        "cude_neural_parameters_xl.npz, "
                        "ude_neural_parameters.npz)")
    p.add_argument("--out", type=Path, default=None,
                   help="directory for the metrics and the outputs (none "
                        "written without it)")
    p.add_argument("--data-dir", type=Path, default=None,
                   help="the reference's raw-data folder (ohashi_csv/, "
                        "fujita_csv/; ../source_data beside it): exp00 and "
                        "exp_parity read it, exp_advi's cross-check and "
                        "exp_figures' clamp insulin use it where present")
    p.add_argument("--weights", type=Path, default=None,
                   help="exp_parity: the reference's cUDE weight cache "
                        "(default DATA_DIR/../source_data/"
                        "cude_neural_parameters.jld2)")
    p.add_argument("--lbfgs-iters", type=int, default=None,
                   help="L-BFGS steps of the fits: 1000 by default (exp05 "
                        "keeps its own 500 and 1000); exp_suppression's "
                        "sweep, validations and test stage take 2000 "
                        "unless given; --smoke sets its own")
    p.add_argument("--retrain", action="store_true",
                   help="train the candidates (exp02: train_conditional on "
                        "the seed's fit split; exp01: train_ude on the mean "
                        "training curve; exp06: the pre-train on 15 "
                        "training subjects) instead of loading them")
    p.add_argument("--covariate", action="store_true",
                   help="the covariate model of experiment 07: the age as "
                        "the network's third input (combines with "
                        "--retrain)")
    p.add_argument("--xl", action="store_true",
                   help="the enlarged multi-start of experiment 02_xl: more "
                        "designs and restarts, and the guarded selection "
                        "beside the plain one (combines with --retrain)")
    p.add_argument("--inits", type=int, default=400_000,
                   help="designs screened by --xl --retrain")
    p.add_argument("--restarts", type=int, default=None,
                   help="restarts refined by --xl --retrain (default 96; "
                        "above 131,072 / 57 = 2,299 of them the value+grad "
                        "kernel is the restart kernel); exp_advi: the "
                        "joint posteriors of the first N candidates "
                        "(default all 25)")
    p.add_argument("--seed", type=int, default=SEED,
                   help="seed of the fit/validation split and the training "
                        "designs (--retrain) and of exp02's sampled bands; "
                        "exp05's first ablation seed; the seed of "
                        "exp_advi's joint-stage draws (its test stage's "
                        "is 7); of exp_suppression's designs; of "
                        "exp_symreg_search's holdout split and GP keys")
    p.add_argument("--seeds", type=int, nargs="+",
                   default=list(seeds.DEFAULT_SEEDS),
                   help="exp02_seeds: the seeds to run, one after another")
    p.add_argument("--merge", action="store_true",
                   help="exp02_seeds: merge the exp02_seed_*.json records "
                        "under --out into exp02_seeds_metrics.json and "
                        "exp02_seeds.csv instead of running seeds")
    p.add_argument("--ablation-seeds", type=int, default=None,
                   help="exp05: ablation seeds, from --seed on (5; 1 with "
                        "--smoke)")
    p.add_argument("--smoke", action="store_true",
                   help="the JAX script's --smoke sizes, as on a clean "
                        "checkout (8 subjects a split, tiny multi-starts "
                        "and step counts; exp_symreg_search: one GP run at "
                        "depth 2, population 256, 15 generations); the "
                        "outputs go to DIR/smoke of --out DIR")
    sym = p.add_argument_group("exp_symreg_search")
    sym.add_argument("--search-seeds", type=int, default=1,
                     help="independent searches, each its own GP runs and "
                          "front, merged into one front")
    gal = p.add_argument_group("exp_figures")
    gal.add_argument("--sections", nargs="+", default=None,
                     choices=figures_pipeline.SECTIONS,
                     help="the gallery's sections to run (default all)")
    sup = p.add_argument_group("exp_suppression")
    sup.add_argument("--noise", type=float, default=0.1,
                     help="multiplicative noise of the training, the noisy "
                          "validation and the test populations")
    sup.add_argument("--lambdas", type=float, nargs="*", default=None,
                     help="the λ's of the sweep (outputs tagged _<λ>...)")
    sup.add_argument("--fine", action="store_true",
                     help="the 13-point fine λ grid (outputs tagged _fine)")
    sup.add_argument("--joint", action="store_true",
                     help="a no-op, kept for the JAX script's flag: the "
                          "port always fits the λ's as rows of one batch, "
                          "whose rows are each λ's fit alone")
    sup.add_argument("--no-test-stage", action="store_true",
                     help="stop after the sweep and its validations")
    sup.add_argument("--test-only", action="store_true",
                     help="no sweep: revalidate the test λ's restarts of "
                          "--artifacts and run the 60-subject test stage")
    sup.add_argument("--selection-sensitivity", action="store_true",
                     help="no sweep: the test stage of each selection rule "
                          "at every λ of the committed fine grid")
    sup.add_argument("--merge-fine", action="store_true",
                     help="no fitting: merge the per-λ partials under --out "
                          "into the _fine CSV and metrics")
    return p


def _main(argv) -> None:
    p = parser()
    args = p.parse_args(argv)
    if args.experiment in ALIASES:
        if args.covariate or args.xl:
            p.error(f"{args.experiment} is a variant of exp02 already")
        args.experiment, flag = ALIASES[args.experiment]
        if flag is not None:
            setattr(args, flag, True)
    if args.smoke and args.lbfgs_iters is not None:
        p.error("--smoke sets the L-BFGS steps of each stage")
    if args.lbfgs_iters is None and args.experiment != "exp_suppression":
        args.lbfgs_iters = 1000
    if args.experiment != "exp02" and (args.covariate or args.xl):
        p.error("--covariate and --xl select variants of exp02")
    if args.experiment in (*SYMBOLIC, "exp06a", "exp06b") and args.retrain:
        p.error(f"{args.experiment} has no --retrain: it fits every subject")
    if args.experiment == "exp_advi" and args.retrain:
        p.error("exp_advi has no --retrain: it starts from the committed "
                "candidates")
    if args.merge and args.experiment != "exp02_seeds":
        p.error("--merge merges exp02_seeds' records")
    if args.experiment == "exp_suppression" and args.retrain:
        p.error("exp_suppression always fits; --test-only and "
                "--selection-sensitivity read the committed artifacts")
    if args.experiment == "exp00" and args.smoke:
        p.error("exp00 has no --smoke: it converts the raw data whole")
    if args.smoke and (args.test_only or args.selection_sensitivity):
        p.error("--test-only and --selection-sensitivity read the committed "
                "full-size artifacts, which --smoke has none of")
    if args.smoke and args.out is not None:
        args.out = args.out / "smoke"
    if args.experiment in ("exp00", "exp_parity") and args.data_dir is None:
        p.error(f"{args.experiment} reads the raw data: give --data-dir")
    if args.experiment == "exp00" and args.out is None:
        p.error("exp00 writes its npz files and metrics into --out DIR")
    if args.experiment in ("exp00", "exp_parity") and args.retrain:
        p.error(f"{args.experiment} has no --retrain")
    if args.weights is not None and args.experiment != "exp_parity":
        p.error("--weights is exp_parity's")
    if args.experiment != "exp_symreg_search" and args.search_seeds != 1:
        p.error("--search-seeds is exp_symreg_search's")
    if args.sections is not None and args.experiment != "exp_figures":
        p.error("--sections selects exp_figures' sections")
    if args.experiment == "exp_figures" and (args.out is None
                                             or args.retrain):
        p.error("exp_figures draws into --out DIR (required) from the "
                "committed fits; it has no --retrain")
    if args.experiment == "exp_symreg_search" and args.retrain:
        p.error("exp_symreg_search has no --retrain: it reads the committed "
                "production samples and always searches")
    if args.merge_fine:
        if args.experiment != "exp_suppression" or args.out is None:
            p.error("--merge-fine merges exp_suppression's partials under "
                    "--out")
        print(json.dumps(suppression_pipeline.merge_fine_outputs(
            out_dir(args.out, args.artifacts)), default=float))
        return
    if args.merge:
        if args.out is None:
            p.error("--merge needs --out, the directory of the records")
        print(json.dumps(seeds.merge_directory(out_dir(args.out,
                                                       args.artifacts))))
        return
    if args.experiment == "exp00":
        run = etl_pipeline.run_exp00(args.data_dir)
        etl_pipeline.write_outputs(out_dir(args.out, args.artifacts), run)
        print(json.dumps(run.metrics))
        return
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA card is visible "
                         "(--device cpu runs the plain versions)")
    out = out_dir(args.out, args.artifacts)

    if args.experiment == "exp02_seeds":
        sizes = (dict(SMOKE_STAGES, config=SMOKE_TRAIN) if args.smoke
                 else dict(lbfgs_iters=args.lbfgs_iters))
        sizes.update(profile_steps=0, census_steps=0)
        for s in args.seeds:
            res = run_training_pipeline(args.device, args.artifacts, seed=s,
                                        **sizes)
            record = seeds.seed_record(res, s)
            if out is not None:
                arrays, meta = seeds.training_checkpoint(res)
                save_checkpoint(
                    out / "seeds" / f"cude_neural_parameters_{s}.npz",
                    arrays, metadata=meta)
                seeds.seed_path(out, s).write_text(json.dumps(record,
                                                              indent=2))
            print(json.dumps(record), flush=True)
        return
    if args.experiment == "exp05":
        fractions = ablation.SMOKE_FRACTIONS if args.smoke \
            else ablation.FRACTIONS
        sizes = (dict(fractions=fractions, sweep=fractions,
                      config=ablation.SMOKE_CONFIG,
                      steps=ablation.SMOKE_STEPS) if args.smoke else {})
        n_seeds = args.ablation_seeds
        if n_seeds is None:
            n_seeds = 1 if args.smoke else 5
        rows = ablation.run_ablation(args.device, args.artifacts, args.seed,
                                     n_seeds=n_seeds, **sizes)
        if out is not None:
            metrics = ablation.write_ablation(out, rows, fractions)
        else:
            metrics = ablation.aggregate_ablation(rows, fractions)
        print(json.dumps(metrics))
        return

    if args.experiment == "exp_parity":
        weights = args.weights or (args.data_dir.parent / "source_data"
                                   / "cude_neural_parameters.jld2")
        run = parity_pipeline.run_exp_parity(args.device, weights,
                                             args.data_dir, smoke=args.smoke)
        print(json.dumps({"stage_seconds": run.seconds}), file=sys.stderr)
        if out is not None:
            (out / "exp_parity_metrics.json").write_text(
                json.dumps(run.metrics, indent=2))
        print(json.dumps(run.metrics))
        return
    if args.experiment == "exp_advi":
        # --smoke reads exp02's selection from its own outputs, as the JAX
        # script reads results/smoke/exp02_metrics.json
        best = (None if not args.smoke else 0 if out is None
                else advi_pipeline.best_model_index(out))
        run = advi_pipeline.run_exp_advi(args.device, args.artifacts,
                                         seed=args.seed,
                                         restarts=args.restarts,
                                         smoke=args.smoke, best=best)
        _advi_crosscheck(args, run, args.smoke)
        if out is not None:
            advi_pipeline.write_outputs(out, run)
        print(json.dumps(run.metrics))
        return
    if args.experiment == "exp_suppression":
        sizes = (suppression_pipeline.SMOKE if args.smoke
                 else suppression_pipeline.FULL)
        if args.lbfgs_iters is not None:
            sizes = dataclasses.replace(sizes, fit=dataclasses.replace(
                sizes.fit, lbfgs_iters=args.lbfgs_iters))
        run = suppression_pipeline.run_exp_suppression(
            args.device, args.artifacts, out=out, sizes=sizes,
            noise=args.noise, lambdas=args.lambdas, fine=args.fine,
            no_test_stage=args.no_test_stage, test_only=args.test_only,
            selection_sensitivity=args.selection_sensitivity, seed=args.seed)
        if run.revalidated:
            print(json.dumps({"revalidated": run.revalidated}),
                  file=sys.stderr)
        print(json.dumps({"stage_seconds": run.seconds}), file=sys.stderr)
        print(json.dumps(run.metrics, default=float))
        return
    if args.experiment == "exp_figures":
        run = figures_pipeline.run_exp_figures(
            args.device, args.artifacts, out=out, sections=args.sections,
            smoke=args.smoke, data_dir=args.data_dir)
        print(json.dumps({"stage_seconds": run.seconds}), file=sys.stderr)
        print(json.dumps(run.manifest))
        return
    if args.experiment == "exp_symreg_search":
        run = symreg_pipeline.run_exp_symreg_search(
            args.device, args.artifacts, seed=args.seed,
            search_seeds=args.search_seeds, smoke=args.smoke, out=out)
        print(json.dumps({"stage_seconds": run.seconds}), file=sys.stderr)
        print(json.dumps(run.metrics, default=float))
        return
    if args.experiment in SAEM:
        # --smoke trains exp06's pre-train, whose smoke cache is missing
        kw = ({"retrain": args.retrain or args.smoke}
              if args.experiment == "exp06" else {})
        run = SAEM[args.experiment](args.device, args.artifacts,
                                    seed=args.seed, smoke=args.smoke, **kw)
        if out is not None:
            saem_pipeline.write_outputs(out, args.experiment, run)
        print(json.dumps({"stage_seconds": run.seconds, "route": run.route}),
              file=sys.stderr)
        print(json.dumps(run.metrics))
        return
    if args.experiment in SYMBOLIC:
        sizes = (dict(SMOKE_SIZES, subjects=SMOKE_SYMBOLIC[args.experiment])
                 if args.smoke else dict(lbfgs_iters=args.lbfgs_iters))
        res = SYMBOLIC[args.experiment](args.device, args.artifacts, **sizes)
        metrics, name = res.metrics, args.experiment
        if out is not None:
            save_checkpoint(out / res.checkpoint, res.fits,
                            metadata={"script": name})
            if res.figure is not None:
                _draw(draw_external_quantiles, res.figure, out,
                      "model_fit_external_quantiles.png")
    elif args.experiment == "exp01":
        # --smoke trains at its sizes: its smoke cache is missing
        sizes = SMOKE_UDE if args.smoke else dict(
            lbfgs_iters=args.lbfgs_iters)
        res = run_ude_pipeline(args.device, args.artifacts,
                               retrain=args.retrain or args.smoke,
                               seed=args.seed, **sizes)
        metrics, name = res.metrics(), "exp01"
        if out is not None and (args.retrain or args.smoke):
            save_checkpoint(out / "ude_neural_parameters.npz",
                            {"nn_params": res.nn_params,
                             "objectives": res.objectives},
                            metadata={"script": "exp01",
                                      "guesses": sizes.get(
                                          "initial_guesses", 10_000),
                                      "seed": args.seed})
    else:
        config = TrainConfig()
        if args.xl:
            config = TrainConfig(
                initial_guesses=args.inits,
                selected_initials=(XL_RESTARTS if args.restarts is None
                                   else args.restarts))
        if args.smoke:
            # the smoke cache is missing, so the JAX scripts train; exp02_xl
            # runs no profile
            config = dataclasses.replace(
                SMOKE_TRAIN, **({"initial_guesses": SMOKE_XL_INITS}
                                if args.xl else {}))
            sizes = dict(SMOKE_STAGES, **(
                {"profile_steps": 0, "census_steps": 0} if args.xl else {}))
            res = run_training_pipeline(args.device, args.artifacts,
                                        seed=args.seed, config=config,
                                        covariate=args.covariate, xl=args.xl,
                                        **sizes)
        elif args.retrain:
            res = run_training_pipeline(args.device, args.artifacts,
                                        seed=args.seed, config=config,
                                        lbfgs_iters=args.lbfgs_iters,
                                        covariate=args.covariate, xl=args.xl)
        else:
            res = run_frozen_pipeline(args.device, args.artifacts,
                                      lbfgs_iters=args.lbfgs_iters,
                                      covariate=args.covariate, xl=args.xl,
                                      seed=args.seed)
        name = "exp07" if args.covariate else "exp02_xl" if args.xl \
            else "exp02"
        metrics = script_metrics(res, name, config)
        if out is not None and res.dose_response is not None:
            _write_csv(out / "ohashi_production.csv",
                       ["Beta", "Glucose", "Production"], res.dose_response)
        if out is not None and res.band_curves is not None:
            _draw(draw_sampled_bands, res.band_curves, out,
                  "sampled_simulations.png")
        if out is not None and not args.xl:
            file, arrays, meta = fit_export(res, args.covariate)
            save_checkpoint(out / file, arrays, metadata=meta)
    if out is not None:
        (out / f"{name}_metrics.json").write_text(
            json.dumps(metrics, indent=2))
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
