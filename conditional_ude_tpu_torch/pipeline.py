"""The flagship experiment, its covariate variant, its enlarged multi-start
and the non-conditional baseline end to end (counterpart of
``experiments/common.py:119-256``, ``experiments/exp02_conditional.py``,
``experiments/exp07_covariate.py``, ``experiments/exp02_xl.py`` and
``experiments/exp01_non_conditional.py``).

Two paths share the stages after training:

* ``run_frozen_pipeline``: exp02 (exp07 with ``covariate=True``) without
  ``--retrain``, on the trained candidates of ``cude_neural_parameters.npz``
  (``cude_covariate_neural_parameters.npz``) and their fit/validation split;
* ``run_training_pipeline``: the same with ``--retrain``; the stratified
  70/30 fit/validation split of the training subjects from a seed, then
  ``train_conditional`` on the fit split.  It writes nothing into the
  artifacts directory, whose files are the JAX package's reference.

exp07 is exp02 with the age as the network's third input
(``kind="conditional_covariate"``); its test census uses the Raue-95
threshold, and it has no census over all subjects.  exp02_xl (``xl=True``)
is exp02 on a wider multi-start (400,000 designs and 96 restarts by default,
candidates in ``cude_neural_parameters_xl.npz``).  With that many candidates
the least validation objective can belong to an underfit restart, so it
also reports a guarded selection: the least validation objective within the
better half by training objective, and that candidate's own (β, σ) refit.
That refit covers the training subjects too, though only its test SSEs are
reported: the guarded candidate's first-phase Spearman
(``guarded_spearman``) is taken over all subjects, as the selected one's is.

The stages, given candidate networks and their training β's:

1. validation selection: an unbounded β fit of every candidate on every
   validation subject, and the candidate with the least summed objective;
2. (β, σ) re-estimation on all training and all test subjects, bounds the
   selected candidate's training-β range ±10%, and the SSE back-converted
   from the σ-NLL; the training and the test subjects are two fits, as in
   the JAX experiment scripts (``experiments/common.py:227-228``,
   ``experiments/exp02_xl.py:75-83``): one batch of both is not the same
   fit in float32, since a row's gradient depends on the batch it is
   computed in (``tests/test_torch_refit.py``);
3. Spearman correlations of the oriented β with the clamp indices;
4. the test-cohort likelihood profiles over [lb − 1, ub + 1] and their
   identifiability census (Cantelli-95 for exp02, Raue-95 for exp07);
5. exp02 only: the census over all subjects, each scanned over β̂ᵢ ± 10;
6. exp02 only (frozen or retrained): the dose-response table of the
   selected network for symbolic regression, the trajectories of each
   type-average individual at β's drawn from the refit (their 5-95 % band
   at 120 min), and the test MSE of the non-conditional UDE of exp01
   (``ude_neural_parameters.npz``) against the cUDE's.

``run_ude_pipeline`` is exp01: the UDE head's network fitted to the mean
training curve (``train_ude`` with ``retrain``; else the committed
``ude_neural_parameters.npz``), then every training and test subject's MSE
with that one network, by Tsit5 at the JAX package's default tolerances.

The JAX scripts' ``--smoke`` sizes are ``SMOKE_TRAIN``, ``SMOKE_STAGES``
(``run_training_pipeline``'s keywords) and ``SMOKE_UDE``
(``run_ude_pipeline``'s); ``script_metrics`` gives a run's metrics under
the keys of exp02's, exp07's or exp02_xl's script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from conditional_ude_tpu_torch.analysis.profiles import (
    Profile,
    classify_identifiability,
    cohort_beta_profiles,
    find_confidence_intervals,
)
from conditional_ude_tpu_torch.convert import (
    candidate_objectives,
    load_candidates,
    params_from_jax,
)
from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
from conditional_ude_tpu_torch.fit.train import (
    TrainConfig,
    TrainResult,
    evaluate_model,
    fit_betas_sigma,
    select_best,
    train_conditional,
    train_ude,
)
from conditional_ude_tpu_torch.models.cpeptide import (
    KINDS,
    Cohort,
    CPeptideModel,
    build_cohort,
    build_individual,
    production_orientation,
    simulate,
    simulate_cohort,
)
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint
from conditional_ude_tpu_torch.utils.stats import spearman, stratified_split

SEED = 270523   # the flagship's seed (experiments/exp02_conditional.py)
TYPES = ("NGT", "IGT", "T2DM")
# --smoke: the first subjects of each split (experiments/common.py:108-110)
SMOKE_SUBJECTS = 8
# exp02's, exp07's and exp02_seeds' --smoke multi-start
# (experiments/exp02_conditional.py:45-47); exp02_xl's screens 300 designs
SMOKE_TRAIN = TrainConfig(initial_guesses=200, selected_initials=4,
                          adam_iters=25, lbfgs_iters=25)
SMOKE_XL_INITS = 300
# and the stages after it (experiments/common.py:198,220,
# exp02_conditional.py:72,94,151): the refits' L-BFGS steps, the
# selection's, the test profile's and the census's points, the bands'
# samples; the UDE comparison is left out, since a clean checkout has no
# smoke weights of exp01
SMOKE_STAGES = dict(subjects=SMOKE_SUBJECTS, lbfgs_iters=100, select_iters=50,
                    profile_steps=200, census_steps=100, band_samples=50,
                    compare_ude=False)
# exp01's --smoke multi-start (experiments/exp01_non_conditional.py:52-54)
SMOKE_UDE = dict(initial_guesses=100, selected_initials=3, adam_iters=20,
                 lbfgs_iters=20, subjects=SMOKE_SUBJECTS)
# the metrics each JAX experiment script writes, in its order; the port's
# runs add their ``stage_seconds``.  exp07's ``screen_anomaly_note``
# explains a timer of the JAX package's own runs and is left out
SCRIPT_KEYS = {
    "exp02": ("best_model_index", "train_seconds", "train_timings",
              "ude_vs_cude", "sampled_simulation_bands", "objective_best",
              "train_sse_per_type", "test_sse_per_type", "train_sse_mean",
              "test_sse_mean", "beta_bounds", "spearman", "beta_orientation",
              "identifiability_census_test", "identifiability_census_all"),
    "exp07": ("best_model_index", "train_seconds", "train_timings",
              "spearman_age_note", "train_sse_per_type", "test_sse_per_type",
              "spearman", "beta_orientation", "identifiability_census_test"),
    "exp02_xl": ("config", "train_seconds", "best_model_index",
                 "train_sse_per_type", "test_sse_per_type", "train_sse_mean",
                 "test_sse_mean", "test_sse_median", "spearman_first_phase",
                 "selection_note", "guarded_best_model_index",
                 "guarded_test_sse_mean", "guarded_test_sse_median"),
}
SPEARMAN_AGE_NOTE = "near-zero expected: age is an NN input"
SELECTION_NOTE = (
    "argmin-validation at 96 candidates overfits the 25-subject validation "
    "split (the winner can be an underfit restart with a val-lucky flat "
    "surface); guarded_* rows restrict selection to the top half by train "
    "objective")
UDE_WEIGHTS = "ude_neural_parameters.npz"   # exp01's committed candidates
# the DOP853 scores of the reference's own UDE weights (exp01's anchor)
UDE_GOLDEN = (Path(__file__).resolve().parent.parent / "tests" / "golden"
              / "reference_parity_ude_golden.json")


@dataclasses.dataclass(frozen=True)
class Experiment:
    """What exp02, exp07 and exp02_xl differ in."""

    kind: str              # the CPeptideModel's production head
    candidates: str        # the JAX package's trained candidates (artifacts)
    ci_method: str         # threshold of the test-profile census
    census_all: bool       # whether the census over all subjects runs
    guarded: bool = False  # whether the guarded selection is reported too
    # whether the dose-response table, the sampled bands and the UDE
    # comparison are made (exp02 only)
    outputs: bool = False

    def model(self) -> CPeptideModel:
        net = chain(4, 2, "tanh", input_dims=KINDS[self.kind])
        return CPeptideModel(net, self.kind)


EXP02 = Experiment("conditional", "cude_neural_parameters.npz", "cantelli95",
                   census_all=True, outputs=True)
EXP07 = Experiment("conditional_covariate",
                   "cude_covariate_neural_parameters.npz", "raue95",
                   census_all=False)
EXP02_XL = dataclasses.replace(EXP02,
                               candidates="cude_neural_parameters_xl.npz",
                               guarded=True, outputs=False)


def _experiment(covariate: bool, xl: bool) -> Experiment:
    if covariate and xl:
        raise ValueError("the enlarged multi-start is exp02's: it has no "
                         "covariate variant")
    return EXP07 if covariate else EXP02_XL if xl else EXP02


def guarded_best(objectives: np.ndarray) -> int:
    """argmin of the summed validation objectives ``[R, N_val]`` within the
    better half of the candidates, which are sorted best first by training
    objective (``experiments/exp02_xl.py:70-72``)."""
    sums = np.asarray(objectives).sum(axis=1)
    return int(np.argmin(sums[:max(1, len(sums) // 2)]))


@dataclasses.dataclass
class PipelineResult:
    best: int
    val_objectives: np.ndarray   # [R, N_val]
    orientation: float
    bounds: tuple[float, float]
    b_train: np.ndarray
    s_train: np.ndarray
    sse_train: np.ndarray
    b_test: np.ndarray
    s_test: np.ndarray
    sse_test: np.ndarray
    types_train: np.ndarray       # NGT / IGT / T2DM of each subject
    types_test: np.ndarray
    spearman: dict[str, float]
    profile: Profile | None       # test cohort, [35, steps]
    census_test: dict[str, int]
    delta_profile: Profile | None  # all subjects, Δβ axis
    census_all: dict[str, int]
    seconds: dict[str, float]     # wall-clock per stage
    training: TrainResult | None = None   # the retrain path's candidates
    idx_fit: np.ndarray | None = None     # and the subjects they were fit to
    # the guarded selection (exp02_xl): the candidate, its test SSEs from its
    # own refit, and the first-phase Spearman of its oriented β's
    guarded_best: int | None = None
    guarded_sse_test: np.ndarray | None = None
    guarded_spearman: float | None = None
    # the selected candidate's training objective (from the candidates'
    # file, or the retrain's Tsit5 re-rank)
    objective_best: float | None = None
    # exp02's outputs: the dose-response table [900, 3] (Beta = e^β,
    # Glucose = ΔG, Production), the sampled bands and the UDE comparison
    dose_response: np.ndarray | None = None
    bands: dict | None = None
    band_curves: dict | None = None   # sampled_band_curves: the band figure
    ude_vs_cude: dict | None = None

    def metrics(self) -> dict:
        """The exp02 metrics this path computes, as JSON-ready values."""
        guarded = {}
        if self.guarded_best is not None:
            fin = self.guarded_sse_test[np.isfinite(self.guarded_sse_test)]
            guarded = {"guarded_best_model_index": self.guarded_best,
                       "guarded_test_sse_mean": float(np.mean(fin)),
                       "guarded_test_sse_median": float(np.median(fin)),
                       "guarded_spearman_first_phase": self.guarded_spearman}
        outputs = {}
        if self.bands is not None:
            outputs = {"ude_vs_cude": self.ude_vs_cude,
                       "sampled_simulation_bands": self.bands}
        return {
            "best_model_index": self.best,
            "objective_best": self.objective_best,
            "train_seconds": (self.seconds.get("train")
                              if self.training is not None else None),
            "beta_bounds": list(self.bounds),
            "train_sse_mean": float(np.mean(self.sse_train)),
            "test_sse_mean": float(np.mean(self.sse_test)),
            "train_sse_per_type": sse_per_type(self.types_train,
                                               self.sse_train),
            "test_sse_per_type": sse_per_type(self.types_test,
                                              self.sse_test),
            "test_sse_median": float(np.median(self.sse_test)),
            "spearman": self.spearman,
            "beta_orientation": self.orientation,
            "identifiability_census_test": self.census_test,
            "identifiability_census_all": self.census_all,
            "stage_seconds": self.seconds,
            **outputs,
            **guarded,
            # the port's own training (the frozen path trained nothing)
            "train_timings": (self.training.timings
                              if self.training is not None else None),
        }


def script_metrics(result: "PipelineResult", name: str,
                   config: TrainConfig) -> dict:
    """``result``'s metrics under the keys of the JAX experiment script
    ``name`` (exp02, exp07 or exp02_xl), then ``stage_seconds``; exp02_xl's
    ``config`` names the multi-start ``config`` (the candidates' own for
    the frozen path)."""
    m = result.metrics()
    m.update(spearman_age_note=SPEARMAN_AGE_NOTE,
             selection_note=SELECTION_NOTE,
             spearman_first_phase=result.spearman["first_phase"],
             config=(f"{config.initial_guesses} inits, "
                     f"{config.selected_initials} restarts "
                     f"({config.initial_guesses // 25_000}x reference "
                     "screen)"))
    return {**{k: m[k] for k in SCRIPT_KEYS[name]},
            "stage_seconds": m["stage_seconds"]}


def sse_per_type(types: np.ndarray, sse: np.ndarray) -> dict[str, float]:
    """Mean SSE of each NGT / IGT / T2DM class present
    (``experiments/common.py:259-262``)."""
    return {t: float(np.mean(sse[types == t])) for t in TYPES
            if (types == t).any()}


def widened_bounds(betas) -> tuple[float, float]:
    """The range of training β's ``betas`` widened by 10 % of each end's
    magnitude, in their dtype (``02-conditional.jl:91-106``)."""
    b = np.asarray(betas).ravel()
    return (float(b.min() - 0.1 * abs(b.min())),
            float(b.max() + 0.1 * abs(b.max())))


def _counts(census: np.ndarray) -> dict[str, int]:
    return {str(c): int((census == c).sum()) for c in np.unique(census)}


def _cohort(split: OhashiSplit, dev: torch.device):
    return build_cohort(split.glucose, split.timepoints, split.cpeptide,
                        split.ages, split.t2dm, dev)


class _Stages:
    """Wall-clock of named stages, synchronised with the card."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.seconds[name] = time.perf_counter() - t0


def run_frozen_pipeline(device: torch.device | str, artifacts_dir: str | Path,
                        lbfgs_iters: int = 1000, candidates: int | None = None,
                        subjects: int | None = None,
                        profile_steps: int = 10_000,
                        census_steps: int = 1_000,
                        covariate: bool = False,
                        xl: bool = False, seed: int = SEED,
                        band_samples: int = 500) -> PipelineResult:
    """Run the frozen path of exp02 (exp07 with ``covariate``, exp02_xl with
    ``xl``) on ``device``.

    ``candidates`` keeps the first candidates only and ``subjects`` the first
    subjects of the validation, training and test sets (reduced runs).
    exp02's outputs draw ``band_samples`` β's a type from ``seed``.
    """
    exp = _experiment(covariate, xl)
    dev = torch.device(device)
    artifacts_dir = Path(artifacts_dir)
    train, test = load_npz(artifacts_dir / "ohashi.npz")
    nn_np, betas_np, idx_fit, orientations = load_candidates(
        artifacts_dir / exp.candidates)
    objectives = candidate_objectives(artifacts_dir / exp.candidates)
    if exp.guarded and np.any(np.diff(objectives) < 0):
        raise ValueError(f"{exp.candidates}: the guarded selection needs "
                         "the candidates sorted best first")
    val = train.subset(np.setdiff1d(np.arange(len(train.ages)), idx_fit))
    if candidates is not None:
        nn_np, betas_np = nn_np[:candidates], betas_np[:candidates]
        orientations = orientations[:candidates]
    if subjects is not None:
        train, val, test = (s.subset(np.arange(min(subjects, len(s.ages))))
                            for s in (train, val, test))
    model = exp.model()
    stage = _Stages(dev)
    cand = params_from_jax(nn_np, model.net, dev)
    result = _select_and_analyse(
        dev, exp, model, cand, betas_np, orientations, train, val, test,
        stage, lbfgs_iters, profile_steps, census_steps)
    result.objective_best = float(objectives[result.best])
    if exp.outputs:
        _add_outputs(result, model, cand[result.best], train, test,
                     artifacts_dir, seed, band_samples, stage)
    return result


def run_training_pipeline(device: torch.device | str,
                          artifacts_dir: str | Path, seed: int = SEED,
                          config: TrainConfig = TrainConfig(),
                          lbfgs_iters: int = 1000,
                          profile_steps: int = 10_000,
                          census_steps: int = 1_000,
                          covariate: bool = False,
                          xl: bool = False,
                          band_samples: int = 500,
                          subjects: int | None = None,
                          select_iters: int | None = None,
                          compare_ude: bool = True) -> PipelineResult:
    """Run the retrain path of exp02 (exp07 with ``covariate``, exp02_xl
    with ``xl``, whose ``config`` carries the wider multi-start) on
    ``device``: the fit/validation split and the training designs from
    ``seed``, ``train_conditional`` with ``config`` on the fit split, then
    the shared stages on the trained candidates, which training returns
    best first (a step count of 0 skips that profile scan).

    ``subjects`` keeps the first subjects of the training and the test
    split before the fit/validation split is drawn, as the JAX scripts'
    ``--smoke`` does; the selection takes ``select_iters`` L-BFGS steps
    (``lbfgs_iters`` unless given), the refits ``lbfgs_iters``; without
    ``compare_ude`` exp02's outputs leave out the UDE comparison, as the
    JAX script does where exp01's weights are missing."""
    exp = _experiment(covariate, xl)
    dev = torch.device(device)
    train, test = first_subjects(*load_npz(Path(artifacts_dir)
                                           / "ohashi.npz"), subjects)
    idx_fit, idx_val = stratified_split(np.random.default_rng(seed),
                                        train.types, 0.7)
    model = exp.model()
    stage = _Stages(dev)
    with stage("train"):
        trained = train_conditional(
            model, _cohort(train.subset(idx_fit), dev), config,
            generator=torch.Generator(device=dev).manual_seed(seed),
            seed=seed)
    result = _select_and_analyse(
        dev, exp, model, trained.nn_params, trained.betas.cpu().numpy(),
        trained.orientations.cpu().numpy(), train, train.subset(idx_val),
        test, stage, lbfgs_iters, profile_steps, census_steps, select_iters)
    result.training, result.idx_fit = trained, idx_fit
    result.objective_best = float(trained.objectives[result.best])
    if exp.outputs:
        _add_outputs(result, model, trained.nn_params[result.best], train,
                     test, Path(artifacts_dir) if compare_ude else None,
                     seed, band_samples, stage)
    return result


def first_subjects(train: OhashiSplit, test: OhashiSplit, n: int | None
                   ) -> tuple[OhashiSplit, OhashiSplit]:
    """The first ``n`` subjects of each split (both whole for ``None``)."""
    if n is None:
        return train, test
    return tuple(s.subset(np.arange(min(n, len(s.ages))))
                 for s in (train, test))


def dose_response(model: CPeptideModel, nn_params: torch.Tensor,
                  b_train: np.ndarray, glucose: np.ndarray) -> np.ndarray:
    """The network's production on a 30 × 30 grid of (β, ΔG): β at the
    5-95 % quantiles of ``b_train``, ΔG from 0 to the largest glucose
    excursion of ``glucose[N, T]``.  Rows ``[900, 3]`` (Beta = e^β,
    Glucose, Production), β first (``experiments/exp02_conditional.py
    :117-138``, the reference's ``data/ohashi_production.csv``)."""
    beta_grid = np.quantile(b_train, np.linspace(0.05, 0.95, 30))
    dg_grid = np.linspace(0.0, np.ptp(glucose, axis=1).max(), 30)
    bb, gg = (a.ravel() for a in np.meshgrid(beta_grid, dg_grid,
                                             indexing="ij"))
    f32 = dict(dtype=torch.float32, device=nn_params.device)
    with torch.no_grad():
        prod = model.production(nn_params, torch.as_tensor(bb, **f32))(
            torch.as_tensor(gg, **f32))
    return np.stack([np.exp(bb), gg, prod.cpu().numpy()], axis=1)


def dense_grid(timepoints) -> np.ndarray:
    """The 2-minute grid over ``timepoints``' span that the figures'
    trajectories are drawn on."""
    return np.arange(timepoints[0], timepoints[-1] + 0.1,
                     2.0).astype(np.float32)


def sampled_band_curves(model: CPeptideModel, nn_params: torch.Tensor,
                        betas: np.ndarray, split: OhashiSplit, seed: int,
                        n_samples: int = 500) -> dict:
    """For each type, ``n_samples`` β's drawn with replacement from that
    type's ``betas`` and the type-average individual simulated at each on
    a 2-minute grid (RK4, 4 substeps) (``experiments/exp02_conditional.py
    :140-198``).  One generator from ``seed`` draws for the types in
    turn, as the JAX experiment script's does.

    Returns ``{"dense_t": [T], "timepoints": [T_obs], "bands": {type:
    {"mean", "p05", "p95": [T] over the trajectories, "final": [n_samples]
    their last values, "obs_mean", "obs_sd": [T_obs] the type's observed
    c-peptide}}}``, the arrays of exp02's ``sampled_simulations.png``."""
    rng = np.random.default_rng(seed)
    tp = split.timepoints
    dense_t = dense_grid(tp)
    bands = {}
    for t in TYPES:
        sel = split.types == t
        if not sel.any():
            continue
        ind = build_individual(split.glucose[sel].mean(axis=0), tp,
                               float(split.ages[sel].mean()),
                               float(split.cpeptide[sel, 0].mean()),
                               t == "T2DM", nn_params.device)
        sampled = rng.choice(betas[sel], size=n_samples, replace=True)
        with torch.no_grad():
            sols = simulate(model, nn_params, np.asarray(sampled, np.float32),
                            ind, dense_t, solver="rk4",
                            substeps=4).ys[..., 0].cpu().numpy()
        bands[t] = {"mean": sols.mean(axis=0),
                    "p05": np.quantile(sols, 0.05, axis=0),
                    "p95": np.quantile(sols, 0.95, axis=0),
                    "final": sols[:, -1],
                    "obs_mean": split.cpeptide[sel].mean(axis=0),
                    "obs_sd": split.cpeptide[sel].std(axis=0)}
    return {"dense_t": dense_t, "timepoints": tp, "bands": bands}


def band_summary(curves: dict) -> dict[str, dict[str, float]]:
    """The mean, 5 % and 95 % of each type's trajectories at the last time
    (exp02's ``sampled_simulation_bands`` metric)."""
    return {t: {"mean_final": float(c["mean"][-1]),
                "p05_final": float(np.quantile(c["final"], 0.05)),
                "p95_final": float(np.quantile(c["final"], 0.95))}
            for t, c in curves["bands"].items()}


def sampled_bands(model: CPeptideModel, nn_params: torch.Tensor,
                  betas: np.ndarray, split: OhashiSplit, seed: int,
                  n_samples: int = 500) -> dict[str, dict[str, float]]:
    """:func:`band_summary` of :func:`sampled_band_curves`."""
    return band_summary(sampled_band_curves(model, nn_params, betas, split,
                                            seed, n_samples))


def draw_sampled_bands(curves: dict, path: Path) -> None:
    """exp02's ``sampled_simulations.png`` from :func:`sampled_band_curves`
    (the type's observed mean ± sd as error bars)."""
    from conditional_ude_tpu_torch.utils import figures

    bands = curves["bands"]
    figures.save(figures.band_panels(
        curves["dense_t"], bands, curves["timepoints"],
        {t: c["obs_mean"] for t, c in bands.items()},
        obs_err={t: c["obs_sd"] for t, c in bands.items()}, center="mean",
        figsize=(9, 2.8)), path)


def fit_export(res: "PipelineResult", covariate: bool) -> tuple[str, dict,
                                                                 dict]:
    """exp02's canonical fits as ``cude_fit.npz`` writes them
    (``experiments/exp02_conditional.py:104-115``: the (β, σ, SSE) refits,
    the test profile and the Δβ census), or exp07's as
    ``cude_covariate_fit.npz`` (``experiments/exp07_covariate.py:72-80``:
    the refits only): ``(file name, arrays, metadata)``."""
    arrays = {"beta_train": res.b_train, "sigma_train": res.s_train,
              "sse_train": res.sse_train, "beta_test": res.b_test,
              "sigma_test": res.s_test, "sse_test": res.sse_test}
    if not covariate:
        for key, prof in (("profile", res.profile),
                          ("delta", res.delta_profile)):
            if prof is not None:
                arrays[f"{key}_grid"] = prof.grid.cpu().numpy()
                arrays[f"{key}_values"] = prof.values.cpu().numpy()
    meta = {"script": "exp07" if covariate else "exp02",
            "best_model_index": int(res.best),
            "bounds": [float(b) for b in res.bounds]}
    return ("cude_covariate_fit.npz" if covariate else "cude_fit.npz",
            arrays, meta)


def ude_model() -> CPeptideModel:
    """exp01's non-conditional UDE: chain(4, 2) on [ΔG], 33 weights."""
    return CPeptideModel(chain(4, 2, "tanh", input_dims=1), "ude")


def ude_mse(nn_params: torch.Tensor, split: OhashiSplit,
            dev: torch.device) -> np.ndarray:
    """Each subject's MSE with the UDE network ``nn_params[P]``, Tsit5 at
    the JAX package's defaults (its ``simulate_cohort``)."""
    with torch.no_grad():
        res = simulate_cohort(ude_model(), nn_params, None,
                              _cohort(split, dev), solver="tsit5")
    return np.mean((res.ys[..., 0].cpu().numpy() - split.cpeptide) ** 2,
                   axis=1)


def _add_outputs(result: PipelineResult, model: CPeptideModel,
                 nn_best: torch.Tensor, train: OhashiSplit,
                 test: OhashiSplit, artifacts_dir: Path | None, seed: int,
                 band_samples: int, stage: _Stages) -> None:
    """exp02's outputs on the selected network: the dose-response table,
    the sampled bands and, when exp01's weights are in ``artifacts_dir``,
    the UDE comparison on the test subjects."""
    with stage("outputs"):
        result.dose_response = dose_response(model, nn_best, result.b_train,
                                             train.glucose)
        result.band_curves = sampled_band_curves(
            model, nn_best, np.concatenate([result.b_train, result.b_test]),
            OhashiSplit.concatenate(train, test), seed, band_samples)
        result.bands = band_summary(result.band_curves)
        path = None if artifacts_dir is None else artifacts_dir / UDE_WEIGHTS
        if path is not None and path.exists():
            ude = load_checkpoint(path)[0]["nn_params"][0]
            result.ude_vs_cude = ude_vs_cude(
                params_from_jax(ude, ude_model().net, nn_best.device), test,
                result.sse_test)


def ude_vs_cude(ude_nn: torch.Tensor, test: OhashiSplit,
                sse_test: np.ndarray) -> dict[str, float]:
    """The test subjects' MSE with exp01's UDE network ``ude_nn[P]`` against
    the cUDE's, from its refit SSEs (``experiments/exp02_conditional.py
    :200-222``)."""
    mse_ude = ude_mse(ude_nn, test, ude_nn.device)
    mse_cude = sse_test / test.timepoints.shape[0]
    return {"test_mse_ude_mean": float(mse_ude.mean()),
            "test_mse_cude_mean": float(mse_cude.mean()),
            "cude_better_fraction": float((mse_cude < mse_ude).mean())}


@dataclasses.dataclass
class UDEResult:
    """exp01: the UDE network(s), best first, and each subject's MSE."""

    nn_params: torch.Tensor       # [R, P]
    objectives: np.ndarray        # [R] training SSE on the mean curve
    mse_train: np.ndarray
    mse_test: np.ndarray
    types_train: np.ndarray
    types_test: np.ndarray
    seconds: dict[str, float]

    def metrics(self) -> dict:
        """exp01's metrics (``results/exp01_metrics.json``'s keys)."""
        golden = None
        if UDE_GOLDEN.exists():
            g = json.loads(UDE_GOLDEN.read_text())
            golden = {"mse_train_per_point": g["mse_train"],
                      "mse_test_per_point": g["mse_test"],
                      "source": g["source_weights"]}
        return {
            "objective_best": float(self.objectives[0]),
            "train_mse_mean": float(self.mse_train.mean()),
            "test_mse_mean": float(self.mse_test.mean()),
            "train_mse_per_type": sse_per_type(self.types_train,
                                               self.mse_train),
            "test_mse_per_type": sse_per_type(self.types_test,
                                              self.mse_test),
            "reference_ude_weights_golden": golden,
            "stage_seconds": self.seconds,
        }


def run_ude_pipeline(device: torch.device | str, artifacts_dir: str | Path,
                     retrain: bool = False, seed: int = SEED,
                     initial_guesses: int = 10_000,
                     selected_initials: int = 10, adam_iters: int = 1000,
                     lbfgs_iters: int = 1000,
                     subjects: int | None = None) -> UDEResult:
    """exp01 on ``device``: the UDE network fitted to the mean training
    curve by ``train_ude`` (designs from ``seed``) with ``retrain``, else
    the committed ``ude_neural_parameters.npz``; then every subject's MSE
    with the best network.  ``subjects`` keeps the first subjects of each
    split (the mean curve is theirs)."""
    dev = torch.device(device)
    artifacts_dir = Path(artifacts_dir)
    train, test = first_subjects(*load_npz(artifacts_dir / "ohashi.npz"),
                                 subjects)
    model = ude_model()
    stage = _Stages(dev)
    if retrain:
        mean_c = train.cpeptide.mean(axis=0).astype(np.float32)
        mean_ind = build_individual(train.glucose.mean(axis=0),
                                    train.timepoints,
                                    float(train.ages.mean()),
                                    float(mean_c[0]), False, dev)
        with stage("train"):
            nn, objs, _, timings = train_ude(
                model, mean_ind, mean_c, initial_guesses=initial_guesses,
                selected_initials=selected_initials, adam_iters=adam_iters,
                lbfgs_iters=lbfgs_iters,
                generator=torch.Generator(device=dev).manual_seed(seed))
        stage.seconds.update({f"train_{k}": v for k, v in timings.items()})
        objs = objs.cpu().numpy()
    else:
        art = load_checkpoint(artifacts_dir / UDE_WEIGHTS)[0]
        nn = params_from_jax(art["nn_params"], model.net, dev)
        objs = np.asarray(art["objectives"])
    with stage("evaluate"):
        mse_train, mse_test = (ude_mse(nn[0], s, dev) for s in (train, test))
    return UDEResult(nn_params=nn, objectives=objs, mse_train=mse_train,
                     mse_test=mse_test, types_train=train.types,
                     types_test=test.types, seconds=stage.seconds)


def refit_split(model: CPeptideModel, nn_params: torch.Tensor,
                cohorts: tuple[Cohort, ...], bounds: tuple[float, float],
                lbfgs_iters: int) -> tuple[np.ndarray, ...]:
    """``fit_betas_sigma`` from β = −1 within ``bounds`` on each cohort
    apart, as the JAX experiment scripts re-estimate the training and the
    test subjects; ``(β, σ, objective)`` of all of them, in the cohorts'
    order."""
    fits = [fit_betas_sigma(model, nn_params, c, initial_beta=-1.0,
                            bounds=(float(bounds[0]), float(bounds[1])),
                            lbfgs_iters=lbfgs_iters) for c in cohorts]
    return tuple(torch.cat(parts).cpu().numpy() for parts in zip(*fits))


def _select_and_analyse(dev, exp: Experiment, model: CPeptideModel,
                        cand: torch.Tensor,
                        betas_np: np.ndarray, orientations: np.ndarray,
                        train: OhashiSplit, val: OhashiSplit,
                        test: OhashiSplit, stage: _Stages, lbfgs_iters: int,
                        profile_steps: int, census_steps: int,
                        select_iters: int | None = None) -> PipelineResult:
    """Stages 1-5 of ``exp`` on candidates ``cand[R, P]`` with training β's
    ``betas_np[R, N_fit(, 1)]``; a step count of 0 skips that scan.  The
    selection takes ``select_iters`` L-BFGS steps (``lbfgs_iters`` unless
    given), the refits ``lbfgs_iters``."""
    with stage("select"):
        objectives = evaluate_model(
            model, cand, torch.as_tensor(betas_np, device=dev),
            _cohort(val, dev), lbfgs_iters=(lbfgs_iters if select_iters is None
                                            else select_iters))
        best = select_best(objectives)
    both = OhashiSplit.concatenate(train, test)
    cohort_both = _cohort(both, dev)
    split_cohorts = (_cohort(train, dev), _cohort(test, dev))
    n_t = train.timepoints.shape[0]
    n_train = len(train.ages)

    def refit(i: int, name: str):
        """(β, σ) re-estimation of all subjects on candidate ``i``: its
        gauge, its bounds (the training-β range ±10%), β, σ and the SSE
        back-converted from the σ-NLL, training subjects first."""
        if orientations.size:
            gauge = float(orientations[i])
        else:
            gauge = production_orientation(model, cand[i],
                                           age=float(np.mean(train.ages)))
        bb = np.asarray(betas_np[i], np.float32).ravel()
        lb = bb.min() - 0.1 * abs(bb.min())
        ub = bb.max() + 0.1 * abs(bb.max())
        with stage(name):
            b, s, o = refit_split(model, cand[i], split_cohorts, (lb, ub),
                                  lbfgs_iters)
        return gauge, lb, ub, b, s, (o - (n_t / 2) * np.log(s**2)) * (2 * s**2)

    nn_best = cand[best]
    orientation, lb, ub, b_all, s_all, sse_all = refit(best, "refit")
    b_train, b_test = b_all[:n_train], b_all[n_train:]
    s_train, s_test = s_all[:n_train], s_all[n_train:]
    sse_train, sse_test = sse_all[:n_train], sse_all[n_train:]

    b_idx = orientation * b_all
    corr = {"first_phase": spearman(b_idx, both.first_phase),
            "age": spearman(b_idx, both.ages),
            "insulin_sensitivity": spearman(b_idx, both.insulin_sensitivity)}

    guarded = {}
    if exp.guarded:
        guard = guarded_best(objectives.cpu().numpy())
        if guard != best:
            gauge, _, _, b_g, _, sse_g = refit(guard, "guarded_refit")
        else:
            gauge, b_g, sse_g = orientation, b_all, sse_all
        guarded = dict(guarded_best=guard, guarded_sse_test=sse_g[n_train:],
                       guarded_spearman=spearman(gauge * b_g,
                                                 both.first_phase))

    prof, census_test, prof_all, census_all = None, {}, None, {}
    if profile_steps:
        with stage("profile_test"):
            prof = cohort_beta_profiles(model, nn_best, _cohort(test, dev),
                                        sigmas=s_test, lower=float(lb) - 1.0,
                                        upper=float(ub) + 1.0,
                                        steps=profile_steps)
            census_test = _counts(classify_identifiability(
                find_confidence_intervals(prof, exp.ci_method)))
    if census_steps and exp.census_all:
        with stage("census"):
            prof_all = cohort_beta_profiles(model, nn_best, cohort_both,
                                            sigmas=s_all, lower=-10.0,
                                            upper=10.0, steps=census_steps,
                                            center=b_all)
            census_all = _counts(classify_identifiability(
                find_confidence_intervals(prof_all, "cantelli95")))

    return PipelineResult(
        best=best, val_objectives=objectives.cpu().numpy(),
        orientation=orientation, bounds=(float(lb), float(ub)),
        b_train=b_train, s_train=s_train, sse_train=sse_train,
        b_test=b_test, s_test=s_test, sse_test=sse_test,
        types_train=train.types, types_test=test.types, spearman=corr,
        profile=prof, census_test=census_test, delta_profile=prof_all,
        census_all=census_all, seconds=stage.seconds, **guarded)
