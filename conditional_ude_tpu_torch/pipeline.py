"""The flagship experiment, its covariate variant and its enlarged
multi-start end to end (counterpart of ``experiments/common.py:119-256``,
``experiments/exp02_conditional.py``, ``experiments/exp07_covariate.py`` and
``experiments/exp02_xl.py``).

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
5. exp02 only: the census over all subjects, each scanned over β̂ᵢ ± 10.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
)
from conditional_ude_tpu_torch.models.cpeptide import (
    KINDS,
    Cohort,
    CPeptideModel,
    build_cohort,
    production_orientation,
)
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.utils.stats import spearman, stratified_split

SEED = 270523   # the flagship's seed (experiments/exp02_conditional.py)


@dataclasses.dataclass(frozen=True)
class Experiment:
    """What exp02, exp07 and exp02_xl differ in."""

    kind: str              # the CPeptideModel's production head
    candidates: str        # the JAX package's trained candidates (artifacts)
    ci_method: str         # threshold of the test-profile census
    census_all: bool       # whether the census over all subjects runs
    guarded: bool = False  # whether the guarded selection is reported too

    def model(self) -> CPeptideModel:
        net = chain(4, 2, "tanh", input_dims=KINDS[self.kind])
        return CPeptideModel(net, self.kind)


EXP02 = Experiment("conditional", "cude_neural_parameters.npz", "cantelli95",
                   census_all=True)
EXP07 = Experiment("conditional_covariate",
                   "cude_covariate_neural_parameters.npz", "raue95",
                   census_all=False)
EXP02_XL = dataclasses.replace(EXP02,
                               candidates="cude_neural_parameters_xl.npz",
                               guarded=True)


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
    # the guarded selection (exp02_xl): the candidate, its test SSEs from its
    # own refit, and the first-phase Spearman of its oriented β's
    guarded_best: int | None = None
    guarded_sse_test: np.ndarray | None = None
    guarded_spearman: float | None = None

    def metrics(self) -> dict:
        """The exp02 metrics this path computes, as JSON-ready values."""
        guarded = {}
        if self.guarded_best is not None:
            fin = self.guarded_sse_test[np.isfinite(self.guarded_sse_test)]
            guarded = {"guarded_best_model_index": self.guarded_best,
                       "guarded_test_sse_mean": float(np.mean(fin)),
                       "guarded_test_sse_median": float(np.median(fin)),
                       "guarded_spearman_first_phase": self.guarded_spearman}
        return {
            "best_model_index": self.best,
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
            **guarded,
            **({"train_timings": self.training.timings}
               if self.training is not None else {}),
        }


def sse_per_type(types: np.ndarray, sse: np.ndarray) -> dict[str, float]:
    """Mean SSE of each NGT / IGT / T2DM class present
    (``experiments/common.py:259-262``)."""
    return {t: float(np.mean(sse[types == t])) for t in ("NGT", "IGT", "T2DM")
            if (types == t).any()}


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
                        xl: bool = False) -> PipelineResult:
    """Run the frozen path of exp02 (exp07 with ``covariate``, exp02_xl with
    ``xl``) on ``device``.

    ``candidates`` keeps the first candidates only and ``subjects`` the first
    subjects of the validation, training and test sets (reduced runs).
    """
    exp = _experiment(covariate, xl)
    dev = torch.device(device)
    artifacts_dir = Path(artifacts_dir)
    train, test = load_npz(artifacts_dir / "ohashi.npz")
    nn_np, betas_np, idx_fit, orientations = load_candidates(
        artifacts_dir / exp.candidates)
    if exp.guarded and np.any(np.diff(candidate_objectives(
            artifacts_dir / exp.candidates)) < 0):
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
    return _select_and_analyse(
        dev, exp, model, params_from_jax(nn_np, model.net, dev), betas_np,
        orientations, train, val, test, _Stages(dev), lbfgs_iters,
        profile_steps, census_steps)


def run_training_pipeline(device: torch.device | str,
                          artifacts_dir: str | Path, seed: int = SEED,
                          config: TrainConfig = TrainConfig(),
                          lbfgs_iters: int = 1000,
                          profile_steps: int = 10_000,
                          census_steps: int = 1_000,
                          covariate: bool = False,
                          xl: bool = False) -> PipelineResult:
    """Run the retrain path of exp02 (exp07 with ``covariate``, exp02_xl
    with ``xl``, whose ``config`` carries the wider multi-start) on
    ``device``: the fit/validation split and the training designs from
    ``seed``, ``train_conditional`` with ``config`` on the fit split, then
    the shared stages on the trained candidates, which training returns
    best first (a step count of 0 skips that profile scan)."""
    exp = _experiment(covariate, xl)
    dev = torch.device(device)
    train, test = load_npz(Path(artifacts_dir) / "ohashi.npz")
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
        test, stage, lbfgs_iters, profile_steps, census_steps)
    return dataclasses.replace(result, training=trained)


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
                        profile_steps: int,
                        census_steps: int) -> PipelineResult:
    """Stages 1-5 of ``exp`` on candidates ``cand[R, P]`` with training β's
    ``betas_np[R, N_fit(, 1)]``; a step count of 0 skips that scan."""
    with stage("select"):
        objectives = evaluate_model(
            model, cand, torch.as_tensor(betas_np, device=dev),
            _cohort(val, dev), lbfgs_iters=lbfgs_iters)
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
