"""The frozen-network path of the flagship experiment, end to end
(counterpart of ``experiments/common.py:119-256`` and
``experiments/exp02_conditional.py:58-102`` without ``--retrain``).

With the trained candidates of ``cude_neural_parameters.npz`` held fixed:

1. validation selection: an unbounded β fit of every candidate on every
   validation subject (the training subjects outside the artifact's
   ``idx_fit``), and the candidate with the least summed objective;
2. (β, σ) re-estimation on all training and all test subjects, bounds the
   selected candidate's training-β range ±10%, and the SSE back-converted
   from the σ-NLL;
3. Spearman correlations of the oriented β with the clamp indices;
4. the test-cohort likelihood profiles over [lb − 1, ub + 1] and their
   Cantelli-95 identifiability census;
5. the census over all subjects, each scanned over β̂ᵢ ± 10.
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
from conditional_ude_tpu_torch.convert import load_candidates, params_from_jax
from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
from conditional_ude_tpu_torch.fit.train import (
    evaluate_model,
    fit_betas_sigma,
    select_best,
)
from conditional_ude_tpu_torch.models.cpeptide import (
    CPeptideModel,
    build_cohort,
    production_orientation,
)
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.utils.stats import spearman

@dataclasses.dataclass
class FrozenResult:
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
    spearman: dict[str, float]
    profile: Profile              # test cohort, [35, steps]
    census_test: dict[str, int]
    delta_profile: Profile        # all subjects, Δβ axis
    census_all: dict[str, int]
    seconds: dict[str, float]     # wall-clock per stage

    def metrics(self) -> dict:
        """The exp02 metrics this path computes, as JSON-ready values."""
        return {
            "best_model_index": self.best,
            "beta_bounds": list(self.bounds),
            "train_sse_mean": float(np.mean(self.sse_train)),
            "test_sse_mean": float(np.mean(self.sse_test)),
            "spearman": self.spearman,
            "beta_orientation": self.orientation,
            "identifiability_census_test": self.census_test,
            "identifiability_census_all": self.census_all,
            "stage_seconds": self.seconds,
        }


def _counts(census: np.ndarray) -> dict[str, int]:
    return {str(c): int((census == c).sum()) for c in np.unique(census)}


def run_frozen_pipeline(device: torch.device | str, artifacts_dir: str | Path,
                        lbfgs_iters: int = 1000, candidates: int | None = None,
                        subjects: int | None = None,
                        profile_steps: int = 10_000,
                        census_steps: int = 1_000) -> FrozenResult:
    """Run the frozen path on ``device``.

    ``candidates`` keeps the first candidates only and ``subjects`` the first
    subjects of the validation, training and test sets (reduced runs).
    """
    dev = torch.device(device)
    artifacts_dir = Path(artifacts_dir)
    seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(name):
        t0 = time.perf_counter()
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0

    train, test = load_npz(artifacts_dir / "ohashi.npz")
    nn_np, betas_np, idx_fit, orientations = load_candidates(
        artifacts_dir / "cude_neural_parameters.npz")
    val = train.subset(np.setdiff1d(np.arange(len(train.ages)), idx_fit))
    if candidates is not None:
        nn_np, betas_np = nn_np[:candidates], betas_np[:candidates]
        orientations = orientations[:candidates]
    if subjects is not None:
        train, val, test = (s.subset(np.arange(min(subjects, len(s.ages))))
                            for s in (train, val, test))

    def cohort(split: OhashiSplit):
        return build_cohort(split.glucose, split.timepoints, split.cpeptide,
                            split.ages, split.t2dm, dev)

    net = chain(4, 2, "tanh", input_dims=2)
    model = CPeptideModel(net)
    cand = params_from_jax(nn_np, net, dev)

    with stage("select"):
        objectives = evaluate_model(
            model, cand, torch.as_tensor(betas_np, device=dev), cohort(val),
            lbfgs_iters=lbfgs_iters)
        best = select_best(objectives)
    nn_best = cand[best]
    betas_best = np.asarray(betas_np[best], np.float32).ravel()
    if orientations.size:
        orientation = float(orientations[best])
    else:
        orientation = production_orientation(model, nn_best)

    # bounds: the training-β range ±10%
    lb = betas_best.min() - 0.1 * abs(betas_best.min())
    ub = betas_best.max() + 0.1 * abs(betas_best.max())
    # training and test subjects in one batch: every individual is its own
    # L-BFGS row, so this equals two separate fits
    both = OhashiSplit.concatenate(train, test)
    cohort_both = cohort(both)
    with stage("refit"):
        b_all, s_all, o_all = (t.cpu().numpy() for t in fit_betas_sigma(
            model, nn_best, cohort_both, initial_beta=-1.0,
            bounds=(float(lb), float(ub)), lbfgs_iters=lbfgs_iters))
    # σ-NLL objectives back to SSE
    n_t = train.timepoints.shape[0]
    sse_all = (o_all - (n_t / 2) * np.log(s_all**2)) * (2 * s_all**2)
    n_train = len(train.ages)
    b_train, b_test = b_all[:n_train], b_all[n_train:]
    s_train, s_test = s_all[:n_train], s_all[n_train:]
    sse_train, sse_test = sse_all[:n_train], sse_all[n_train:]

    b_idx = orientation * b_all
    corr = {"first_phase": spearman(b_idx, both.first_phase),
            "age": spearman(b_idx, both.ages),
            "insulin_sensitivity": spearman(b_idx, both.insulin_sensitivity)}

    with stage("profile_test"):
        prof = cohort_beta_profiles(model, nn_best, cohort(test),
                                    sigmas=s_test, lower=float(lb) - 1.0,
                                    upper=float(ub) + 1.0,
                                    steps=profile_steps)
        census_test = _counts(classify_identifiability(
            find_confidence_intervals(prof, "cantelli95")))
    with stage("census"):
        prof_all = cohort_beta_profiles(model, nn_best, cohort_both,
                                        sigmas=s_all, lower=-10.0, upper=10.0,
                                        steps=census_steps, center=b_all)
        census_all = _counts(classify_identifiability(
            find_confidence_intervals(prof_all, "cantelli95")))

    return FrozenResult(
        best=best, val_objectives=objectives.cpu().numpy(),
        orientation=orientation, bounds=(float(lb), float(ub)),
        b_train=b_train, s_train=s_train, sse_train=sse_train,
        b_test=b_test, s_test=s_test, sse_test=sse_test, spearman=corr,
        profile=prof, census_test=census_test, delta_profile=prof_all,
        census_all=census_all, seconds=seconds)
