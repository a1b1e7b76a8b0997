"""The ADVI experiment end to end (counterpart of ``experiments/exp_advi.py``,
sections 1 and 2): variational posteriors of the cUDE.

1. the joint posterior over (network, every β, log σ) of each trained
   candidate of ``cude_neural_parameters.npz`` on its 57 fit subjects, from
   the candidate and its training β's (2,000 steps, 4 samples, RK4 at 4
   substeps), and each restart's correlation of its β means with those
   point fits;
2. the β posteriors of the 35 test subjects on the selected candidate
   (``results/exp02_metrics.json``'s ``best_model_index``, read only), the
   network frozen (1,500 steps, 8 samples, RK4 at 4 substeps), their
   Spearman against the first-phase index, and the profile cross-check:
   β-profiles over [−6, 2] at 2,000 points (K4, 8 substeps) at each
   subject's posterior σ, their Cantelli-95 intervals, and the correlation
   of the posterior sd with the interval's half-width where it is finite.

Both ELBO gradients take K2 (``fit/advi.py``): one launch a step of 25 × 4
rows over 57 subjects (5,700 lanes) in the joint stage and of 8 rows over
35 subjects (280 lanes) in the test stage.  The draws come from a
``torch.Generator`` on the CPU seeded ``seed`` (joint) and 7 (test), where
the JAX script takes ``key(seed)`` and ``key(7)``, and are moved to the
device, so a run on the card and one on the CPU consume the same draws; or
they are passed in (``draws``).  Section 3 of the JAX script, the
cross-check against the reference repository's JLD2 ADVI results
(``source_data/advi``), is not ported: this package reads no JLD2 file,
and the entry point says it skipped it, as the JAX script does where the
files are missing.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from conditional_ude_tpu_torch.analysis.profiles import (
    cohort_beta_profiles,
    find_confidence_intervals,
)
from conditional_ude_tpu_torch.convert import load_candidates, params_from_jax
from conditional_ude_tpu_torch.data.ohashi import load_npz
from conditional_ude_tpu_torch.fit import advi
from conditional_ude_tpu_torch.models.cpeptide import CPeptideModel
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.pipeline import SEED, _cohort, _Stages
from conditional_ude_tpu_torch.utils.checkpoint import save_checkpoint
from conditional_ude_tpu_torch.utils.stats import spearman

TEST_SEED = 7           # the JAX script's key of the test stage
SUBSTEPS = 4            # RK4 substeps of both ELBOs
JOINT_SAMPLES = 4


@dataclasses.dataclass
class AdviRun:
    metrics: dict                   # the JAX script's keys and stage_seconds
    joint: dict                     # advi_cude_results.npz's arrays
    test: dict                      # advi_test_posteriors.npz's arrays
    joint_meta: dict
    test_meta: dict


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def best_model_index(results_dir: Path) -> int:
    """The selected candidate of exp02, 0 if the metrics are missing (as
    the JAX script falls back)."""
    try:
        return int(json.loads((results_dir / "exp02_metrics.json")
                              .read_text())["best_model_index"])
    except (OSError, KeyError, ValueError):
        return 0


def run_exp_advi(device: torch.device | str, artifacts_dir: str | Path,
                 seed: int = SEED, restarts: int | None = None,
                 fit_subjects: int | None = None, joint_steps: int = 2000,
                 test_steps: int = 1500, profile_steps: int = 2000,
                 draws=None) -> AdviRun:
    """exp_advi on ``device``: every committed candidate (the first
    ``restarts``) on its fit subjects (the first ``fit_subjects``), then
    the test stage.  ``draws = (joint normals [joint_steps, R, 4, P + N +
    1], test normals [test_steps, 35, 8, 2])`` replace the generators'."""
    dev = torch.device(device)
    artifacts_dir = Path(artifacts_dir)
    train, test = load_npz(artifacts_dir / "ohashi.npz")
    candidates, betas_cand, idx_fit, _ = load_candidates(
        artifacts_dir / "cude_neural_parameters.npz")
    if fit_subjects is not None:
        idx_fit = idx_fit[:fit_subjects]
    n_restarts = candidates.shape[0] if restarts is None else min(
        restarts, candidates.shape[0])
    if n_restarts < 1:
        raise ValueError(f"exp_advi needs at least one restart, got "
                         f"{restarts}")
    model = CPeptideModel(chain(4, 2))
    cohort_fit = _cohort(train.subset(idx_fit), dev)
    cohort_test = _cohort(test, dev)
    joint_normals, test_normals = (None, None) if draws is None else draws
    stage = _Stages(dev)

    # -- 1. the joint posterior of every restart ------------------------------
    nn0 = params_from_jax(candidates[:n_restarts], model.net, dev)
    b0 = betas_cand[:n_restarts, :cohort_fit.n, 0]
    with stage("joint"):
        joint = advi.advi_joint(
            model, cohort_fit, nn0, torch.as_tensor(b0, device=dev),
            steps=joint_steps, n_samples=JOINT_SAMPLES, normals=joint_normals,
            generator=torch.Generator().manual_seed(seed),
            substeps=SUBSTEPS)
    beta_mean = _host(joint.beta_mean)
    corr_point = [float(np.corrcoef(beta_mean[r], b0[r])[0, 1])
                  for r in range(n_restarts)]
    elbo_final = _host(joint.elbo_trace[:, -1])

    # -- 2. the test subjects' β posteriors on the selected network ----------
    best = min(best_model_index(artifacts_dir.parent / "results"),
               candidates.shape[0] - 1)
    nn_best = params_from_jax(candidates[best], model.net, dev)
    with stage("test_beta"):
        post = advi.advi_betas(
            model, nn_best, cohort_test, initial_beta=-1.0, steps=test_steps,
            normals=test_normals,
            generator=torch.Generator().manual_seed(TEST_SEED),
            substeps=SUBSTEPS)
    b_mean, b_std = _host(post.beta_mean), _host(post.beta_std)
    with stage("profile"):
        prof = cohort_beta_profiles(model, nn_best, cohort_test,
                                    sigmas=torch.exp(post.log_sigma_mean),
                                    lower=-6.0, upper=2.0,
                                    steps=profile_steps)
        ci = find_confidence_intervals(prof, "cantelli95")
    half_width = 0.5 * (ci.upper - ci.lower)
    ok = np.isfinite(half_width)
    metrics = {
        "n_restarts": int(n_restarts),
        "joint_elbo_final_best": float(np.max(elbo_final)),
        "joint_beta_pointfit_corr_mean": float(np.mean(corr_point)),
        "test_spearman_first_phase": spearman(b_mean, test.first_phase),
        "test_beta_std_median": float(np.median(b_std)),
        "advi_sd_vs_profile_ci_corr": (
            float(np.corrcoef(b_std[ok], half_width[ok])[0, 1])
            if ok.sum() > 2 else None),
        "identifiable_fraction": float(ok.mean()),
        "stage_seconds": dict(stage.seconds)}
    return AdviRun(
        metrics=metrics,
        joint={"nn_mean": _host(joint.nn_mean),
               "nn_std": _host(joint.nn_std), "beta_mean": beta_mean,
               "beta_std": _host(joint.beta_std),
               "log_sigma_mean": _host(joint.log_sigma_mean),
               "elbo_final": elbo_final},
        test={"beta_mean": b_mean, "beta_std": b_std,
              "log_sigma_mean": _host(post.log_sigma_mean),
              "elbo_final": _host(post.elbo_trace[:, -1])},
        joint_meta={"script": "exp_advi", "restarts": int(n_restarts),
                    "steps": joint_steps},
        test_meta={"script": "exp_advi", "model_index": int(best)})


def write_outputs(out: Path, run: AdviRun) -> None:
    """``exp_advi_metrics.json``, ``advi_cude_results.npz`` and
    ``advi_test_posteriors.npz`` (with their JSON sidecars) into ``out``,
    in the JAX script's formats."""
    (out / "exp_advi_metrics.json").write_text(json.dumps(run.metrics,
                                                          indent=2))
    save_checkpoint(out / "advi_cude_results.npz", run.joint,
                    metadata=run.joint_meta)
    save_checkpoint(out / "advi_test_posteriors.npz", run.test,
                    metadata=run.test_meta)
