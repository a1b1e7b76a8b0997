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
they are passed in (``draws``).

3. The cross-check against the reference repository's 25 ADVI runs
   (:func:`reference_crosscheck`; the entry point reads them from
   ``source_data/advi`` beside ``--data-dir`` with
   ``data/jld2.py::load_reference_advi``, and says it skipped the section
   where they are missing, as the JAX script does).  Each run's 57
   training subjects are a Julia-drawn subset of the 82, which cannot be
   paired subject by subject, so at each run's posterior-mean network this
   package's own β posteriors of all 82 training subjects are taken (800
   steps, 8 samples, RK4 at 4 substeps, one K2 launch a step; a
   ``torch.Generator`` seeded 100 + r, where the JAX script takes
   ``key(100 + r)``) and compared with the run's β's by quantiles
   (:func:`crosscheck_statistics`).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from conditional_ude_tpu_torch.analysis.profiles import (
    cohort_beta_profiles,
    find_confidence_intervals,
)
from conditional_ude_tpu_torch.convert import load_candidates, params_from_jax
from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
from conditional_ude_tpu_torch.fit import advi
from conditional_ude_tpu_torch.models.cpeptide import CPeptideModel
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.pipeline import (
    SEED,
    SMOKE_SUBJECTS,
    _cohort,
    _Stages,
    first_subjects,
)
from conditional_ude_tpu_torch.utils.checkpoint import save_checkpoint
from conditional_ude_tpu_torch.utils.stats import spearman

TEST_SEED = 7           # the JAX script's key of the test stage
REFERENCE_SEED = 100    # run r's draws: REFERENCE_SEED + r
REFERENCE_STEPS = 800
SUBSTEPS = 4            # RK4 substeps of both ELBOs
JOINT_SAMPLES = 4
SMOKE_RESTARTS = 2
SMOKE_STEPS = (50, 50, 200)   # --smoke: joint, test steps; profile points


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
                 draws=None, smoke: bool = False,
                 best: int | None = None) -> AdviRun:
    """exp_advi on ``device``: every committed candidate (the first
    ``restarts``) on its fit subjects (the first ``fit_subjects``), then
    the test stage on candidate ``best`` (exp02's selected one, from
    ``results/exp02_metrics.json`` beside ``artifacts_dir``, unless
    given).  ``draws = (joint normals [joint_steps, R, 4, P + N + 1], test
    normals [test_steps, 35, 8, 2])`` replace the generators'.

    ``smoke`` runs the JAX script's ``--smoke`` on a clean checkout, whose
    smoke candidates are missing (``experiments/exp_advi.py:50-58,75-84,
    146``): the first 8 subjects of each split, two Glorot networks from a
    generator seeded 0 (the script's ``init_batch(key(0), 2)``) at β = −1
    on every training subject, 50 joint and 50 test steps and a profile of
    200 points."""
    dev = torch.device(device)
    artifacts_dir = Path(artifacts_dir)
    model = CPeptideModel(chain(4, 2))
    train, test = load_npz(artifacts_dir / "ohashi.npz")
    if smoke:
        train, test = first_subjects(train, test, SMOKE_SUBJECTS)
        nn_all = model.net.init_batch(
            SMOKE_RESTARTS, torch.Generator().manual_seed(0)).to(dev)
        betas_cand = np.full((SMOKE_RESTARTS, len(train.ages), 1), -1.0,
                             np.float32)
        idx_fit = np.arange(len(train.ages))
        restarts = min(restarts or SMOKE_RESTARTS, SMOKE_RESTARTS)
        joint_steps, test_steps, profile_steps = SMOKE_STEPS
    else:
        candidates, betas_cand, idx_fit, _ = load_candidates(
            artifacts_dir / "cude_neural_parameters.npz")
        nn_all = params_from_jax(candidates, model.net, dev)
    if fit_subjects is not None:
        idx_fit = idx_fit[:fit_subjects]
    n_restarts = nn_all.shape[0] if restarts is None else min(
        restarts, nn_all.shape[0])
    if n_restarts < 1:
        raise ValueError(f"exp_advi needs at least one restart, got "
                         f"{restarts}")
    cohort_fit = _cohort(train.subset(idx_fit), dev)
    cohort_test = _cohort(test, dev)
    joint_normals, test_normals = (None, None) if draws is None else draws
    stage = _Stages(dev)

    # -- 1. the joint posterior of every restart ------------------------------
    nn0 = nn_all[:n_restarts]
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
    if best is None:
        best = best_model_index(artifacts_dir.parent / "results")
    best = min(best, nn_all.shape[0] - 1)
    nn_best = nn_all[best]
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


def reference_crosscheck(device: torch.device | str, ref: dict,
                         train: OhashiSplit,
                         steps: int = REFERENCE_STEPS) -> dict:
    """Section 3 at the runs ``ref`` (``load_reference_advi``'s dict:
    ``parameters[R, P]`` in this package's layout, ``betas[R, N_fit]``):
    the β posterior means of ``train``'s subjects at each run's network,
    then :func:`crosscheck_statistics` under the JAX script's keys."""
    if (ref["width"], ref["depth"]) != (4, 2):
        raise ValueError("reference ADVI architecture drifted: width "
                         f"{ref['width']}, depth {ref['depth']}")
    dev = torch.device(device)
    model = CPeptideModel(chain(4, 2))
    cohort = _cohort(train, dev)
    t0 = time.perf_counter()
    ours = []
    for r in range(ref["parameters"].shape[0]):
        post = advi.advi_betas(
            model, params_from_jax(ref["parameters"][r], model.net, dev),
            cohort, initial_beta=-1.0, steps=steps,
            generator=torch.Generator().manual_seed(REFERENCE_SEED + r),
            substeps=SUBSTEPS)
        ours.append(_host(post.beta_mean))
    seconds = time.perf_counter() - t0
    return crosscheck_statistics(np.stack(ours), np.asarray(ref["betas"]),
                                 seconds)


def crosscheck_statistics(ours: np.ndarray, theirs: np.ndarray,
                          seconds: float) -> dict:
    """Each run's β means (``ours[R, N]``) against the reference's
    (``theirs[R, M]``): the ``M`` mid-quantiles of ours against the
    reference's sorted values, their correlation, mean offset and RMSE
    after the offset, and each side's range of run means
    (``experiments/exp_advi.py:207-238``).  At these weights β is weakly
    identified, so each package's means sit near its own prior centre, a
    constant offset a run, while the shape of the distribution follows the
    shared likelihood: the quantile correlation is the statistic that
    compares the two."""
    qs = (np.arange(theirs.shape[1]) + 0.5) / theirs.shape[1]
    qcorr, qoff, qrmse_c = [], [], []
    for r in range(theirs.shape[0]):
        our_q = np.quantile(ours[r], qs)
        ref_q = np.sort(theirs[r])
        qcorr.append(float(np.corrcoef(our_q, ref_q)[0, 1]))
        off = float(np.mean(our_q - ref_q))
        qoff.append(off)
        qrmse_c.append(float(np.sqrt(np.mean((our_q - ref_q - off) ** 2))))
    return {
        "n_files": int(theirs.shape[0]),
        "seconds": seconds,
        "quantile_corr_per_restart_median": float(np.median(qcorr)),
        "quantile_corr_per_restart_min": float(np.min(qcorr)),
        "quantile_offset_median": float(np.median(qoff)),
        "quantile_rmse_centered_median": float(np.median(qrmse_c)),
        "beta_mean_range_ref": [float(theirs.mean(1).min()),
                                float(theirs.mean(1).max())],
        "beta_mean_range_ours": [float(ours.mean(1).min()),
                                 float(ours.mean(1).max())],
        "note": (
            "weak per-subject likelihood at the reference's ADVI "
            "weights => each stack's variational means center on its "
            "own prior; shape agreement (quantile corr) is the "
            "meaningful round-trip statistic"),
    }


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
