"""The JAX package's ADVI experiment on the CPU: the yardstick of the port's
exp_advi.

    python scripts/advi_reference.py [--keys 10] [--only joint test]
        [--out FILE]
    python scripts/advi_reference.py --dump FILE.npz

Runs the body of ``experiments/exp_advi.py`` (sections 1 and 2) with the
JAX package's functions on the cohorts of ``artifacts/ohashi.npz`` and the
committed candidates (``artifacts/cude_neural_parameters.npz``), first at
the experiment script's own keys and then at ``--keys`` further keys, and
prints one JSON object (also written to ``--out``):

* ``joint`` (section 1): the joint posterior of all 25 candidates on their
  57 fit subjects, 2,000 steps, 4 samples, RK4 at 4 substeps;
  ``joint_elbo_final_best`` and ``joint_beta_pointfit_corr_mean``;
* ``test`` (section 2): the β posteriors of the 35 test subjects on the
  selected candidate (``results/exp02_metrics.json``), 1,500 steps, 8
  samples, RK4 at 4 substeps, and the profile cross-check (2,000 grid
  points on [-6, 2], RK4 at 8 substeps); ``test_spearman_first_phase``,
  ``test_beta_std_median``, ``advi_sd_vs_profile_ci_corr`` and
  ``identifiable_fraction``, and each subject's ``beta_mean`` and
  ``beta_std``.

Each stage reports ``reproduction`` (its metrics at the script's own key
beside the committed ``results/exp_advi_metrics.json``, which came from a
TPU; the test stage also its largest |Δβ_mean| from
``artifacts/advi_test_posteriors.npz``), ``spread`` (each metric's min,
max, mean and sd over all the keys' runs) and, for the test stage,
``per_subject`` (each subject's least and greatest ``beta_mean`` and
``beta_std`` over the runs).  The port's full run on the card is held to
the spread, since the two packages' random streams differ.

The script's keys are 270523 (joint) and 7 (test); the further keys are
1000 + j (joint) and 2000 + j (test) for j = 1..keys.  On 8 CPU cores a
joint run takes about 2.5 min and a test run about 12 s (``seconds``); run
the two stages with ``--only`` in two processes.

``--dump FILE.npz`` instead runs both stages once at the script's keys and
writes the normals they drew, in the port's layout (``joint_normals``
``[2000, 25, 4, 95]``, ``test_normals`` ``[1500, 35, 8, 2]``, split as
``conditional_ude_tpu/fit/advi.py`` splits its keys), with their outputs
(``joint_*``, ``test_*``: the arrays of ``advi_cude_results.npz`` and
``advi_test_posteriors.npz``) and metrics (``metrics``, JSON).
``scripts/advi_same_draws.py`` runs the port on those normals (about 80 MB).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from conditional_ude_tpu.analysis import (  # noqa: E402
    cohort_beta_profiles,
    find_confidence_intervals,
)
from conditional_ude_tpu.data.ohashi import load_npz  # noqa: E402
from conditional_ude_tpu.fit.advi import advi_betas, advi_joint  # noqa: E402
from conditional_ude_tpu.models.cpeptide import (  # noqa: E402
    CPeptideModel,
    build_cohort,
)
from conditional_ude_tpu.nn import chain  # noqa: E402
from conditional_ude_tpu.utils.stats import spearman  # noqa: E402

ART = REPO / "artifacts"
RESULTS = REPO / "results"
JOINT_KEY, TEST_KEY = 270523, 7
JOINT_STEPS, TEST_STEPS, PROFILE_STEPS = 2000, 1500, 2000


def _cohort(split):
    return build_cohort(split.glucose, split.timepoints, split.cpeptide,
                        split.ages, split.t2dm)


class Body:
    """``experiments/exp_advi.py``'s model, cohorts and candidates, and
    its two stages as functions of a key."""

    def __init__(self):
        train, self.test = load_npz(ART / "ohashi.npz")
        self.model = CPeptideModel(kind="conditional",
                                   net=chain(4, 2, "tanh", input_dims=2))
        z = np.load(ART / "cude_neural_parameters.npz")
        candidates, betas = z["nn_params"], z["betas"]
        self.cohort_fit = _cohort(train.subset(np.asarray(z["idx_fit"])))
        self.cohort_test = _cohort(self.test)
        self.nn0 = jnp.asarray(candidates, jnp.float32)
        self.b0 = jnp.asarray(betas[:, :self.cohort_fit.n, 0], jnp.float32)
        best = json.loads((RESULTS / "exp02_metrics.json").read_text())[
            "best_model_index"]
        self.nn_best = jnp.asarray(candidates[best], jnp.float32)

        def one(nn_init, beta_init, k):
            return advi_joint(self.model, self.cohort_fit, nn_init, k,
                              init_betas=beta_init, steps=JOINT_STEPS,
                              n_samples=4, solver="rk4", substeps=4)

        self._joint = jax.jit(lambda key: jax.vmap(one)(
            self.nn0, self.b0, jax.random.split(key, self.nn0.shape[0])))
        self._test = jax.jit(lambda key: advi_betas(
            self.model, self.nn_best, self.cohort_test, key,
            initial_beta=-1.0, steps=TEST_STEPS, solver="rk4", substeps=4))

    def joint(self, key: int) -> dict:
        res = self._joint(jax.random.key(key))
        b_mean, b0 = np.asarray(res.beta_mean), np.asarray(self.b0)
        corr = [float(np.corrcoef(b_mean[r], b0[r])[0, 1])
                for r in range(b0.shape[0])]
        return {"joint_elbo_final_best": float(np.max(np.asarray(
                    res.elbo_trace[:, -1]))),
                "joint_beta_pointfit_corr_mean": float(np.mean(corr))}

    def test_stage(self, key: int) -> tuple[dict, dict]:
        post = self._test(jax.random.key(key))
        b_mean, b_std = np.asarray(post.beta_mean), np.asarray(post.beta_std)
        prof = cohort_beta_profiles(self.model, self.nn_best,
                                    self.cohort_test,
                                    sigmas=jnp.exp(post.log_sigma_mean),
                                    lower=-6.0, upper=2.0,
                                    steps=PROFILE_STEPS)
        ci = find_confidence_intervals(prof, "cantelli95")
        half = 0.5 * (np.asarray(ci.upper) - np.asarray(ci.lower))
        ok = np.isfinite(half)
        metrics = {
            "test_spearman_first_phase": spearman(b_mean,
                                                  self.test.first_phase),
            "test_beta_std_median": float(np.median(b_std)),
            "advi_sd_vs_profile_ci_corr": (
                float(np.corrcoef(b_std[ok], half[ok])[0, 1])
                if ok.sum() > 2 else None),
            "identifiable_fraction": float(ok.mean())}
        return metrics, {"beta_mean": b_mean, "beta_std": b_std}


def normals(key, rows: int, steps: int, shape) -> np.ndarray:
    """The normals of ``rows`` ADVI problems whose keys are
    ``split(key, rows)``, each drawing ``shape`` a step from
    ``split(k, steps)``: ``[steps, rows, *shape]``."""
    def one(k):
        return jax.vmap(lambda ks: jax.random.normal(ks, shape, jnp.float32))(
            jax.random.split(k, steps))
    eps = jax.vmap(one)(jax.random.split(key, rows))
    return np.asarray(eps).transpose(1, 0, *range(2, eps.ndim))


def dump(body: Body, path: Path) -> dict:
    """Both stages at the script's keys: their normals, outputs and
    metrics into ``path``; the metrics returned."""
    joint = body._joint(jax.random.key(JOINT_KEY))
    post = body._test(jax.random.key(TEST_KEY))
    metrics = {**body.joint(JOINT_KEY), **body.test_stage(TEST_KEY)[0]}
    arrays = {f"joint_{k}": np.asarray(getattr(joint, k)) for k in (
        "nn_mean", "nn_std", "beta_mean", "beta_std", "log_sigma_mean")}
    arrays["joint_elbo_final"] = np.asarray(joint.elbo_trace[:, -1])
    arrays.update({f"test_{k}": np.asarray(getattr(post, k)) for k in (
        "beta_mean", "beta_std", "log_sigma_mean")})
    arrays["test_elbo_final"] = np.asarray(post.elbo_trace[:, -1])
    d = body.nn0.shape[1] + body.cohort_fit.n + 1
    np.savez(path, **arrays, metrics=np.asarray(json.dumps(metrics)),
             joint_normals=normals(jax.random.key(JOINT_KEY),
                                   body.nn0.shape[0], JOINT_STEPS, (4, d)),
             test_normals=normals(jax.random.key(TEST_KEY),
                                  body.cohort_test.n, TEST_STEPS, (8, 2)))
    return metrics


def spread(runs: list[dict]) -> dict[str, dict[str, float]]:
    out = {}
    for k in runs[0]:
        v = np.asarray([r[k] for r in runs], np.float64)
        out[k] = {"min": float(v.min()), "max": float(v.max()),
                  "mean": float(v.mean()), "sd": float(v.std(ddof=1))
                  if len(v) > 1 else 0.0}
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--keys", type=int, default=10,
                   help="keys beyond the script's own")
    p.add_argument("--only", nargs="+", default=["joint", "test"],
                   choices=["joint", "test"])
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--dump", type=Path, default=None,
                   help="write the script's keys' normals, outputs and "
                        "metrics to this .npz and stop")
    args = p.parse_args()
    committed = json.loads((RESULTS / "exp_advi_metrics.json").read_text())
    body = Body()
    if args.dump is not None:
        print(json.dumps(dump(body, args.dump)))
        return
    report = {"keys": args.keys}

    def write():
        if args.out is not None:
            args.out.write_text(json.dumps(report, indent=1))

    for stage in args.only:
        own = JOINT_KEY if stage == "joint" else TEST_KEY
        base = 1000 if stage == "joint" else 2000
        runs, subjects, seconds = [], [], []
        for key in [own, *(base + j for j in range(1, args.keys + 1))]:
            t0 = time.perf_counter()
            if stage == "joint":
                runs.append(body.joint(key))
            else:
                metrics, per = body.test_stage(key)
                runs.append(metrics)
                subjects.append(per)
            seconds.append(time.perf_counter() - t0)
            print(json.dumps({stage: key, "seconds": seconds[-1],
                              **runs[-1]}), file=sys.stderr, flush=True)
        out = {"seconds": seconds,
               "reproduction": {k: {"jax_cpu": v,
                                    "committed": committed.get(k)}
                                for k, v in runs[0].items()},
               "spread": spread(runs), "runs": runs}
        if stage == "test":
            ref = np.load(ART / "advi_test_posteriors.npz")
            out["reproduction"]["max_abs_beta_mean_diff"] = float(np.max(
                np.abs(subjects[0]["beta_mean"] - ref["beta_mean"])))
            out["per_subject"] = {
                k: {"min": np.min([s[k] for s in subjects], 0).tolist(),
                    "max": np.max([s[k] for s in subjects], 0).tolist()}
                for k in ("beta_mean", "beta_std")}
        report[stage] = out
        write()
    print(json.dumps(report))
    write()


if __name__ == "__main__":
    main()
