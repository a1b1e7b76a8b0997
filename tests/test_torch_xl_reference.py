"""The frozen path of the enlarged multi-start (``experiments/exp02_xl.py``
without ``--retrain``) composed from the JAX package's functions on the CPU,
from the committed candidates ``artifacts/cude_neural_parameters_xl.npz`` and
``artifacts/ohashi.npz``: validation selection over the 96 candidates, the
guarded selection (argmin of the summed validation objective within the top
half by train objective), the (β, σ) refit of all subjects on the selected
candidate and of the test subjects on the guarded one.

``results/exp02_xl_metrics.json`` came from a TPU.  This says how far JAX
itself is from it on another machine, which is what the limits of the
port's run on the card (``chip_smoke.py``) rest on.  The run takes about 15
minutes (2,400 L-BFGS rows of 1000 steps), so the test carries the ``slow``
marker and is no part of the fast tier:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_xl_reference.py -m slow -s
    JAX_PLATFORMS=cpu python tests/test_torch_xl_reference.py     # the same, as JSON
"""

import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":      # pytest's conftest does both for the tests
    sys.path.insert(0, str(REPO))
    jax.config.update("jax_platforms", "cpu")

from conditional_ude_tpu.fit import train as jtrain  # noqa: E402
from conditional_ude_tpu.models import cpeptide as jcp  # noqa: E402
from conditional_ude_tpu.nn import chain as jax_chain  # noqa: E402
from conditional_ude_tpu.utils.stats import spearman  # noqa: E402
from conditional_ude_tpu_torch.convert import load_candidates  # noqa: E402
from conditional_ude_tpu_torch.data.ohashi import load_npz  # noqa: E402


def _cohort(s):
    return jcp.build_cohort(s.glucose, s.timepoints, s.cpeptide, s.ages,
                            s.t2dm)


def reference() -> dict:
    train, test = load_npz(REPO / "artifacts" / "ohashi.npz")
    nn, betas, idx_fit, _ = load_candidates(
        REPO / "artifacts" / "cude_neural_parameters_xl.npz")
    val = train.subset(np.setdiff1d(np.arange(len(train.ages)), idx_fit))
    model = jcp.CPeptideModel(kind="conditional",
                              net=jax_chain(4, 2, "tanh", input_dims=2))
    t0 = time.perf_counter()
    objectives = np.asarray(jtrain.evaluate_model(
        model, jnp.asarray(nn), jnp.asarray(betas), _cohort(val),
        lbfgs_iters=1000))
    t1 = time.perf_counter()
    sums = objectives.sum(1)
    best = int(jtrain.select_best(objectives))
    guard = int(np.argmin(sums[:max(1, len(sums) // 2)]))
    n_t = train.timepoints.shape[0]

    def refit(i, cohort):
        bb = betas[i].ravel()
        lb, ub = bb.min() - 0.1 * abs(bb.min()), bb.max() + 0.1 * abs(bb.max())
        b, s, o = (np.asarray(a) for a in jtrain.fit_betas_sigma(
            model, jnp.asarray(nn[i]), cohort, initial_beta=-1.0,
            bounds=(float(lb), float(ub)), lbfgs_iters=1000))
        return b, (o - (n_t / 2) * np.log(s**2)) * (2 * s**2)

    b_train, _ = refit(best, _cohort(train))
    b_test, sse_test = refit(best, _cohort(test))
    _, sse_guard = refit(guard, _cohort(test))
    fin = np.isfinite(sse_guard)
    return {
        "best_model_index": best,
        "guarded_best_model_index": guard,
        "val_sums_best_and_runner_up": np.sort(sums)[:2].tolist(),
        "val_sums_guarded_best_and_runner_up":
            np.sort(sums[:len(sums) // 2])[:2].tolist(),
        "test_sse_mean": float(sse_test.mean()),
        "test_sse_median": float(np.median(sse_test)),
        "spearman_first_phase": spearman(
            np.concatenate([b_train, b_test]),
            np.concatenate([train.first_phase, test.first_phase])),
        "guarded_test_sse_mean": float(sse_guard[fin].mean()),
        "guarded_test_sse_median": float(np.median(sse_guard[fin])),
        "seconds": {"select": t1 - t0, "refits": time.perf_counter() - t1},
    }


@pytest.mark.slow
def test_jax_on_the_cpu_reproduces_the_committed_xl_results():
    """Both selections exactly, the SSE means within 3 %, the Spearman
    correlation within 0.01: the limits the port's run on the card is held
    to."""
    got = reference()
    print(json.dumps(got))
    want = json.loads((REPO / "results" / "exp02_xl_metrics.json").read_text())
    for key in ("best_model_index", "guarded_best_model_index"):
        assert got[key] == want[key]
    for key in ("test_sse_mean", "guarded_test_sse_mean"):
        assert abs(got[key] / want[key] - 1.0) <= 0.03
    assert abs(got["spearman_first_phase"]
               - want["spearman_first_phase"]) <= 0.01


if __name__ == "__main__":
    print(json.dumps(reference()))
