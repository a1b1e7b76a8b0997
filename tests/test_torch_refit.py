"""PyTorch port: the (β, σ) re-estimation of the pipeline fits the training
and the test subjects apart, as the JAX experiment scripts do
(``experiments/common.py:227-228``, ``experiments/exp02_xl.py:75-83``).

One batch of all 117 subjects is not the same fit in float32 on the CPU: a
row's objective is the same in any batch, but its gradient is not, so the
L-BFGS paths part (after 10 steps the test rows' β differ by up to 0.2
relative).  Held here on the committed exp02 candidates at ``ITERS``
L-BFGS steps: the rows that ``run_frozen_pipeline`` returns equal a fit of
the 82 training subjects alone and of the 35 test subjects alone, bit for
bit, at the bounds the pipeline chose.  Run as a script,

    python tests/test_torch_refit.py [--device cuda] [iters ...]

it prints, as JSON, how far the test rows of one batch of all 117 subjects
are from the fit of the 35 alone (largest relative difference of β, σ and
the objective) after each number of L-BFGS steps, on that device.
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":      # pytest's conftest does this for the tests
    sys.path.insert(0, str(ROOT))

from conditional_ude_tpu_torch.convert import load_candidates  # noqa: E402
from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz  # noqa: E402
from conditional_ude_tpu_torch.fit.train import fit_betas_sigma  # noqa: E402
from conditional_ude_tpu_torch.models import cpeptide as cp  # noqa: E402
from conditional_ude_tpu_torch.nn import chain  # noqa: E402
from conditional_ude_tpu_torch.pipeline import run_frozen_pipeline  # noqa: E402

ITERS = 10
CANDIDATES = 2


def _cohort(split, device):
    return cp.build_cohort(split.glucose, split.timepoints, split.cpeptide,
                           split.ages, split.t2dm, device=device)


def _alone(net, split, bounds, iters, device="cpu"):
    """``fit_betas_sigma`` from β = −1 on ``split`` alone: β, σ, objective."""
    return fit_betas_sigma(cp.CPeptideModel(chain(4, 2)), net,
                           _cohort(split, device), initial_beta=-1.0,
                           bounds=tuple(map(float, bounds)),
                           lbfgs_iters=iters)


def test_test_subjects_refit_as_alone():
    port = run_frozen_pipeline("cpu", ROOT / "artifacts", lbfgs_iters=ITERS,
                               candidates=CANDIDATES, profile_steps=0,
                               census_steps=0)
    train, test = load_npz(ROOT / "artifacts" / "ohashi.npz")
    nn = load_candidates(ROOT / "artifacts" / "cude_neural_parameters.npz")[0]
    net = torch.as_tensor(nn[port.best])
    assert port.b_test.shape == port.s_test.shape == (len(test.ages),)
    for split, b, s in ((train, port.b_train, port.s_train),
                        (test, port.b_test, port.s_test)):
        ref_b, ref_s, _ = _alone(net, split, port.bounds, ITERS)
        np.testing.assert_array_equal(b, ref_b.numpy())
        np.testing.assert_array_equal(s, ref_s.numpy())


if __name__ == "__main__":
    import argparse
    import json

    from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint

    parser = argparse.ArgumentParser(description="one batch of 117 "
                                     "against the 35 test subjects alone")
    parser.add_argument("--device", default="cpu")
    parser.add_argument("iters", type=int, nargs="*", default=[10, 30, 100])
    args = parser.parse_args()
    art = ROOT / "artifacts"
    train, test = load_npz(art / "ohashi.npz")
    nn, betas, _, _ = load_candidates(art / "cude_neural_parameters.npz")
    best = load_checkpoint(art / "cude_fit.npz")[1]["best_model_index"]
    bb = betas[best].ravel()
    bounds = (bb.min() - 0.1 * abs(bb.min()), bb.max() + 0.1 * abs(bb.max()))
    net = torch.as_tensor(nn[best], device=args.device)
    both = OhashiSplit.concatenate(train, test)
    n = len(train.ages)
    out = {}
    for iters in args.iters:
        one = _alone(net, both, bounds, iters, args.device)
        out[iters] = {
            k: float(((a[n:] - r).abs() / r.abs().clamp_min(1e-30)).max())
            for k, a, r in zip(("beta", "sigma", "objective"), one,
                               _alone(net, test, bounds, iters, args.device))}
    name = torch.cuda.get_device_name(0) if args.device.startswith("cuda") \
        else "cpu"
    print(json.dumps({"device": name,
                      "largest relative difference, one batch of 117 "
                      "against the 35 alone, by L-BFGS steps": out}))
