"""The port's exp_advi at full depth on the JAX package's own draws, held to
JAX's outputs on them.

    python scripts/advi_reference.py --dump build/advi_jax_draws.npz   # JAX, CPU
    python scripts/advi_same_draws.py --draws build/advi_jax_draws.npz \
        [--device cuda] [--out FILE]

Runs ``advi_pipeline.run_exp_advi`` (25 restarts × 2,000 steps on the 57
fit subjects, 35 test subjects × 1,500 steps, the profile at 2,000 points)
on the normals that ``experiments/exp_advi.py``'s keys give in the JAX
package, and prints one JSON object (also written to ``--out``): for each
output array its largest absolute difference from JAX's on the same draws
and where, for each metric the port's value beside JAX's, the stage
seconds, the card's name and power limit (``nvidia-smi``) and the
kernels' launches.  The two packages then differ only in their float32
arithmetic (K2's sums take another order than JAX's autograd), so this
separates the port from the draws: the card's own run (``chip_smoke.py``)
draws from a ``torch.Generator`` and is held to JAX's spread over keys.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from conditional_ude_tpu_torch import advi_pipeline  # noqa: E402
from conditional_ude_tpu_torch.__main__ import launches  # noqa: E402


def largest_diff(got: np.ndarray, want: np.ndarray) -> dict:
    err = np.abs(np.asarray(got, np.float64) - want)
    at = np.unravel_index(int(np.argmax(err)), err.shape)
    return {"max_abs": float(err[at]), "at": [int(i) for i in at],
            "jax": float(want[at]), "max_rel": float(np.max(
                err / np.maximum(np.abs(want), 1e-30)))}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--draws", type=Path, required=True,
                   help="scripts/advi_reference.py --dump's file")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA card is visible")
    z = np.load(args.draws)
    t0 = time.perf_counter()
    run = advi_pipeline.run_exp_advi(
        dev, REPO / "artifacts",
        draws=(z["joint_normals"], z["test_normals"]))
    report = {"device": str(dev), "seconds": time.perf_counter() - t0,
              "stage_seconds": run.metrics["stage_seconds"],
              "launches": launches()}
    if dev.type == "cuda":
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    want = json.loads(str(z["metrics"]))
    report["metrics"] = {k: {"port": run.metrics[k], "jax": v}
                         for k, v in want.items()}
    report["arrays"] = {
        f"{stage}_{k}": largest_diff(v, z[f"{stage}_{k}"])
        for stage, arrays in (("joint", run.joint), ("test", run.test))
        for k, v in arrays.items()}
    text = json.dumps(report)
    if args.out is not None:
        args.out.write_text(text)
    print(text)


if __name__ == "__main__":
    main()
