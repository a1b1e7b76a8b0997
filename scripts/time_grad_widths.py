"""Time the value+gradient kernels K2 and K5 of a tree of the PyTorch port
on one NVIDIA card, at the widths the refinement of joint training gives
them:

    python3 scripts/time_grad_widths.py                # this repository
    python3 scripts/time_grad_widths.py --root DIR     # the package in DIR

``--root`` imports ``conditional_ude_tpu_torch`` from DIR (for example an
earlier commit unpacked with ``git archive``), which builds its own
kernels.  To compare two trees, run them one after another on one card,
the first again last.

For both bodies (2 and 3 inputs), on Glorot designs with Latin-hypercube
β's and the exp02 fit split (57 subjects, real ages), it times K2 at
``RESTARTS`` × 57 lanes (1,425 is the refinement of a training with 25
restarts, 5,472 the enlarged multi-start's default of 96, 131,328 the
2,304 restarts at which the refinement switches to K5) and K5 at 2,304 ×
57.  ``call`` is CUDA events around back-to-back calls of the Python
wrapper (the ``ms`` of ``chip_smoke.py``), ``device`` one replay of a CUDA
graph of the same calls (its ``device_ms``), so the host's work is out of
it.  It checks nothing: ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the kernels to their plain versions.  The last line is a JSON object
of the times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

RESTARTS = (25, 96, 225, 450, 900, 1152, 2304)   # × 57 lanes for K2
K5_RESTARTS = 2304


def call_ms(fn, reps: int) -> float:
    """Mean ms per call by CUDA events around ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean ms per call of one replay of a CUDA graph of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[1],
                        help="the tree whose package is timed")
    args = parser.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from conditional_ude_tpu_torch.data.ohashi import load_npz
    from conditional_ude_tpu_torch.models.cpeptide import build_cohort
    from conditional_ude_tpu_torch.nn import chain
    from conditional_ude_tpu_torch.ops import lane_grad, population_grad
    from conditional_ude_tpu_torch.pipeline import SEED
    from conditional_ude_tpu_torch.utils.stats import (
        latin_hypercube,
        stratified_split,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card; none is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{card}; package from {root}", flush=True)
    dev = torch.device("cuda", 0)
    train, _ = load_npz(root / "artifacts" / "ohashi.npz")
    idx_fit, _ = stratified_split(np.random.default_rng(SEED), train.types,
                                  0.7)
    fit = train.subset(idx_fit)
    cohort = build_cohort(fit.glucose, fit.timepoints, fit.cpeptide,
                          fit.ages, fit.t2dm, dev)
    tp = tuple(float(t) for t in cohort.timepoints)
    rng = np.random.default_rng(2705)
    f32 = dict(dtype=torch.float32, device=dev)
    times = {}

    def timed(name, fn, reps):
        ms = (call_ms(fn, reps), device_ms(fn, reps))
        times[name] = ms
        print(f"[time] {name}: call {ms[0]:.4f} ms, device {ms[1]:.4f} ms  "
              f"[{card}]", flush=True)

    for d in (2, 3):
        net = chain(4, 2, input_dims=d)
        sfx = "c" if d == 3 else ""
        cohort_args = (cohort.glucose, cohort.cpeptide,
                       cohort.kinetics(with_age=d == 3), tp)

        def designs(g):
            parts = []
            for fi, fo in net.layer_dims:
                b = np.sqrt(6.0 / (fi + fo))
                parts += [rng.uniform(-b, b, (g, fo * fi)), np.zeros((g, fo))]
            lhs = latin_hypercube(rng, g, cohort.n, -2.0, 0.0)
            return (torch.as_tensor(np.concatenate(parts, axis=1), **f32),
                    torch.as_tensor(lhs, **f32), *cohort_args)

        for r in RESTARTS:
            a = designs(r)
            timed(f"K2{sfx} at {r} x {cohort.n} ({r * cohort.n} lanes)",
                  lambda: lane_grad.lane_sse_and_grad(net, *a, 8),
                  50 if r < 500 else 20)
        a = designs(K5_RESTARTS)
        timed(f"K5{sfx} at {K5_RESTARTS} x {cohort.n}",
              lambda: population_grad.restart_sse_and_grad(net, *a, 8), 10)
    print(json.dumps({"card": card, "root": str(root),
                      "ms (call, device)": times}))


if __name__ == "__main__":
    main()
