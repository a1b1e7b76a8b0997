"""How torch's intra-op threads slow the port's small CPU work when several
processes share the cores, as tier-1's six test workers do.

Each process runs ``ablation.train_fraction`` (the less-data ablation's
training) at exp05's smoke size (100 designs, 2 restarts, 20 Adam and 20
L-BFGS steps) on all 82 training subjects, at a given number of torch
threads, and reports its seconds.  The processes start together.

    python scripts/thread_probe.py --procs 1 --threads 8
    python scripts/thread_probe.py --procs 6 --threads 8
    python scripts/thread_probe.py --procs 6 --threads 1

Prints one JSON line: the processes, the threads and each process's
seconds.  CPU only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SMOKE = dict(initial_guesses=100, selected_initials=2, adam_iters=20,
             lbfgs_iters=20)
SEED = 270523


def one(threads: int) -> float:
    """One training at ``threads`` threads; its seconds."""
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from conditional_ude_tpu_torch import ablation
    from conditional_ude_tpu_torch.data.ohashi import load_npz
    from conditional_ude_tpu_torch.fit.train import TrainConfig

    torch.set_num_threads(threads)
    train, _ = load_npz(REPO / "artifacts" / "ohashi.npz")
    t0 = time.perf_counter()
    ablation.train_fraction("cpu", train, np.arange(len(train.ages)), SEED,
                            TrainConfig(**SMOKE))
    return time.perf_counter() - t0


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--procs", type=int, default=6)
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.one:
        print(one(args.threads))
        return
    procs = [subprocess.Popen([sys.executable, __file__, "--one",
                               "--threads", str(args.threads)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(args.procs)]
    seconds = [float(proc.communicate()[0].strip().splitlines()[-1])
               for proc in procs]
    print(json.dumps({"procs": args.procs, "threads": args.threads,
                      "seconds": seconds}))


if __name__ == "__main__":
    main()
