"""Count and time the L-BFGS evaluations of the symbolic refits.

    python scripts/fit_probe.py [--device cuda]

Runs the four (θ, σ) fits of exp03, exp04 and exp_symreg_production (k and
b on the 117 Ohashi subjects and on the 20 of Fujita, 1000 L-BFGS steps) on
the device and prints one JSON line each: the value+grad evaluations, the
seconds, the milliseconds an evaluation, and the rows' iteration counts
(the batched L-BFGS stops a row at a fixed point or a short orbit, so a
fit takes as long as its last row).  The first line is the card's name and
power limit.
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

from conditional_ude_tpu_torch import symbolic_pipeline as sp  # noqa: E402
from conditional_ude_tpu_torch.models import symbolic  # noqa: E402
from conditional_ude_tpu_torch.ops import lbfgs  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    dev = torch.device(p.parse_args().device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    calls, iters = [0], {}
    value_and_grad, minimize = lbfgs._value_and_grad, lbfgs.lbfgs_minimize

    def counted(fun, x):
        calls[0] += 1
        return value_and_grad(fun, x)

    def recorded(*args, **kwargs):
        res = minimize(*args, **kwargs)
        iters["rows"] = res.num_iters.cpu().numpy()
        return res

    lbfgs._value_and_grad = counted
    symbolic.lbfgs_minimize = recorded
    art = REPO / "artifacts"
    for name, cohort, fit in (
            ("ohashi (k, sigma)", sp._ohashi(art, dev)[1], symbolic.fit_k_sigma),
            ("ohashi (b, sigma)", sp._ohashi(art, dev)[1], symbolic.fit_b_sigma),
            ("fujita (k, sigma)", sp._fujita(art, dev), symbolic.fit_k_sigma),
            ("fujita (b, sigma)", sp._fujita(art, dev), symbolic.fit_b_sigma)):
        kw = {"solver_max_steps": 512} if name.startswith("fujita") else {}
        calls[0] = 0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fit(cohort, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sec = time.perf_counter() - t0
        rows = iters["rows"]
        print(json.dumps({
            "fit": name, "evaluations": calls[0], "seconds": sec,
            "ms_per_evaluation": 1e3 * sec / calls[0],
            "iterations_max": int(rows.max()),
            "iterations_median": float(np.median(rows)),
            "rows_at_1000": int((rows >= 1000).sum()),
            "slowest_rows": np.argsort(-rows, kind="stable")[:3].tolist()}),
            flush=True)


if __name__ == "__main__":
    main()
