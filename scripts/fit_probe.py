"""Count and time the L-BFGS evaluations of the symbolic refits.

    python scripts/fit_probe.py [--device cuda]

Runs the four (θ, σ) fits of exp03, exp04 and exp_symreg_production (k and
b on the 117 Ohashi subjects and on the 20 of Fujita, 1000 L-BFGS steps) on
the device and prints one JSON line each: the value+grad evaluations, the
seconds, the milliseconds an evaluation, and the rows' iteration counts
(the batched L-BFGS stops a row at a fixed point or a short orbit, so a
fit takes as long as its last row).  The first line is the card's name and
power limit.

``--trace ROW`` also follows one row of the Ohashi (b, σ) fit: its (b, σ)
and objective at every iteration, and the line after that fit's says
where the row ended, whether its last states repeat with a period (the
least p ≤ 512 for which the last 3p states repeat bit for bit; the
L-BFGS recognises orbits up to ``ops/lbfgs.py::CYCLE``) and how far its
objective fell over its last 100 iterations.
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
    p.add_argument("--trace", type=int, default=None,
                   help="a row of the Ohashi (b, sigma) fit to follow")
    args = p.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    calls, iters, trace = [0], {}, []
    value_and_grad, minimize = lbfgs._value_and_grad, lbfgs.lbfgs_minimize
    orbit_end = lbfgs._orbit_end

    def traced(s, past, active, it, max_iters):
        if args.trace is not None and tracing[0]:
            trace.append(torch.cat([s.x[args.trace], s.f[args.trace, None]])
                         .cpu().numpy())
        return orbit_end(s, past, active, it, max_iters)

    def counted(fun, x):
        calls[0] += 1
        return value_and_grad(fun, x)

    def recorded(*args, **kwargs):
        res = minimize(*args, **kwargs)
        iters["rows"] = res.num_iters.cpu().numpy()
        return res

    tracing = [False]
    lbfgs._value_and_grad = counted
    lbfgs._orbit_end = traced
    symbolic.lbfgs_minimize = recorded
    art = REPO / "artifacts"
    for name, cohort, fit in (
            ("ohashi (k, sigma)", sp._ohashi(art, dev)[1], symbolic.fit_k_sigma),
            ("ohashi (b, sigma)", sp._ohashi(art, dev)[1], symbolic.fit_b_sigma),
            ("fujita (k, sigma)", sp._fujita(art, dev), symbolic.fit_k_sigma),
            ("fujita (b, sigma)", sp._fujita(art, dev), symbolic.fit_b_sigma)):
        kw = {"solver_max_steps": 512} if name.startswith("fujita") else {}
        calls[0] = 0
        tracing[0] = name == "ohashi (b, sigma)"
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
        if tracing[0] and trace:
            print(json.dumps(row_report(args.trace, np.asarray(trace),
                                        int(rows[args.trace]))), flush=True)
            tracing[0] = False


def row_report(row: int, states: np.ndarray, iterations: int) -> dict:
    """Where a traced row ended (``states[k] = (b, σ, f)`` before iteration
    k, the last after the loop ended), whether its last states repeat, and
    how far its objective fell over its last 100 iterations."""
    bits = states.view(np.int32)
    period = next((p for p in range(1, 513) if len(bits) >= 3 * p + 1
                   and np.array_equal(bits[-2 * p:], bits[-3 * p:-p])),
                  None)
    tail = states[-101:, -1]
    return {"row": row, "iterations": iterations, "b": float(states[-1, 0]),
            "sigma": float(states[-1, 1]), "objective": float(states[-1, 2]),
            "period_of_last_states": period,
            "objective_fall_last_100": float(tail[0] - tail[-1]),
            "distinct_states_last_100": int(len(np.unique(
                bits[-100:], axis=0)))}


if __name__ == "__main__":
    main()
