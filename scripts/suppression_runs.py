"""The port's exp_suppression at full depth on one card, through its entry
point, held against the committed results.

    python3 scripts/suppression_runs.py [--out DIR] [--only NAME ...]
        [--budget SECONDS] [--device DEV]

Runs, one after another (``--only`` picks some):

* ``probe``: ms of one value+grad of the suppression loss at the shapes the
  runs give it (the sweep's 125 rows × 37 subjects, the validations' 250 ×
  30, the test stage's 120 × 1), eager and replayed from a CUDA graph
  (``fit.optim.graphed_vg``, which the fits use), the two's largest
  relative difference, and ms of the screens' forward solves.  A
  difference above 1e-5 stops the script before the runs;
* ``default``: the default sweep (5 λ, 10,000 designs, 25 restarts, 2,000
  Adam and 2,000 L-BFGS steps, both validations, the test stage): for
  every λ ≤ 0.1 ``best_correlation_train`` ≥ 0.828 and
  ``best_correlation_valid`` ≥ 0.871 (the committed minima over those λ,
  0.9201 and 0.9675, less 10 %), the test stage finite; λ = 1 reported;
* ``test_only``: ``python -m conditional_ude_tpu_torch --experiment
  exp_suppression --test-only``: restart 4 selected by validation loss and
  5 by validation ρ, test Spearman 0.7568 and 0.8532 each ± 0.01, each
  restart's ``loss_valid`` within twice JAX-CPU's own miss of the
  committed ``results/suppression_sweep.csv`` (``chip_smoke.py``'s
  ``SUPPRESSION_VALID_MISS``, 0.79 % relative) and ``correlation_valid``
  ± 0.01;
* ``sensitivity``: ``--selection-sensitivity``: every selected restart as
  committed (``results/suppression_selection_sensitivity.csv``), every
  test ρ ± 0.01, NaN exactly where committed, the rules' summary equal to
  one recomputed from the rows;
* ``control``: ``chip_smoke.py``'s reduced retrain with no Adam step (on
  ``--device``, the card by default), held to the same JAX spread
  (``SUPPRESSION_SPREAD``): it passes when the spread check fails, i.e.
  the check sees a missing Adam stage.

The entry-point runs share ``--budget`` seconds (default: no limit); a run
still going when it is spent is stopped and recorded with rc None.  Each
run's output goes under DIR (default ``build/suppression``); its
wall-clock, exit code, stage seconds and kernel launches, the card's name
and power limit, and each check go to ``DIR/summary.json``, also the last
line printed.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    SUPPRESSION_REDUCED,
    SUPPRESSION_RHO_TOL,
    SUPPRESSION_TEST_STAGE,
    SUPPRESSION_VALID_MISS,
    card_line,
    check_suppression_spread,
)
from scripts.saem_runs import stderr_record  # noqa: E402

RESULTS = REPO / "results"
ENTRY = [sys.executable, "-m", "conditional_ude_tpu_torch", "--experiment",
         "exp_suppression"]
FLAGS = {"default": [], "test_only": ["--test-only"],
         "sensitivity": ["--selection-sensitivity"]}
GRAPH_RTOL = 1e-5
RETRAIN_MIN = {"best_correlation_train": 0.828,
               "best_correlation_valid": 0.871}


def committed_rows(name: str) -> list[dict]:
    with (RESULTS / name).open() as f:
        return list(csv.DictReader(f))


def check_test_only(metrics: dict, revalidated: list[dict]) -> dict:
    ts = metrics.get("test_stage", {})
    want = {float(r["restart"]): r for r in committed_rows(
        "suppression_sweep.csv") if float(r["lambda"]) == 0.01}
    out = {"selected": [ts.get("selected_restart"),
                        ts.get("best_valid_rho_restart")]}
    out["selected_ok"] = out["selected"] == [
        SUPPRESSION_TEST_STAGE["selected_restart"],
        SUPPRESSION_TEST_STAGE["best_valid_rho_restart"]]
    for key in ("spearman", "spearman_best_valid_rho_restart"):
        got = ts.get(key)
        out[key] = {"port": got, "committed": SUPPRESSION_TEST_STAGE[key],
                    "ok": got is not None and abs(
                        got - SUPPRESSION_TEST_STAGE[key])
                    <= SUPPRESSION_RHO_TOL}
    if len(revalidated) != 25:
        return {**out, "revalidated": len(revalidated), "ok": False}
    loss_miss = [abs(r["loss_valid"] / float(want[k]["loss_valid"]) - 1)
                 for k, r in enumerate(revalidated)]
    rho_miss = [abs(r["correlation_valid"]
                    - float(want[k]["correlation_valid"]))
                for k, r in enumerate(revalidated)]
    out["loss_valid_rel_miss_max"] = max(loss_miss, default=None)
    out["loss_valid_limit"] = 2 * SUPPRESSION_VALID_MISS
    out["correlation_valid_miss_max"] = max(rho_miss, default=None)
    out["correlation_valid_limit"] = SUPPRESSION_RHO_TOL
    out["ok"] = (out["selected_ok"] and out["spearman"]["ok"]
                 and out["spearman_best_valid_rho_restart"]["ok"]
                 and max(loss_miss) <= 2 * SUPPRESSION_VALID_MISS
                 and max(rho_miss) <= SUPPRESSION_RHO_TOL)
    return out


def check_sensitivity(metrics: dict, run_dir: Path) -> dict:
    from conditional_ude_tpu_torch.suppression_pipeline import (
        read_csv,
        sensitivity_block,
    )
    want = read_csv(RESULTS / "suppression_selection_sensitivity.csv")
    path = run_dir / "suppression_selection_sensitivity.csv"
    got = read_csv(path) if path.exists() else []
    block = metrics.get("selection_sensitivity", {})
    out = {"rows": len(got)}
    if len(got) != len(want):
        return {**out, "ok": False}
    same = len(got) == len(want) == 39 and all(
        (g["lambda"], g["restart"]) == (w["lambda"], w["restart"])
        for g, w in zip(got, want))
    nan_rows = [g["lambda"] for g in got if math.isnan(g["test_rho"])]
    misses = [abs(g["test_rho"] - w["test_rho"]) for g, w in zip(got, want)
              if not math.isnan(w["test_rho"])]
    out.update({"restarts_as_committed": same,
                "nan_lambdas": nan_rows,
                "test_rho_miss_max": max(misses, default=None),
                "rules_recomputed": sensitivity_block(
                    block.get("lambdas", []), got)["rules"]
                == block.get("rules")})
    out["ok"] = (same and out["rules_recomputed"]
                 and sorted(nan_rows) == sorted(
                     w["lambda"] for w in want
                     if math.isnan(w["test_rho"]))
                 and len(nan_rows) == 12
                 and max(misses) <= SUPPRESSION_RHO_TOL)
    return out


def check_default(metrics: dict) -> dict:
    out, ok = {}, True
    for lam in ("0.0", "0.001", "0.01", "0.1", "1.0"):
        m = metrics.get(lam, {})
        out[lam] = dict(m)
        if float(lam) <= 0.1:
            for key, lo in RETRAIN_MIN.items():
                ok &= m.get(key, -2.0) >= lo
    ts = metrics.get("test_stage", {})
    out["test_stage"] = ts
    ok &= all(math.isfinite(ts.get(k, math.nan)) for k in (
        "spearman", "spearman_best_valid_rho_restart"))
    out["limits"] = RETRAIN_MIN
    out["ok"] = bool(ok)
    return out


def control(device: str) -> dict:
    """The reduced retrain of ``chip_smoke.py`` without its Adam steps,
    held to the JAX spread of the retrain with them."""
    import torch

    from conditional_ude_tpu_torch import suppression_pipeline as pipe
    from conditional_ude_tpu_torch.models import suppression as sup
    red = dict(SUPPRESSION_REDUCED, adam_iters=0)
    sizes = pipe.Sizes(valid_inits=red.pop("valid_inits"),
                       fit=sup.SuppressionFitConfig(**red))
    t0 = time.perf_counter()
    run = pipe.run_exp_suppression(torch.device(device), REPO / "artifacts",
                                   sizes=sizes, no_test_stage=True)
    failures = check_suppression_spread(run.rows)
    return {"device": device, "config": red, "metrics": run.metrics,
            "seconds": time.perf_counter() - t0,
            "spread_failures": failures, "ok": bool(failures)}


def probe() -> dict:
    """ms of one value+grad (eager and from its CUDA graph, and their
    largest relative difference) and of a forward screen at the runs'
    shapes on the card, by the host clock around ``torch.cuda
    .synchronize``."""
    import numpy as np
    import torch

    from conditional_ude_tpu_torch.fit.optim import graphed_vg
    from conditional_ude_tpu_torch.models import suppression as sup
    from conditional_ude_tpu_torch.suppression_pipeline import (
        DATA_SEED,
        GROUP_MEANS,
        TIMEPOINTS,
    )
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(DATA_SEED)
    data, _ = sup.generate_data(GROUP_MEANS, (15, 3, 3, 3, 3, 10),
                                TIMEPOINTS, 0.1, rng=rng, device=dev)
    valid, _ = sup.generate_data(GROUP_MEANS, (5,) * 6, TIMEPOINTS, 0.1,
                                 rng=rng, device=dev)
    net = sup.suppression_net()
    gen = torch.Generator().manual_seed(0)
    out = {}

    def timed(name, fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / reps

    def vg(fun, *xs):
        xs = [x.clone().requires_grad_(True) for x in xs]
        f = fun(*xs)
        return (f.detach(), *torch.autograd.grad(f.sum(), xs))

    def both(name, fun, *xs):
        """Eager and graphed, timed, and their largest relative gap."""
        timed(f"{name}, eager", lambda: vg(fun, *xs), 10)
        gvg = graphed_vg(lambda t: fun(*t), xs)
        timed(f"{name}, graph", lambda: gvg(xs), 10)
        f, grads = gvg(xs)
        want = vg(fun, *xs)
        out[f"{name}, graph rel diff"] = max(
            float(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  .item()) for a, b in zip((f, *grads), want))

    for name, rows, d in (("value+grad, sweep 125 x 37", 125, data),
                          ("value+grad, validations 250 x 30", 250, valid)):
        d = torch.as_tensor(d, device=dev)
        nn, th = (a.to(dev) for a in sup.initial_designs(
            net, rows, d.shape[0], gen))
        lam = torch.full((rows,), 0.01, device=dev)
        both(name, lambda a, b: sup.suppression_loss(
            net, a, b, d, TIMEPOINTS, lam), nn, th)
    nn, _ = (a.to(dev) for a in sup.initial_designs(net, 120, 1, gen))
    x = torch.ones(120, 4, device=dev)
    one = torch.as_tensor(valid[0], device=dev).expand(120, -1, -1)
    both("value+grad, test stage 120 x 1",
         lambda a: sup.sigma_nll(net, nn, a, one, TIMEPOINTS), x)
    nn, th = (a.to(dev) for a in sup.initial_designs(net, 10_000, 37, gen))
    with torch.no_grad():
        timed("forward, sweep screen 10,000 x 37",
              lambda: sup.suppression_loss(net, nn, th, data, TIMEPOINTS), 3)
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=REPO / "build" / "suppression")
    p.add_argument("--only", nargs="+", default=["probe", *FLAGS],
                   choices=["probe", *FLAGS, "control"])
    p.add_argument("--budget", type=float, default=None,
                   help="seconds the entry-point runs may take in all")
    p.add_argument("--device", default="cuda",
                   help="the device of the control run")
    args = p.parse_args()
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    summary = {"card": card_line() if args.device != "cpu" else None,
               "runs": {}}
    start = time.perf_counter()

    def save():
        (out / "summary.json").write_text(json.dumps(summary, indent=2))

    if "probe" in args.only:
        summary["probe_ms"] = probe()
        print(json.dumps({"probe_ms": summary["probe_ms"]}), flush=True)
        save()
        gaps = [v for k, v in summary["probe_ms"].items()
                if k.endswith("rel diff")]
        if not all(g <= GRAPH_RTOL for g in gaps):
            raise SystemExit(f"graph replay differs from eager: {gaps}")
    if "control" in args.only:
        summary["control"] = control(args.device)
        print(json.dumps({"control": summary["control"]}), flush=True)
        save()
    for name in (n for n in FLAGS if n in args.only):
        run_dir, log = out / name, out / f"{name}.log"
        left = (None if args.budget is None
                else args.budget - (time.perf_counter() - start))
        t0 = time.perf_counter()
        with log.open("w") as f:
            try:
                rc = subprocess.run(
                    [*ENTRY, *FLAGS[name], "--out", str(run_dir)], cwd=REPO,
                    stdout=f, stderr=subprocess.STDOUT,
                    timeout=left).returncode
            except subprocess.TimeoutExpired:
                rc = None
        run = {"seconds": time.perf_counter() - t0, "rc": rc,
               "stage_seconds": stderr_record(log, "stage_seconds"),
               "launches": stderr_record(log, "launches")}
        mpath = run_dir / "exp_suppression_metrics.json"
        metrics = json.loads(mpath.read_text()) if mpath.exists() else {}
        if name == "test_only":
            run["check"] = check_test_only(
                metrics, stderr_record(log, "revalidated") or [])
        elif name == "sensitivity":
            run["check"] = check_sensitivity(metrics, run_dir)
        else:
            run["check"] = check_default(metrics)
        summary["runs"][name] = run
        print(json.dumps({name: run}), flush=True)
        save()
    save()
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
