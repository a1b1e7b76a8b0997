"""The JAX package's exp_symreg_search on the CPU: the yardstick that
``chip_smoke.py`` holds the port's GP runs on the card to, and JAX-CPU at the
script's own keys.

    python scripts/symreg_reference.py --config 4 --keys 0 1 2 3 --out FILE
    python scripts/symreg_reference.py --script-keys --search-seeds 0 1 2 --out FILE
    python scripts/symreg_reference.py --merge FILE ... --out scripts/symreg_spread.json

* ``--config D --keys K ...``: one GP run of the script's full-size
  configuration of depth D (4: population 4096, elite 64; 5: population
  2048, elite 48; both 80 constant-optimisation steps and ``max_size`` 18)
  on its 720-sample fit split, at ``--generations`` (300, the script's own:
  ``chip_smoke.py`` runs them uncut), at each key ``seed + 1000·K + r``
  with r = 0 for depth 4 and 3 for depth 5 (the key of the first run of
  that depth in search seed K of ``--search-seeds``).  Each run gives its
  Pareto front, annotated as the script annotates it (holdout and full-set
  MSE, ``has_inv``), its ``best_loss`` (the front's last loss), its
  ``pareto_size`` and its ``best_holdout_mse`` (the least over its front);
  4–5.5 min a run at one thread (``XLA_FLAGS="--xla_cpu_multi_thread_eigen=
  false intra_op_parallelism_threads=1"``, six processes side by side).
* ``--script-keys``: every run of the script's search seeds ``--search-seeds``
  (keys ``seed + 1000·s + run``, runs 0-2 at depth 4 and 3-4 at depth 5)
  that the ``--config`` runs do not already give; run them beside the
  spread, several processes a few seeds each.
* ``--resume FILE ...``: keep the runs of earlier outputs, run the rest.
* ``--merge``: all runs of the files given.  ``spread``: each held metric's
  least and greatest over the runs at keys K = 0..15 of each depth
  (``chip_smoke.py``'s ``SYMREG_SPREAD``, widened by half its width on each
  side); ``script``: where every run of a search seed is present, the
  script's per-seed blocks and merged front and metrics (JAX-CPU at the
  script's keys: a record beside the committed TPU-made
  ``results/exp_symreg_metrics.json``, not a limit, since float32 GP is
  chaotic with respect to every draw).

The output is one JSON object, printed and written to ``--out``.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conditional_ude_tpu.analysis.symreg import (  # noqa: E402
    SymRegConfig,
    evaluate,
    fit_symbolic,
    pareto_front,
)

SEED = 270523
SPREAD_KEYS = 16
HELD = ("best_loss", "pareto_size", "best_holdout_mse")
# the script's configurations and the run index of each one's first run
CONFIGS = {4: (dict(depth=4, population=4096, const_opt_steps=80, elite=64,
                    max_size=18), 3, 0),
           5: (dict(depth=5, population=2048, const_opt_steps=80, elite=48,
                    max_size=18), 2, 3)}


def data(seed: int = SEED):
    """The script's samples and its 180/720 holdout split."""
    with (REPO / "artifacts" / "ohashi_production.csv").open() as f:
        rows = list(csv.DictReader(f))
    x = np.array([[float(r["Beta"]), float(r["Glucose"])] for r in rows],
                 np.float32)
    y = np.array([float(r["Production"]) for r in rows], np.float32)
    perm = np.random.default_rng(seed).permutation(len(y))
    n_hold = len(y) // 5
    return x, y, perm[:n_hold], perm[n_hold:]


def eval_program(row, xx):
    d = int(np.log2(len(row["ops"]) + 1)) - 1
    out = evaluate(jnp.asarray(row["ops"])[None],
                   jnp.asarray(row["consts"])[None],
                   jnp.asarray(xx, jnp.float32), d)
    return np.asarray(out[0], np.float64)


def run_one(depth: int, key: int, generations: int) -> dict:
    """One GP run at ``key``: its annotated front and held metrics."""
    x, y, hold, fit = data()
    kw, _, _ = CONFIGS[depth]
    cfg = SymRegConfig(generations=generations, **kw)
    t0 = time.perf_counter()
    res = fit_symbolic(jnp.asarray(x[fit]), jnp.asarray(y[fit]),
                       jax.random.key(key), cfg)
    front = pareto_front(res, with_programs=True)
    seconds = time.perf_counter() - t0
    rows = []
    for r in front:
        rows.append({
            "complexity": r["complexity"], "loss": r["loss"],
            "equation": r["equation"],
            "holdout_mse": float(np.mean((eval_program(r, x[hold])
                                          - y[hold]) ** 2)),
            "full_set_mse": float(np.mean((eval_program(r, x) - y) ** 2)),
            "has_inv": int("inv(" in r["equation"]),
            "ops": np.asarray(r["ops"]).tolist(),
            "consts": np.asarray(r["consts"]).tolist()})
    print(f"[key {key}] depth={depth} {seconds:.0f}s best="
          f"({rows[-1]['complexity']}, {rows[-1]['loss']:.6g})",
          file=sys.stderr, flush=True)
    return {"key": key, "depth": depth, "generations": generations,
            "seconds": seconds, "front": rows,
            "best_loss": rows[-1]["loss"], "pareto_size": len(rows),
            "best_holdout_mse": min(r["holdout_mse"] for r in rows)}


def script_keys(search_seeds, seed: int = SEED):
    """(depth, key) of every run of the script's search seeds."""
    out = []
    for s in search_seeds:
        for depth, (_, n, r0) in CONFIGS.items():
            out += [(depth, seed + 1000 * s + r0 + i) for i in range(n)]
    return out


def merge_front(rows):
    merged = {}
    for r in rows:
        c = r["complexity"]
        if c not in merged or r["loss"] < merged[c]["loss"]:
            merged[c] = r
    front, best = [], np.inf
    for c in sorted(merged):
        if merged[c]["loss"] < best:
            best = merged[c]["loss"]
            front.append(merged[c])
    return front


def seed_block(s: int, front: list[dict]) -> dict:
    inv = [r for r in front if r["has_inv"]]
    best = min(front, key=lambda r: r["holdout_mse"])
    best_inv = min(inv, key=lambda r: r["holdout_mse"]) if inv else None
    return {"search_seed": s, "n_front_rows": len(front),
            "n_inv_family_rows": len(inv),
            "best_holdout_mse": best["holdout_mse"],
            "best_equation": best["equation"],
            "best_inv_family_holdout_mse": (best_inv["holdout_mse"]
                                            if best_inv else None),
            "best_inv_family_equation": (best_inv["equation"]
                                         if best_inv else None)}


def merge(files: list[Path], generations: int) -> dict:
    runs = {}
    for path in files:
        for r in json.loads(path.read_text())["runs"]:
            if r["generations"] == generations:
                runs[(r["depth"], r["key"])] = r
    spread, keys = {}, {}
    for depth, (_, _, r0) in CONFIGS.items():
        got = [runs[(depth, SEED + 1000 * k + r0)] for k in range(SPREAD_KEYS)
               if (depth, SEED + 1000 * k + r0) in runs]
        keys[str(depth)] = [r["key"] for r in got]
        spread[str(depth)] = {m: [min(r[m] for r in got),
                                  max(r[m] for r in got)] for m in HELD} \
            if got else {}
    script = {"seeds": [], "committed": json.loads(
        (REPO / "results" / "exp_symreg_metrics.json").read_text())}
    all_rows = []
    for s in range(SPREAD_KEYS):
        want = script_keys([s])
        if not all(k in runs for k in want):
            continue
        rows = [row for k in want for row in runs[k]["front"]]
        script["seeds"].append(seed_block(s, merge_front(rows)))
        all_rows += rows
    if all_rows:
        front = merge_front(all_rows)
        best = min(front, key=lambda r: r["holdout_mse"])
        script.update({"best_loss": front[-1]["loss"],
                       "pareto_size": len(front),
                       "best_equation": front[-1]["equation"],
                       "best_discovered_mse": best["holdout_mse"],
                       "n_inv_family_rows": sum(r["has_inv"]
                                                for r in front)})
    return {"generations": generations, "keys": keys, "spread": spread,
            "per_key": {f"{d}/{k}": {m: r[m] for m in HELD + ("seconds",)}
                        for (d, k), r in sorted(runs.items())},
            "script": script}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", type=int, choices=sorted(CONFIGS))
    p.add_argument("--keys", type=int, nargs="*", default=[])
    p.add_argument("--script-keys", action="store_true")
    p.add_argument("--search-seeds", type=int, nargs="*", default=[0, 1, 2])
    p.add_argument("--generations", type=int, default=300)
    p.add_argument("--merge", type=Path, nargs="*")
    p.add_argument("--resume", type=Path, nargs="*", default=[],
                   help="files of earlier runs: their runs are kept and "
                        "not run again")
    p.add_argument("--out", type=Path, required=True)
    args = p.parse_args()
    if args.merge:
        out = merge(args.merge, args.generations)
    else:
        todo = []
        if args.config is not None:
            r0 = CONFIGS[args.config][2]
            todo += [(args.config, SEED + 1000 * k + r0) for k in args.keys]
        if args.script_keys:
            firsts = {SEED + 1000 * s + r0 for s in args.search_seeds
                      for _, _, r0 in CONFIGS.values()}
            todo += [dk for dk in script_keys(args.search_seeds)
                     if dk[1] not in firsts]
        out = {"runs": [r for f in args.resume
                        for r in json.loads(f.read_text())["runs"]
                        if r["generations"] == args.generations]}
        done = {(r["depth"], r["key"]) for r in out["runs"]}
        for depth, key in (dk for dk in todo if dk not in done):
            out["runs"].append(run_one(depth, key, args.generations))
            args.out.write_text(json.dumps(out))
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "runs"}))


if __name__ == "__main__":
    main()
