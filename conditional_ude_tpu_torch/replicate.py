"""Run one experiment of the package at several seeds, each in a child
process, and aggregate every numeric metric across them (counterpart of
``experiments/exp_replicate.py``).

    python -m conditional_ude_tpu_torch.replicate --experiment exp02 \\
        --seeds 11 22 --out runs/replicate -- --retrain

Seed ``s`` runs ``python -m conditional_ude_tpu_torch --experiment NAME
--seed s --out DIR/seeds/NAME_seed<s>`` and the arguments after ``--``.  A
seed whose metrics (``*_metrics*.json``) are already there is not run again
unless ``--retrain`` is given; a child that fails ends the run with a
non-zero exit.  Every numeric leaf of the metrics (no bools, nothing
non-finite) that two seeds or more have gets its mean, sd (ddof 1), min and
max in ``DIR/replicate_NAME.json`` (keys ``script``, ``seeds``,
``aggregate``, ``per_seed``, as the JAX experiment script's).  ``--smoke``
passes ``--smoke`` to each child, whose metrics are then under its
``smoke/``, and writes ``DIR/smoke/replicate_NAME.json``
(``experiments/exp_replicate.py:65-75,121``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from conditional_ude_tpu_torch.__main__ import ARTIFACTS, EXPERIMENTS, out_dir

REPO = Path(__file__).resolve().parent.parent


def flatten(metrics, prefix: str = "") -> dict[str, float]:
    """Dotted path → value of every numeric scalar leaf
    (``experiments/exp_replicate.py:48-58``)."""
    out = {}
    if isinstance(metrics, dict):
        for k, v in metrics.items():
            out.update(flatten(v, f"{prefix}{k}."))
    elif isinstance(metrics, bool):
        pass
    elif isinstance(metrics, (int, float)) and np.isfinite(metrics):
        out[prefix[:-1]] = float(metrics)
    return out


def aggregate(per_seed: dict) -> dict[str, dict[str, float]]:
    """Mean, sd (ddof 1), min and max of each leaf that two seeds or more
    of ``per_seed`` (seed → metrics) have."""
    flat = [flatten(m) for m in per_seed.values()]
    out = {}
    for k in sorted({k for f in flat for k in f}):
        vals = np.asarray([f[k] for f in flat if k in f])
        if len(vals) < 2:
            continue
        out[k] = {"mean": float(vals.mean()), "sd": float(vals.std(ddof=1)),
                  "min": float(vals.min()), "max": float(vals.max())}
    return out


def _metrics_in(directory: Path) -> list[Path]:
    return sorted(directory.glob("*_metrics*.json")) if directory.exists() \
        else []


def run_seed(experiment: str, seed: int, out: Path, extra: list[str],
             retrain: bool, timeout: float, smoke: bool = False) -> dict:
    """Seed ``seed``'s metrics: its child's, run now unless its directory
    holds them already and ``retrain`` is false."""
    seed_dir = out / "seeds" / f"{experiment}_seed{seed}"
    metrics_dir = seed_dir / "smoke" if smoke else seed_dir
    done = _metrics_in(metrics_dir)
    if done and not retrain:
        print(f"[replicate] seed {seed}: cached {done[0].name}",
              file=sys.stderr)
        return json.loads(done[0].read_text())
    cmd = [sys.executable, "-m", "conditional_ude_tpu_torch", "--experiment",
           experiment, "--seed", str(seed), "--out", str(seed_dir),
           *(["--smoke"] if smoke else []), *extra]
    proc = subprocess.run(cmd, cwd=REPO, timeout=timeout)
    if proc.returncode != 0:
        sys.exit(f"seed {seed}: {experiment} exited {proc.returncode}")
    done = _metrics_in(metrics_dir)
    if not done:
        sys.exit(f"seed {seed}: no *_metrics.json under {metrics_dir}")
    return json.loads(done[0].read_text())


def parser() -> argparse.ArgumentParser:
    """The runner's flags."""
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--experiment", required=True, choices=EXPERIMENTS,
                   help="the experiment of `python -m "
                        "conditional_ude_tpu_torch` to replicate")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", type=Path, required=True,
                   help="directory for the seeds' outputs (seeds/) and "
                        "replicate_<experiment>.json")
    p.add_argument("--smoke", action="store_true",
                   help="pass --smoke to each child (its CI sizes); the "
                        "aggregate goes to DIR/smoke")
    p.add_argument("--retrain", action="store_true",
                   help="run seeds whose metrics are already under --out")
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="seconds a seed's child may take")
    p.add_argument("extra", nargs="*",
                   help="arguments for each child (after --), e.g. "
                        "--retrain or --device cpu")
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    out = out_dir(args.out, ARTIFACTS)
    per_seed = {seed: run_seed(args.experiment, seed, out, args.extra,
                               args.retrain, args.timeout, args.smoke)
                for seed in args.seeds}
    agg = aggregate(per_seed)
    if args.smoke:
        out = out_dir(out / "smoke", ARTIFACTS)
    (out / f"replicate_{args.experiment}.json").write_text(json.dumps({
        "script": args.experiment,
        "seeds": list(per_seed),
        "aggregate": agg,
        "per_seed": per_seed,
    }, indent=1))
    print(json.dumps({"script": args.experiment, "n_seeds": len(per_seed),
                      "aggregated_keys": len(agg)}))


if __name__ == "__main__":
    main()
