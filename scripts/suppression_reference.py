"""The JAX package's exp_suppression on the CPU: the yardsticks that
``chip_smoke.py`` and ``scripts/suppression_runs.py`` hold the port's runs
on the card to.

    python scripts/suppression_reference.py --only test [--lbfgs-iters N] --out FILE
    python scripts/suppression_reference.py --only artifacts --out FILE
    python scripts/suppression_reference.py --only spread --seeds S ... --out FILE
    python scripts/suppression_reference.py --merge FILE ... --out FILE
    python scripts/suppression_reference.py --compare FILE FILE --out FILE

* ``test``: the JAX script's ``--test-only`` (its data and draws, numpy
  seed 27052023): every restart of the committed λ = 0.01 artifact
  revalidated on the noisy validation set (10,000 candidate θ's, L-BFGS at
  ``--lbfgs-iters``, 2,000 by default), the two selected restarts, their
  test Spearman on the 60 fresh subjects; and JAX-CPU's own miss of the
  TPU-made ``results/suppression_sweep.csv`` (λ = 0.01 rows) and
  ``results/exp_suppression_metrics.json`` (``test_stage``) (~30 min at
  full depth, ~2 min at 20 steps); ``--perturb`` moves every validation
  candidate one float32 ulp up, and ``--compare`` gives two such runs'
  largest misses: JAX's own sensitivity at that depth;
* ``artifacts``: JAX-CPU's loss at the 25 restarts of each committed
  ``artifacts/suppression_lambda=*.npz`` on its own training data, and its
  largest relative miss of each file's ``objectives`` (~1 min);
* ``spread``: the reduced retrain that ``chip_smoke.py`` runs
  (``SUPPRESSION_REDUCED``: the full 37-subject population and 5 × 3
  network, fewer designs, restarts, steps and validation candidates) at
  each JAX key ``--seeds``, and each λ's ``best_correlation_train``,
  ``best_correlation_valid`` and best objective; ``--merge`` takes several
  such files and gives each metric's least and greatest over all keys, the
  spread, beside each key's values (run several processes, each a few
  keys; ~5 min a key).  The merged output behind ``chip_smoke.py``'s
  ``SUPPRESSION_SPREAD`` is ``scripts/suppression_spread.json``.

The output is one JSON object, printed and written to ``--out``.
"""

from __future__ import annotations

import argparse
import csv
import glob
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

from chip_smoke import SUPPRESSION_REDUCED  # noqa: E402
from conditional_ude_tpu.models import suppression as jsup  # noqa: E402
from conditional_ude_tpu.utils.stats import spearman  # noqa: E402

TP = np.linspace(0.0, 30.0, 8)
GROUP_MEANS = [0.5, 2.5, 5.0, 7.5, 10.0, 12.5]
LAMBDAS = [0.0, 0.001, 0.01, 0.1, 1.0]


def script_data(valid_inits: int = 10_000, perturb: bool = False):
    """The JAX script's data and the generator after them; ``perturb``
    moves every candidate θ of the validations one float32 ulp up."""
    rng = np.random.default_rng(27052023)
    out = {}
    for name, sizes, noise in (("train", [15, 3, 3, 3, 3, 10], 0.1),
                               ("valid", [5] * 6, 0.1),
                               ("nonoise", [5] * 6, 0.0)):
        out[name], out["gt_" + name] = jsup.generate_data(
            GROUP_MEANS, sizes, TP, noise_multiplicative=noise, rng=rng)
    inits = rng.uniform(size=(valid_inits, 30)).astype(np.float32)
    if perturb:
        inits = np.nextafter(inits, np.float32(np.inf))
    out["theta_inits_valid"] = jnp.asarray(inits)
    return out, rng


def run_test(lbfgs_iters: int, perturb: bool = False) -> dict:
    net = jsup.suppression_net(depth=5, width=3)
    data, rng = script_data(perturb=perturb)
    nn = jnp.asarray(np.load(REPO / "artifacts"
                             / "suppression_lambda=0.01.npz")["nn_params"])
    t0 = time.perf_counter()
    theta_v, obj_v = jsup.validate_suppression(
        net, nn, data["valid"], TP, data["theta_inits_valid"],
        lbfgs_iters=lbfgs_iters)
    loss_valid = [float(v) for v in np.asarray(obj_v)]
    rho_valid = [spearman(data["gt_valid"], t) for t in np.asarray(theta_v)]
    best_r, best_r_rho = int(np.argmin(loss_valid)), int(np.argmax(rho_valid))
    t1 = time.perf_counter()
    data_test, gt_test = jsup.generate_data(GROUP_MEANS, [10] * 6, TP,
                                            noise_multiplicative=0.1,
                                            rng=rng)
    grid = jnp.asarray(rng.uniform(size=1000), jnp.float32)
    rho = {}
    for r in sorted({best_r, best_r_rho}):
        xs, _ = jsup.validate_suppression_sigma_batch(
            net, nn[r], jnp.asarray(data_test), jnp.asarray(TP, jnp.float32),
            grid, lbfgs_iters)
        rho[r] = spearman(gt_test, np.asarray(xs[:, 0]))
    t2 = time.perf_counter()
    with (REPO / "results" / "suppression_sweep.csv").open() as f:
        want = [r for r in csv.DictReader(f) if float(r["lambda"]) == 0.01]
    committed = json.loads((REPO / "results" / "exp_suppression_metrics.json")
                           .read_text())["test_stage"]
    loss_miss = [abs(g / float(w["loss_valid"]) - 1)
                 for g, w in zip(loss_valid, want)]
    rho_miss = [abs(g - float(w["correlation_valid"]))
                for g, w in zip(rho_valid, want)]
    return {
        "lbfgs_iters": lbfgs_iters,
        "loss_valid": loss_valid, "correlation_valid": rho_valid,
        "selected_restart": best_r, "best_valid_rho_restart": best_r_rho,
        "spearman": rho[best_r],
        "spearman_best_valid_rho_restart": rho[best_r_rho],
        "miss_vs_committed": {
            "loss_valid_rel_max": max(loss_miss),
            "loss_valid_rel_median": float(np.median(loss_miss)),
            "correlation_valid_max": max(rho_miss),
            "spearman": abs(rho[best_r] - committed["spearman"]),
            "spearman_best_valid_rho_restart": abs(
                rho[best_r_rho]
                - committed["spearman_best_valid_rho_restart"]),
            "selected_as_committed": [best_r, best_r_rho] == [
                committed["selected_restart"],
                committed["best_valid_rho_restart"]]},
        "seconds": {"validate": t1 - t0, "test_stage": t2 - t1}}


def run_artifacts() -> dict:
    net = jsup.suppression_net(depth=5, width=3)
    data, _ = script_data()
    out = {}
    for path in sorted(glob.glob(str(REPO / "artifacts"
                                     / "suppression_lambda=*.npz"))):
        ck = np.load(path)
        lam = json.loads(Path(path).with_suffix(".json").read_text())["lambda"]
        loss = np.asarray(jax.vmap(
            lambda a, b: jsup.suppression_loss(net, a, b, data["train"], TP,
                                               lam))(
            jnp.asarray(ck["nn_params"]), jnp.asarray(ck["thetas"])))
        rel = np.abs(loss / ck["objectives"] - 1)
        out[str(lam)] = {"rel_miss_max": float(rel.max()),
                         "worst_restart": int(rel.argmax()),
                         "rel_miss_median": float(np.median(rel)),
                         "gt_train_exact": bool(np.array_equal(
                             ck["gt_train"], data["gt_train"]))}
    return out


def run_spread(seeds: list[int]) -> dict:
    red = SUPPRESSION_REDUCED
    net = jsup.suppression_net(depth=5, width=3)
    data, _ = script_data(red["valid_inits"])
    cfg = jsup.SuppressionFitConfig(
        initial_space=red["initial_space"], select_best_n=red["select_best_n"],
        adam_iters=red["adam_iters"], lbfgs_iters=red["lbfgs_iters"])
    per_key = {}
    for seed in seeds:
        t0 = time.perf_counter()
        sweep = jsup.fit_suppression_sweep(net, data["train"], TP,
                                           jax.random.key(seed), LAMBDAS, cfg)
        m = {}
        for li, lam in enumerate(LAMBDAS):
            theta_v, _ = jsup.validate_suppression(
                net, sweep.nn_params[li], data["valid"], TP,
                data["theta_inits_valid"], lbfgs_iters=cfg.lbfgs_iters)
            m[str(lam)] = {
                "best_correlation_train": max(
                    spearman(data["gt_train"], t)
                    for t in np.asarray(sweep.thetas[li])),
                "best_correlation_valid": max(
                    spearman(data["gt_valid"], t)
                    for t in np.asarray(theta_v)),
                "best_objective": float(sweep.objectives[li, 0])}
        m["seconds"] = time.perf_counter() - t0
        per_key[str(seed)] = m
        print(json.dumps({seed: m}), file=sys.stderr, flush=True)
    return {"reduced": red, "per_key": per_key}


def compare(a: Path, b: Path) -> dict:
    """The misses between two ``test`` outputs: each restart's
    ``loss_valid`` (relative) and ``correlation_valid``, their largest,
    and the selections and test Spearmans side by side."""
    x, y = (json.loads(f.read_text()) for f in (a, b))
    loss = np.abs(np.asarray(x["loss_valid"]) / np.asarray(y["loss_valid"])
                  - 1)
    rho = np.abs(np.asarray(x["correlation_valid"])
                 - np.asarray(y["correlation_valid"]))
    return {
        "loss_valid_rel_max": float(loss.max()),
        "correlation_valid_max": float(rho.max()),
        "loss_valid_rel": loss.tolist(), "correlation_valid": rho.tolist(),
        "selected": [[x[k], y[k]] for k in ("selected_restart",
                                            "best_valid_rho_restart")],
        "spearman": [[x[k], y[k]] for k in (
            "spearman", "spearman_best_valid_rho_restart")]}


def merge(files: list[Path]) -> dict:
    per_key = {}
    for f in files:
        per_key.update(json.loads(f.read_text())["per_key"])
    spread = {}
    for lam in map(str, LAMBDAS):
        spread[lam] = {}
        for key in ("best_correlation_train", "best_correlation_valid",
                    "best_objective"):
            vals = [m[lam][key] for m in per_key.values()]
            spread[lam][key] = [min(vals), max(vals)]
    return {"reduced": SUPPRESSION_REDUCED, "keys": sorted(per_key, key=int),
            "spread": spread, "per_key": per_key}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", choices=["test", "artifacts", "spread"])
    p.add_argument("--lbfgs-iters", type=int, default=2000)
    p.add_argument("--seeds", type=int, nargs="+",
                   default=[270523, *range(11, 166, 11)])
    p.add_argument("--perturb", action="store_true",
                   help="test: every validation candidate one ulp up")
    p.add_argument("--merge", type=Path, nargs="+")
    p.add_argument("--compare", type=Path, nargs=2,
                   help="two test outputs: their largest misses")
    p.add_argument("--out", type=Path, required=True)
    args = p.parse_args()
    if args.merge:
        res = merge(args.merge)
    elif args.compare:
        res = compare(*args.compare)
    elif args.only == "test":
        res = run_test(args.lbfgs_iters, args.perturb)
    elif args.only == "artifacts":
        res = run_artifacts()
    elif args.only == "spread":
        res = run_spread(args.seeds)
    else:
        p.error("name --only or --merge")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=2))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
