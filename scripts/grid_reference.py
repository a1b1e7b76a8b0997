"""The JAX package's training on a longer sampling grid on the CPU: the
values that ``chip_smoke.py``'s ``grid`` path and
``tests/test_torch_grid_domain.py`` hold the port to.

    python scripts/grid_reference.py

The OGTT cohort sampled every 5 min on 0-120 min (25 points, ``GRID``):
:func:`resample` interpolates each subject's glucose and c-peptide
linearly between the measured times (numpy only; ``chip_smoke.py`` imports
it from this file), so the glucose interpolant is the measured one.  The
canonical ``chain(4, 2)`` cUDE is trained by ``train_conditional`` on
exp02's 57-subject fit split (the split at ``CONFIG["seed"]``) at a cut of
exp02's multi-start: 2,500 designs screened, 15 restarts of 100 Adam and
10 L-BFGS steps, RK4 at 8 substeps (409 network evaluations a lane), then
the Tsit5 re-rank.  JAX runs its XLA route (``use_pallas=False``, the only
one on a CPU).  The designs come from numpy (``widths_reference.designs``:
Glorot-uniform networks with zero biases and the Latin hypercube of β's,
both from the seed) and go to both packages (here by replacing
``initial_designs`` in this process).  The values go to
``scripts/grid_reference.json``: the grid, the checksums of the designs,
the screen losses, the Adam traces and the re-ranked objectives.  ~2 min
on 8 cores.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "scripts" / "grid_reference.json"
GRID = tuple(float(t) for t in np.linspace(0.0, 120.0, 25))
CONFIG = {"seed": 270523, "initial_guesses": 2500, "selected_initials": 15,
          "adam_iters": 100, "lbfgs_iters": 10, "substeps": 8,
          "max_steps": 256}


def resample(split, times=GRID):
    """``split`` (an ``OhashiSplit`` of either package) on the grid
    ``times``: each subject's glucose and c-peptide interpolated linearly
    between its measured times (``np.interp``, float64, then float32)."""
    t0 = np.asarray(split.timepoints, np.float64)
    t1 = np.asarray(times, np.float64)

    def rows(x):
        x = np.asarray(x, np.float64)
        return np.stack([np.interp(t1, t0, r) for r in x]).astype(np.float32)

    return dataclasses.replace(split, glucose=rows(split.glucose),
                               cpeptide=rows(split.cpeptide),
                               timepoints=t1.astype(np.float32))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=OUT)
    args = parser.parse_args()

    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "scripts"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from conditional_ude_tpu.data.ohashi import load_npz
    from conditional_ude_tpu.fit import train as jtrain
    from conditional_ude_tpu.models.cpeptide import (
        CPeptideModel,
        build_cohort,
    )
    from conditional_ude_tpu.nn import chain
    from conditional_ude_tpu.utils.stats import stratified_split
    from widths_reference import checksums, designs

    train, _ = load_npz(REPO / "artifacts" / "ohashi.npz")
    idx_fit, _ = stratified_split(np.random.default_rng(CONFIG["seed"]),
                                  train.types, 0.7)
    s = resample(train.subset(idx_fit))
    fit = build_cohort(s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm)
    cfg = jtrain.TrainConfig(**{k: CONFIG[k] for k in (
        "initial_guesses", "selected_initials", "adam_iters", "lbfgs_iters",
        "substeps", "max_steps")})
    model = CPeptideModel(kind="conditional", net=chain(4, 2))
    assert jtrain._pallas_eligible(model, cfg)
    nn, betas = designs((4, 4), 2, fit.n, cfg.lhs_lower, cfg.lhs_upper)
    jtrain.initial_designs = (
        lambda *a, **k: (jnp.asarray(nn), jnp.asarray(betas)))
    t0 = time.perf_counter()
    res = jtrain.train_conditional(model, fit, jax.random.key(0), cfg,
                                   seed=CONFIG["seed"])
    seconds = time.perf_counter() - t0
    out = {"config": {**CONFIG, "lhs_lower": cfg.lhs_lower,
                      "lhs_upper": cfg.lhs_upper, "n_fit": fit.n},
           "grid": list(GRID), **checksums(nn, betas),
           "cohort_sums": {"glucose": float(np.asarray(s.glucose,
                                                       np.float64).sum()),
                           "cpeptide": float(np.asarray(s.cpeptide,
                                                        np.float64).sum())},
           "seconds": seconds,
           "screen_path": res.timings["screen_path"],
           "refine_path": res.timings["refine_path"],
           "screen_losses": np.asarray(res.screen_losses,
                                       np.float64).tolist(),
           "loss_traces": np.asarray(res.loss_traces, np.float64).tolist(),
           "objectives": np.asarray(res.objectives, np.float64).tolist()}
    args.out.write_text(json.dumps(out))
    print(json.dumps({"seconds": seconds, "best": out["objectives"][0],
                      "routes": [out["screen_path"], out["refine_path"]]}))


if __name__ == "__main__":
    main()
