"""The JAX package's training at networks other than ``chain(4, 2)`` on the
CPU: the values that ``chip_smoke.py``'s ``widths`` path holds the port's
kernel route to on the card.

    python scripts/widths_reference.py [--only W D V]

Three networks the JAX kernels take (tanh hidden layers, a softplus head),
each trained by ``train_conditional`` on exp02's 57-subject fit split (the
split at ``CONFIG["seed"]``) at a cut of exp02's multi-start: 2,500
designs screened, 15 restarts of 100 Adam and 10 L-BFGS steps, RK4 at 8
substeps, then the Tsit5 re-rank:

* ``W``: ``chain(8, 2, "tanh")`` on [ΔG, e^β], 105 weights;
* ``D``: ``chain(4, 3, "tanh")``, 57 weights;
* ``V``: ``chain([6, 3], "tanh", input_dims=3)``, the covariate model on
  [ΔG, e^β, age], 49 weights.

JAX runs ``use_pallas=False`` (its XLA route, the only one on a CPU), which
JAX's own tests hold to its Pallas kernels at rtol 1e-5.  The designs come
from numpy (:func:`designs`: Glorot-uniform networks with zero biases and
the Latin hypercube of β's, both from the seed) and go to both packages
(here by replacing ``initial_designs`` in this process; the port's
``train_conditional`` takes ``designs=``), so nothing large is committed:
``chip_smoke.py`` imports :func:`designs` from this file, which imports JAX
only in :func:`main`.  The values go to ``scripts/widths_reference.json``:
each network's screen losses, Adam trace, re-ranked objectives and the
checksums of its designs.

Each network is trained a second time with JAX's ``tanh`` replaced, in
this process only, by :func:`accurate_tanh` (``accurate_tanh``: each
restart's first Adam loss, which names its design, and its re-ranked
objective).  XLA's float32 ``tanh`` on the CPU is a fast approximation: it
matches the correctly rounded value on 41 % of [0, 10], is up to 4 ulps
off, and reaches exactly 1 at x = 7.999 where the correctly rounded value
does at 9.011, so between the two its derivative is 0.  The port's kernels
use CUDA's accurate ``tanhf`` (as ``-fmad=false`` and no fast math
require).  V's first layer sees the raw ages and works in that range, so
100 Adam and 10 L-BFGS steps follow the two derivatives apart: JAX's own
objectives move by up to 3.2 % between its ``tanh`` and the accurate one,
on the restarts where the port's do.  ~4 min on 8 cores.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "scripts" / "widths_reference.json"
CONFIG = {"seed": 270523, "initial_guesses": 2500, "selected_initials": 15,
          "adam_iters": 100, "lbfgs_iters": 10, "substeps": 8,
          "max_steps": 256}
# name -> (hidden widths, inputs, kind)
NETS = {"W": ((8, 8), 2, "conditional"),
        "D": ((4, 4, 4), 2, "conditional"),
        "V": ((6, 3), 3, "conditional_covariate")}


def layer_dims(widths, inputs: int) -> list[tuple[int, int]]:
    dims = [inputs, *widths, 1]
    return list(zip(dims[:-1], dims[1:]))


def designs(widths, inputs: int, n: int, lower: float, upper: float,
            seed: int = CONFIG["seed"], g: int = CONFIG["initial_guesses"]):
    """``(nn[g, P], betas[g, n, 1])`` as float32: per layer a Glorot-uniform
    ``W`` (bound √(6 / (fan_in + fan_out))) and a zero bias, in the flat
    layout, from ``default_rng(seed)``; the β's a Latin hypercube on
    [lower, upper] of ``g`` samples in ``n`` dimensions from a second
    ``default_rng(seed)`` (one permutation and one uniform draw a
    dimension, the packages' ``latin_hypercube``)."""
    rng = np.random.default_rng(seed)
    parts = []
    for fi, fo in layer_dims(widths, inputs):
        b = np.sqrt(6.0 / (fi + fo))
        parts += [rng.uniform(-b, b, (g, fo * fi)), np.zeros((g, fo))]
    nn = np.concatenate(parts, axis=1).astype(np.float32)
    lhs_rng = np.random.default_rng(seed)
    unit = np.empty((g, n))
    for d in range(n):
        perm = lhs_rng.permutation(g)
        unit[:, d] = (perm + lhs_rng.uniform(size=g)) / g
    betas = (lower + unit * (upper - lower)).astype(np.float32)
    return nn, betas.reshape(g, n, 1)


def checksums(nn, betas) -> dict:
    return {"nn_sum": float(np.asarray(nn, np.float64).sum()),
            "betas_sum": float(np.asarray(betas, np.float64).sum())}


def accurate_tanh(jax):
    """A float32 ``tanh`` within 4 ulps of the correctly rounded value and
    equal to it on 94 % of [-10, 10], saturating where it does: XLA's own
    below |x| = 0.55, else sign(x) (1 - 2 / (e^{2|x|} + 1)); its derivative
    is JAX's rule for ``tanh``, (g + g y)(1 - y)."""
    jnp = jax.numpy

    @jax.custom_jvp
    def tanh(x):
        a = jnp.abs(x)
        return jnp.where(a < 0.55, jnp.tanh(x),
                         jnp.sign(x) * (1.0 - 2.0 / (jnp.exp(2.0 * a) + 1.0)))

    @tanh.defjvp
    def _(primals, tangents):
        (x,), (g,) = primals, tangents
        y = tanh(x)
        return y, (g + g * y) * (1.0 - y)

    return tanh


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="+", choices=sorted(NETS),
                        default=sorted(NETS))
    parser.add_argument("--out", type=Path, default=OUT)
    args = parser.parse_args()

    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import conditional_ude_tpu.nn as jnn
    from conditional_ude_tpu.data.ohashi import load_npz
    from conditional_ude_tpu.fit import train as jtrain
    from conditional_ude_tpu.models.cpeptide import (
        CPeptideModel,
        build_cohort,
    )
    from conditional_ude_tpu.nn import chain
    from conditional_ude_tpu.utils.stats import stratified_split

    train, _ = load_npz(REPO / "artifacts" / "ohashi.npz")
    idx_fit, _ = stratified_split(np.random.default_rng(CONFIG["seed"]),
                                  train.types, 0.7)
    s = train.subset(idx_fit)
    fit = build_cohort(s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm)
    cfg = jtrain.TrainConfig(**{k: CONFIG[k] for k in (
        "initial_guesses", "selected_initials", "adam_iters", "lbfgs_iters",
        "substeps", "max_steps")})
    out = json.loads(args.out.read_text()) if args.out.exists() else {}
    out["config"] = {**CONFIG, "lhs_lower": cfg.lhs_lower,
                     "lhs_upper": cfg.lhs_upper, "n_fit": fit.n}
    for name in args.only:
        widths, inputs, kind = NETS[name]
        model = CPeptideModel(kind=kind, net=chain(
            list(widths), activation="tanh", input_dims=inputs))
        assert jtrain._pallas_eligible(model, cfg)
        nn, betas = designs(widths, inputs, fit.n, cfg.lhs_lower,
                            cfg.lhs_upper)
        assert nn.shape[1] == model.net.num_params
        def train(tanh):
            # the designs reach JAX's train_conditional through its
            # initial_designs, and the tanh its activations, replaced in
            # this process only; no program traced with another tanh is
            # reused
            jtrain.initial_designs = (
                lambda *a, **k: (jnp.asarray(nn), jnp.asarray(betas)))
            jnn._ACTIVATIONS["tanh"] = tanh
            jtrain._PROGRAMS.clear()
            jax.clear_caches()
            return jtrain.train_conditional(model, fit, jax.random.key(0),
                                            cfg, seed=CONFIG["seed"])

        t0 = time.perf_counter()
        res = train(jnp.tanh)
        seconds = time.perf_counter() - t0
        acc = train(accurate_tanh(jax))
        jnn._ACTIVATIONS["tanh"] = jnp.tanh
        out[name] = {
            "widths": list(widths), "inputs": inputs, "kind": kind,
            "num_params": model.net.num_params, **checksums(nn, betas),
            "seconds": seconds,
            "screen_path": res.timings["screen_path"],
            "refine_path": res.timings["refine_path"],
            "screen_losses": np.asarray(res.screen_losses,
                                        np.float64).tolist(),
            "loss_traces": np.asarray(res.loss_traces, np.float64).tolist(),
            "objectives": np.asarray(res.objectives, np.float64).tolist(),
            "accurate_tanh": {
                "first": np.asarray(acc.loss_traces[:, 0],
                                    np.float64).tolist(),
                "objectives": np.asarray(acc.objectives,
                                         np.float64).tolist()}}
        print(f"[{name}] {seconds:.1f} s, routes {res.timings['screen_path']}"
              f", {res.timings['refine_path']}; best "
              f"{float(res.objectives[0]):.6f}", file=sys.stderr, flush=True)
        args.out.write_text(json.dumps(out))
    print(json.dumps({k: v.get("objectives", [None])[0]
                      for k, v in out.items() if k != "config"}))


if __name__ == "__main__":
    main()
