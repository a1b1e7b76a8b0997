"""The JAX package's generic training route and its solver options on the
CPU: the designs and the values that ``chip_smoke.py``'s ``generic`` path
holds the port to on the card.

    python scripts/generic_reference.py [--only A B C G] [--perturb 4]

Three paths at full width (exp02's 57-subject fit split, its 25 validation
and 35 test subjects, the full networks); only the design count and the
depth are cut (``CONFIG``, ``TRAININGS``), so that the port's eager
autograd through Tsit5 fits ``chip_smoke.py``'s budget on the card (a
value+grad of 15 x 57 lanes is ~46,600 launches and ~0.7 s there, an
L-BFGS iteration of a Tsit5 fit 7-14 s of line search):

* ``A``: the canonical cUDE, ``chain(4, 2, "tanh")``, trained with
  ``TrainConfig(solver="tsit5")``, 20 Adam and 2 L-BFGS steps.  The port's Tsit5 takes other steps
  than JAX's from the steady-state start (F7), and the gradient through the
  adaptive steps moves with them, so JAX's training is run again on the
  cohort with u0 one float32 ulp away in each of four directions
  (``--perturb``): the spread the port's Adam trace and objectives are held
  to.
* ``B``: two conditional parameters, ``chain(4, 2, "gelu", input_dims=3)``,
  kind ``conditional``, ``n_conditional=2``, RK4 at 8 substeps, 100 Adam
  and 10 L-BFGS steps.
* ``C``: ``fit_betas_sigma(solver="tsit5")`` of the 35 test subjects at
  exp02's committed best candidate (row 19 of
  ``artifacts/cude_neural_parameters.npz``; bounds its training β's ±10 %,
  from β = −1, as exp02's refit; 2 L-BFGS steps), and
  ``evaluate_model(solver="tsit5")`` of rows 0, 1 and 19 on the 25
  validation subjects (1 step); again from u0 one ulp
  away, as A, since the gradients through Tsit5's steps move the fits as
  they move the training.

* ``G``: why A and C are held to a spread: the gradient of the population
  SSE by Tsit5 at four of A's designs on its first five subjects, JAX's
  move when u0 moves one ulp against the port's miss of it (the port's
  loss, autograd on the CPU), each a row's largest entry relative to that
  row's largest.

A and B start from ``initial_designs`` at ``CONFIG["seed"]``, which is also
the LHS seed: the networks go to ``tests/golden/generic_designs.npz``
(``nn_A``, ``nn_B``), the β's come back from the seed with numpy.  The
values go to ``scripts/generic_reference.json``.  The generic route is the
one JAX takes on the CPU (``screen_path`` ``xla_vmap``, ``refine_path``
``xla_reverse_ad``).
"""

from __future__ import annotations

import argparse
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

from conditional_ude_tpu.data.ohashi import load_npz  # noqa: E402
from conditional_ude_tpu.fit import train as jtrain  # noqa: E402
from conditional_ude_tpu.models.cpeptide import (  # noqa: E402
    CPeptideModel,
    build_cohort,
)
from conditional_ude_tpu.nn import chain  # noqa: E402
from conditional_ude_tpu.utils.stats import stratified_split  # noqa: E402

CONFIG = {"seed": 270523, "initial_guesses": 2500, "selected_initials": 15,
          "max_steps": 256, "substeps": 8, "fit_iters": 2,
          "evaluate_iters": 1, "best": 19, "evaluate_rows": [0, 1, 19]}
# path -> (kind, width, depth, activation, input_dims, TrainConfig fields)
TRAININGS = {"A": ("conditional", 4, 2, "tanh", 2,
                   {"solver": "tsit5", "adam_iters": 20, "lbfgs_iters": 2}),
             "B": ("conditional", 4, 2, "gelu", 3,
                   {"n_conditional": 2, "adam_iters": 100,
                    "lbfgs_iters": 10})}
DESIGNS = REPO / "tests" / "golden" / "generic_designs.npz"
OUT = REPO / "scripts" / "generic_reference.json"
# u0 one ulp up or down in each of its two entries
DIRECTIONS = ((np.inf, np.inf), (np.inf, -np.inf), (-np.inf, np.inf),
              (-np.inf, -np.inf))


def cohorts():
    """(fit, validation, test) cohorts of exp02's split at the seed."""
    train, test = load_npz(REPO / "artifacts" / "ohashi.npz")
    idx_fit, idx_val = stratified_split(
        np.random.default_rng(CONFIG["seed"]), train.types, 0.7)

    def cohort(s):
        return build_cohort(s.glucose, s.timepoints, s.cpeptide, s.ages,
                            s.t2dm)
    return (cohort(train.subset(idx_fit)), cohort(train.subset(idx_val)),
            cohort(test))


def train_config(path: str) -> jtrain.TrainConfig:
    return jtrain.TrainConfig(
        initial_guesses=CONFIG["initial_guesses"],
        selected_initials=CONFIG["selected_initials"],
        max_steps=CONFIG["max_steps"], substeps=CONFIG["substeps"],
        **TRAININGS[path][5])


def model_of(path: str) -> CPeptideModel:
    kind, width, depth, act, inputs, _ = TRAININGS[path]
    return CPeptideModel(kind=kind,
                         net=chain(width, depth, act, input_dims=inputs))


def moved_u0(cohort, direction):
    ind = cohort.individuals
    u0 = np.nextafter(np.asarray(ind.u0, np.float32),
                      np.float32(direction))
    return cohort._replace(individuals=ind._replace(u0=jnp.asarray(u0)))


def floats(a) -> list:
    return np.asarray(a, np.float64).tolist()


def run_training(path: str, fit, perturb: int) -> tuple[dict, np.ndarray]:
    model, cfg = model_of(path), train_config(path)
    key = jax.random.key(CONFIG["seed"])
    nn, betas = jtrain.initial_designs(model.net, fit.n, key, cfg,
                                       seed=CONFIG["seed"])
    t0 = time.perf_counter()
    res = jtrain.train_conditional(model, fit, key, cfg, seed=CONFIG["seed"])
    out = {"seconds": time.perf_counter() - t0,
           "lhs_sum": float(np.asarray(betas, np.float64).sum()),
           "screen_path": res.timings["screen_path"],
           "refine_path": res.timings["refine_path"],
           "screen_losses": floats(res.screen_losses),
           "loss_traces": floats(res.loss_traces),
           "objectives": floats(res.objectives),
           "betas_shape": list(res.betas.shape),
           "orientations": None if res.orientations is None
           else floats(res.orientations)}
    runs = []
    for direction in DIRECTIONS[:perturb]:
        r = jtrain.train_conditional(model, moved_u0(fit, direction), key,
                                     cfg, seed=CONFIG["seed"])
        runs.append({"loss_traces": floats(r.loss_traces),
                     "objectives": floats(r.objectives)})
    if runs:
        out["u0_ulp_runs"] = runs
    print(f"[{path}] {out['seconds']:.1f} s, routes {out['screen_path']}, "
          f"{out['refine_path']}; best {out['objectives'][0]:.6f}",
          file=sys.stderr)
    return out, np.asarray(nn, np.float32)


def run_fits(val, test, perturb: int) -> dict:
    """Path C, and again with u0 one ulp away (``perturb`` directions)."""
    with np.load(REPO / "artifacts" / "cude_neural_parameters.npz") as z:
        cand, betas = z["nn_params"], z["betas"]
    model = model_of("A")
    best, rows = CONFIG["best"], CONFIG["evaluate_rows"]
    bb = np.asarray(betas[best], np.float32).ravel()
    lb = float(bb.min() - 0.1 * abs(bb.min()))
    ub = float(bb.max() + 0.1 * abs(bb.max()))

    def fits(val, test):
        t0 = time.perf_counter()
        b, s, o = jtrain.fit_betas_sigma(
            model, jnp.asarray(cand[best]), test, -1.0, (lb, ub),
            CONFIG["fit_iters"], "tsit5", CONFIG["max_steps"],
            CONFIG["substeps"])
        t1 = time.perf_counter()
        objectives = jtrain.evaluate_model(
            model, jnp.asarray(cand[rows]), jnp.asarray(betas[rows]), val,
            lbfgs_iters=CONFIG["evaluate_iters"], solver="tsit5",
            max_steps=CONFIG["max_steps"], substeps=CONFIG["substeps"])
        t2 = time.perf_counter()
        return {"beta": floats(b), "sigma": floats(s),
                "objective": floats(o), "evaluate": floats(objectives),
                "seconds": {"fit": t1 - t0, "evaluate": t2 - t1}}

    out = {"bounds": [lb, ub], **fits(val, test)}
    runs = [fits(moved_u0(val, d), moved_u0(test, d))
            for d in DIRECTIONS[:perturb]]
    if runs:
        out["u0_ulp_runs"] = runs
    print(f"[C] fit {out['seconds']['fit']:.1f} s, evaluate "
          f"{out['seconds']['evaluate']:.1f} s", file=sys.stderr)
    return out


def run_gradients(fit) -> dict:
    """Path G (the port's side needs torch on the CPU)."""
    import torch

    from conditional_ude_tpu.fit.losses import population_sse
    from conditional_ude_tpu_torch.fit.losses import (
        population_sse as port_population_sse,
    )
    from conditional_ude_tpu_torch.models import cpeptide as cp
    from conditional_ude_tpu_torch.nn import chain as port_chain

    model, cfg = model_of("A"), train_config("A")
    sub = jax.tree.map(lambda a: a[:5], fit._replace(timepoints=None))
    sub = sub._replace(timepoints=fit.timepoints)
    nn, betas = jtrain.initial_designs(model.net, fit.n,
                                       jax.random.key(CONFIG["seed"]), cfg,
                                       seed=CONFIG["seed"])
    nn, betas = np.asarray(nn)[:4], np.asarray(betas)[:4, :5]

    def jax_grad(c):
        g = jax.vmap(jax.grad(lambda a, b: population_sse(
            model, a, b, c, solver="tsit5")))(jnp.asarray(nn),
                                              jnp.asarray(betas))
        return np.asarray(g)

    def rel(a, b):
        return np.abs(a - b).max(1) / np.abs(b).max(1)

    ref = jax_grad(sub)
    moves = [rel(jax_grad(moved_u0(sub, d)), ref) for d in DIRECTIONS]
    ind = sub.individuals
    pc = cp.Cohort(
        glucose=torch.as_tensor(np.asarray(ind.glucose)),
        cpeptide=torch.as_tensor(np.asarray(sub.cpeptide)),
        timepoints=np.asarray(sub.timepoints, np.float32),
        age=torch.as_tensor(np.asarray(ind.age)),
        k0=torch.as_tensor(np.asarray(ind.k0)),
        k1=torch.as_tensor(np.asarray(ind.k1)),
        k2=torch.as_tensor(np.asarray(ind.k2)),
        c0=torch.as_tensor(np.asarray(ind.c0)))
    x = torch.tensor(nn, requires_grad=True)
    port_population_sse(cp.CPeptideModel(port_chain(4, 2)), x[:, None, :],
                        torch.as_tensor(betas[..., 0]), pc,
                        solver="tsit5").sum().backward()
    return {"jax_u0_ulp_move": floats(np.max(moves, 0)),
            "port_miss": floats(rel(x.grad.numpy(), ref))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", default=["A", "B", "C", "G"],
                    choices=["A", "B", "C", "G"])
    ap.add_argument("--perturb", type=int, default=4,
                    help="paths A's and C's runs from u0 one ulp away (0-4)")
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--designs", type=Path, default=DESIGNS)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    fit, val, test = cohorts()
    out = json.loads(args.out.read_text()) if args.out.exists() else {}
    out["config"] = {**CONFIG, "trainings": {
        k: {"kind": v[0], "width": v[1], "depth": v[2], "activation": v[3],
            "input_dims": v[4], **v[5]} for k, v in TRAININGS.items()}}
    designs = dict(np.load(args.designs)) if args.designs.exists() else {}
    for path in ("A", "B"):
        if path in args.only:
            out[path], designs[f"nn_{path}"] = run_training(
                path, fit, args.perturb if path == "A" else 0)
    if "C" in args.only:
        out["C"] = run_fits(val, test, args.perturb)
    if "G" in args.only:
        out["G"] = run_gradients(fit)
    args.designs.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.designs, **designs)
    args.out.write_text(json.dumps(out) + "\n")
    print(f"[generic_reference] {time.perf_counter() - t0:.1f} s; wrote "
          f"{args.out} and {args.designs}", file=sys.stderr)


if __name__ == "__main__":
    main()
