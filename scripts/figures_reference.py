"""The JAX package's figure-gallery arrays on the CPU: the values that
``chip_smoke.py`` holds the port's gallery (``--experiment exp_figures``)
to on the card.

    python scripts/figures_reference.py [--out scripts/figures_reference.json]

It runs the JAX package's library functions as ``experiments/exp_figures.py``
calls them, on the committed artifacts (``artifacts/ohashi.npz`` and
``fujita.npz`` in place of the reference's CSVs) at the script's full
sizes: 1000 L-BFGS steps for the refits and 10,000 grid points for the
CI-bound profiles (the JAX scan on the CPU, ``use_pallas=False``).  Each
section gives what its figures draw and the port computes anew:

* ``data``: the three Mann-Whitney p-values of the ages;
* ``cude``: the training and test MSEs (Tsit5) and the median subjects
  they pick, ``ci_bound_sims`` of the test medians (their Cantelli-95
  bounds as Δβ and the trajectories there), the dense test fits, the
  dose-response curves, the runner-up network's refit of every subject
  and its Spearman against the selected one's, and the type-mean refit
  with the cUDE's and the UDE's curves;
* ``covariate``: the median subjects and their Raue-95 ``ci_bound_sims``;
* ``ude``, ``symbolic``, ``external``: the dense trajectories (and the
  symbolic subjects' errors and medians, the symbolic and discovered
  dose-response curves);
* ``suppression``: the λ = 0.1 network's trajectories of its regenerated
  training population;
* ``saem``: each type's posterior-predictive band.

The functions take their sizes as arguments, so ``tests/test_torch_figures.py``
runs them at the smoke sizes.  Full run ~2 min on 8 cores.
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

from conditional_ude_tpu.analysis import (  # noqa: E402
    cohort_beta_profiles,
    find_confidence_intervals,
)
from conditional_ude_tpu.data.ohashi import load_npz  # noqa: E402
from conditional_ude_tpu.fit.train import fit_betas  # noqa: E402
from conditional_ude_tpu.models import suppression as jsup  # noqa: E402
from conditional_ude_tpu.models.cpeptide import (  # noqa: E402
    CPeptideModel,
    build_cohort,
    simulate,
    simulate_cohort,
)
from conditional_ude_tpu.models.symbolic import (  # noqa: E402
    beta_to_k,
    discovered_production,
    symbolic_model,
    symbolic_production,
)
from conditional_ude_tpu.nn import chain  # noqa: E402
from conditional_ude_tpu.utils.checkpoint import load_checkpoint  # noqa: E402
from conditional_ude_tpu.utils.stats import (  # noqa: E402
    argmedian,
    mann_whitney_u,
    spearman,
)

ART = REPO / "artifacts"
OUT = REPO / "scripts" / "figures_reference.json"
TYPES = ("NGT", "IGT", "T2DM")


def model(input_dims: int = 2):
    kind = {1: "ude", 2: "conditional", 3: "conditional_covariate"}
    return CPeptideModel(kind=kind[input_dims],
                         net=chain(4, 2, "tanh", input_dims=input_dims))


def cohort(split):
    return build_cohort(split.glucose, split.timepoints, split.cpeptide,
                        split.ages, split.t2dm)


def dense_grid(timepoints) -> np.ndarray:
    return np.arange(timepoints[0], timepoints[-1] + 0.1,
                     2.0).astype(np.float32)


def medians(types, errors) -> list[int]:
    """``exp_figures.py::median_index_per_type``."""
    out = []
    for t in TYPES:
        sel = np.flatnonzero(types == t)
        if sel.size:
            out.append(int(sel[argmedian(errors[sel])]))
    return out


def errors(mdl, nn, betas, c, observed) -> np.ndarray:
    """Each subject's MSE, Tsit5 at the defaults (``exp_figures.py:230``)."""
    ys = simulate_cohort(mdl, nn, jnp.asarray(betas)[:, None], c).ys[:, :, 0]
    return np.mean((np.asarray(ys) - observed) ** 2, axis=1)


def dense_sims(mdl, nn, betas, c, dense_t) -> np.ndarray:
    lanes = (jnp.zeros((c.n, 0), jnp.float32) if betas is None
             else jnp.asarray(betas, jnp.float32)[:, None])
    return np.asarray(simulate_cohort(mdl, nn, lanes, c,
                                      saveat=jnp.asarray(dense_t),
                                      solver="rk4", substeps=4).ys[:, :, 0])


def ci_bound_sims(mdl, nn, betas, sigmas, c, idx, dense_t, steps: int,
                  method: str) -> dict:
    """``exp_figures.py:94-130`` with the JAX scan (``use_pallas=False``):
    Δβ bounds and the trajectories at β̂ + each finite bound."""
    idx = np.asarray(idx, int)
    sub = c._replace(individuals=jax.tree.map(lambda a: a[idx],
                                              c.individuals),
                     cpeptide=c.cpeptide[idx])
    b_sel = np.asarray(betas, np.float32)[idx]
    s_sel = np.asarray(sigmas, np.float32)[idx]
    prof = cohort_beta_profiles(mdl, nn, sub, sigmas=s_sel, lower=-10.0,
                                upper=15.0, steps=steps, center=b_sel,
                                substeps=8, use_pallas=False)
    ci = find_confidence_intervals(prof, method)
    sims = np.full((len(idx), 2, len(dense_t)), np.nan, np.float32)
    for pos, i in enumerate(idx):
        for side, d in enumerate((ci.lower[pos], ci.upper[pos])):
            if np.isfinite(d):
                sims[pos, side] = np.asarray(simulate(
                    mdl, {"neural": nn, "conditional": jnp.asarray(
                        float(b_sel[pos]) + d, jnp.float32)},
                    c.individual(int(i)), jnp.asarray(dense_t),
                    solver="rk4", substeps=4).ys[:, 0])
    return {"lower": np.asarray(ci.lower), "upper": np.asarray(ci.upper),
            "sims": sims}


def production_curves(net, nn, beta_grid, dg_grid) -> np.ndarray:
    """``exp_figures.py:286-293``."""
    def curve(beta):
        x1 = jnp.stack([dg_grid, jnp.full_like(dg_grid, np.exp(beta))])
        x0 = jnp.stack([jnp.zeros_like(dg_grid),
                        jnp.full_like(dg_grid, np.exp(beta))])
        return (jax.vmap(net.scalar, (None, 1))(nn, x1)
                - jax.vmap(net.scalar, (None, 1))(nn, x0))

    return np.asarray([curve(float(b)) for b in beta_grid])


def bounds(betas) -> tuple[float, float]:
    b = np.asarray(betas).ravel()
    return (float(b.min() - 0.1 * abs(b.min())),
            float(b.max() + 0.1 * abs(b.max())))


def refit(mdl, nn, c, bnds, iters: int) -> np.ndarray:
    return np.asarray(fit_betas(mdl, nn, c, initial_beta=-1.0,
                                bounds=bnds, lbfgs_iters=iters)[0])


def type_means(mdl, nn, test, bnds, iters: int, dense_t) -> dict:
    """The type-mean refit and curves (``exp_figures.py:380-412``)."""
    names = [t for t in TYPES if (test.types == t).any()]
    sel = [test.types == t for t in names]
    mean_c = np.stack([test.cpeptide[s].mean(axis=0) for s in sel])
    mc = build_cohort(np.stack([test.glucose[s].mean(axis=0) for s in sel]),
                      test.timepoints, mean_c,
                      np.array([test.ages[s].mean() for s in sel]),
                      np.array([t == "T2DM" for t in names]))
    b_mean = refit(mdl, nn, mc, bnds, iters)
    nn_ude = jnp.asarray(np.load(ART / "ude_neural_parameters.npz")[
        "nn_params"][0])
    return {"b_mean": b_mean,
            "sims_cude": dense_sims(mdl, nn, b_mean, mc, dense_t),
            "sims_ude": dense_sims(model(1), nn_ude, None, mc, dense_t)}


def cude(train, test, re_iters: int, ci_steps: int) -> dict:
    """The cUDE section's held arrays on the committed fits."""
    mdl = model()
    z = np.load(ART / "cude_neural_parameters.npz")
    best = int(load_checkpoint(ART / "cude_fit.npz")[1]["best_model_index"])
    nn = jnp.asarray(z["nn_params"][best])
    zf = np.load(ART / "cude_fit.npz")
    n_tr, n_te = len(train.ages), len(test.ages)
    b_train, b_test = zf["beta_train"][:n_tr], zf["beta_test"][:n_te]
    s_test = zf["sigma_test"][:n_te]
    c_train, c_test = cohort(train), cohort(test)
    dense_t = dense_grid(train.timepoints)
    err_train = errors(mdl, nn, b_train, c_train, train.cpeptide)
    err_test = errors(mdl, nn, b_test, c_test, test.cpeptide)
    idx_test = medians(test.types, err_test)
    beta_grid = np.quantile(b_train, np.linspace(0.05, 0.95, 20))
    dg_grid = np.linspace(0.0, np.ptp(train.glucose, axis=1).max(),
                          100).astype(np.float32)
    order = np.argsort(np.asarray(z["objectives"]))
    second = int(order[1]) if int(order[0]) == best else int(order[0])
    nn2 = jnp.asarray(z["nn_params"][second])
    bnds2 = bounds(z["betas"][second])
    b2_all = np.concatenate([refit(mdl, nn2, c, bnds2, re_iters)
                             for c in (c_train, c_test)])
    return {
        "best": best, "second": second,
        "err_train": err_train, "err_test": err_test,
        "idx_med_train": medians(train.types, err_train),
        "idx_med_test": idx_test,
        "ci": ci_bound_sims(mdl, nn, b_test, s_test, c_test, idx_test,
                            dense_t, ci_steps, "cantelli95"),
        "sims_test": dense_sims(mdl, nn, b_test, c_test, dense_t),
        "beta_grid": beta_grid, "dg_grid": dg_grid,
        "nn_curves": production_curves(mdl.net, nn, beta_grid,
                                       jnp.asarray(dg_grid)),
        "b2_all": b2_all,
        "rho2": spearman(b2_all, np.concatenate([b_train, b_test])),
        **type_means(mdl, nn, test, bounds(z["betas"][best]), re_iters,
                     dense_t)}


def covariate(test, ci_steps: int) -> dict:
    """The covariate section's median subjects and Raue-95 CI bounds."""
    mdl = model(3)
    zc, meta = load_checkpoint(ART / "cude_covariate_fit.npz")
    nn = jnp.asarray(np.load(ART / "cude_covariate_neural_parameters.npz")[
        "nn_params"][int(meta["best_model_index"])])
    n = len(test.ages)
    err = np.asarray(zc["sse_test"][:n]) / len(test.timepoints)
    idx = medians(test.types, err)
    return {"idx_med_test": idx,
            "ci": ci_bound_sims(mdl, nn, zc["beta_test"][:n],
                                zc["sigma_test"][:n], cohort(test), idx,
                                dense_grid(test.timepoints), ci_steps,
                                "raue95")}


def ude(test) -> dict:
    nn = jnp.asarray(np.load(ART / "ude_neural_parameters.npz")[
        "nn_params"][0])
    return {"sims": dense_sims(model(1), nn, None, cohort(test),
                               dense_grid(test.timepoints))}


def symbolic(train, test) -> dict:
    """The symbolic section on the committed k's (all subjects)."""
    both_t = np.concatenate([train.types, test.types])
    c_all = build_cohort(np.concatenate([train.glucose, test.glucose]),
                         train.timepoints,
                         np.concatenate([train.cpeptide, test.cpeptide]),
                         np.concatenate([train.ages, test.ages]),
                         both_t == "T2DM")
    obs = np.concatenate([train.cpeptide, test.cpeptide])
    ks = np.load(ART / "symreg_fit.npz")["ks"][:c_all.n]
    sym = symbolic_model()

    def sims(saveat):
        def one(k, ind):
            return simulate(sym, {"k": k}, ind, jnp.asarray(saveat,
                                                            jnp.float32),
                            solver="rk4", substeps=4).ys[:, 0]

        return np.asarray(jax.vmap(one)(jnp.asarray(ks, jnp.float32),
                                        c_all.individuals))

    err = np.mean((sims(train.timepoints) - obs) ** 2, axis=1)
    zf = np.load(ART / "cude_fit.npz")
    beta_grid = np.quantile(zf["beta_train"][:len(train.ages)],
                            [0.1, 0.5, 0.9])
    dg = np.linspace(0.0, np.ptp(train.glucose, axis=1).max(),
                     100).astype(np.float32)
    best = int(load_checkpoint(ART / "cude_fit.npz")[1]["best_model_index"])
    nn = jnp.asarray(np.load(ART / "cude_neural_parameters.npz")[
        "nn_params"][best])
    return {
        "sims": sims(dense_grid(train.timepoints)), "err": err,
        "idx_med": medians(both_t, err),
        "nn_curves": production_curves(model().net, nn, beta_grid,
                                       jnp.asarray(dg)),
        "sym_curves": np.asarray([symbolic_production(
            jnp.asarray(dg), beta_to_k(jnp.exp(jnp.asarray(b))))
            for b in beta_grid]),
        "disc_curves": np.asarray([discovered_production(
            jnp.asarray(dg), jnp.exp(jnp.asarray(b))) for b in beta_grid])}


def external() -> dict:
    f = np.load(ART / "fujita.npz")
    c = build_cohort(f["glucose"], f["timepoints"], f["cpeptide"], f["ages"],
                     np.zeros(len(f["ages"]), bool))
    ks = np.load(ART / "symreg_external_fit.npz")["ks"]
    dense = dense_grid(f["timepoints"])
    sym = symbolic_model()

    def one(k, ind):
        return simulate(sym, {"k": k}, ind, jnp.asarray(dense, jnp.float32),
                        solver="rk4", substeps=4).ys[:, 0]

    return {"sims": np.asarray(jax.vmap(one)(jnp.asarray(ks, jnp.float32),
                                             c.individuals))}


def suppression() -> dict:
    """``exp_figures.py:706-737``: λ = 0.1's best restart on its
    regenerated training population."""
    z, meta = load_checkpoint(ART / "suppression_lambda=0.1.npz")
    best = int(np.argmin(z["objectives"]))
    tp = np.linspace(0.0, 30.0, 8)
    data, _ = jsup.generate_data(
        [0.5, 2.5, 5.0, 7.5, 10.0, 12.5], [15, 3, 3, 3, 3, 10], tp,
        noise_multiplicative=float(meta.get("noise", 0.1)),
        rng=np.random.default_rng(27052023))
    dense = np.linspace(0.0, 30.0, 61).astype(np.float32)
    ys = jsup.simulate_population(
        jsup.suppression_net(depth=5, width=3),
        jnp.asarray(z["nn_params"][best]),
        jnp.asarray(z["thetas"][best], jnp.float32),
        jnp.asarray(data[:, :, 0], jnp.float32), jnp.asarray(dense)).ys
    gt = np.asarray(z["gt_train"])
    return {"restart": best, "ys": np.asarray(ys),
            "idx": np.argsort(gt)[[0, len(gt) // 2, len(gt) - 1]]}


def saem(train, test) -> dict:
    """``exp_figures.py:795-843``: each type's posterior-predictive band."""
    z = np.load(ART / "saem_fit.npz")
    types = np.concatenate([train.types, test.types])
    c_all = build_cohort(np.concatenate([train.glucose, test.glucose]),
                         train.timepoints,
                         np.concatenate([train.cpeptide, test.cpeptide]),
                         np.concatenate([train.ages, test.ages]),
                         types == "T2DM")
    mdl, nn = model(), jnp.asarray(z["nn_params"])
    dense = dense_grid(train.timepoints)
    out = {}
    for t in TYPES:
        sel = np.flatnonzero(types == t)
        i = int(sel[np.argsort(z["beta_map"][sel])[len(sel) // 2]])
        ind = jax.tree.map(lambda a: a[i], c_all.individuals)
        sols = np.asarray(jax.vmap(lambda b: simulate(
            mdl, {"neural": nn, "conditional": b}, ind, jnp.asarray(dense),
            solver="rk4", substeps=4).ys[:, 0])(
                jnp.asarray(z["beta_chains"][i], jnp.float32)))
        out[t] = {"subject": i, "p05": np.quantile(sols, 0.05, axis=0),
                  "p95": np.quantile(sols, 0.95, axis=0),
                  "median": np.median(sols, axis=0)}
    return out


def pvalues(train, test) -> dict:
    ages = np.concatenate([train.ages, test.ages])
    types = np.concatenate([train.types, test.types])
    return {f"{a}-{b}": mann_whitney_u(ages[types == a], ages[types == b])
            for a, b in (("NGT", "IGT"), ("NGT", "T2DM"), ("IGT", "T2DM"))}


def jsonable(x, digits: int = 8):
    """Nested arrays as lists of floats rounded to ``digits`` significant
    digits (NaN as null, infinities as strings)."""
    if isinstance(x, dict):
        return {str(k): jsonable(v, digits) for k, v in x.items()}
    if isinstance(x, (list, tuple, np.ndarray)):
        return [jsonable(v, digits) for v in x]
    if isinstance(x, str):
        return x
    if isinstance(x, (int, np.integer)):
        return int(x)
    x = float(x)
    if np.isnan(x):
        return None
    if np.isinf(x):
        return "inf" if x > 0 else "-inf"
    return float(f"{x:.{digits}g}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=OUT)
    args = p.parse_args()
    train, test = load_npz(ART / "ohashi.npz")
    ref, seconds = {}, {}
    for name, fn in (("data", lambda: pvalues(train, test)),
                     ("cude", lambda: cude(train, test, 1000, 10_000)),
                     ("covariate", lambda: covariate(test, 10_000)),
                     ("ude", lambda: ude(test)),
                     ("symbolic", lambda: symbolic(train, test)),
                     ("external", external),
                     ("suppression", suppression),
                     ("saem", lambda: saem(train, test))):
        t0 = time.perf_counter()
        ref[name] = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"[{name}] {seconds[name]:.1f} s", file=sys.stderr, flush=True)
    ref["source"] = ("scripts/figures_reference.py: the JAX package on the "
                     f"CPU (jax {jax.__version__}), committed artifacts, "
                     "full sizes")
    ref["seconds"] = seconds
    # the p-values whole (held to rtol 1e-12), the arrays to 8 digits
    out = {k: jsonable(v, 17 if k == "data" else 8) for k, v in ref.items()}
    args.out.write_text(json.dumps(out) + "\n")
    print(json.dumps({"out": str(args.out), "seconds": seconds}))


if __name__ == "__main__":
    main()
