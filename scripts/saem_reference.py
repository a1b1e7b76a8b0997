"""The JAX package's SAEM experiments on the CPU: the yardstick of the port's
SAEM (exp06, exp06a, exp06b).

    python scripts/saem_reference.py [--keys 10] [--out FILE]
        [--only exp06 exp06a exp06b miss] [--pretrain FILE]

Runs the bodies of ``experiments/exp06_saem.py``, ``exp06a_saem_symreg.py``
and ``exp06b_saem_discovered.py`` with the JAX package's functions on the
cohorts of ``artifacts/ohashi.npz`` (exp06 from the committed pre-train,
``artifacts/saem_pretrain.npz``), first at the experiment scripts' own
keys and then at ``--keys`` further pairs of keys, and prints one JSON
object (also written to ``--out``):

* ``reproduction``: each metric at the scripts' own keys beside the committed
  ``results/exp06*_metrics.json`` (which came from a TPU);
* ``spread``: each metric's min, max, mean and sd over all the keys' runs;
  the port's full runs are held to it, since the two packages' random
  streams differ;
* ``miss``: how far JAX's own ``individual_maps`` and ``individual_mles``,
  started from the θ, σ, η and Ω of ``artifacts/saem_fit.npz``, are from
  that file's ``beta_map`` and ``beta_mle``: the largest miss and its
  subject, the largest over the other subjects, the median, and each
  subject's estimate.

``--pretrain FILE`` starts exp06 from another pre-train (``nn_params[0]``
of FILE, e.g. one the port retrained at a seed), so the port's run from it
can be held to JAX's own spread from the same network.

A key pair is (SAEM key, posterior key): exp06 uses (1, 2), exp06a and
exp06b (270523, 1); the further pairs are (1000 + j, 2000 + j) for
j = 1..keys.  Every run has the scripts' depth: 180 SAEM iterations with
a burn-in of 80, 25 MCMC steps an iteration.  On 8 CPU cores a key pair
takes about 80 s of exp06 and 11 s of exp06a or exp06b (``seconds``).
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
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from conditional_ude_tpu.data.ohashi import load_npz  # noqa: E402
from conditional_ude_tpu.fit import saem  # noqa: E402
from conditional_ude_tpu.models.cpeptide import (  # noqa: E402
    CPeptideModel,
    build_cohort,
    simulate_cohort,
)
from conditional_ude_tpu.nn import chain  # noqa: E402
from conditional_ude_tpu.utils.stats import spearman  # noqa: E402

ART = REPO / "artifacts"
RESULTS = REPO / "results"
SCRIPT_SEED = 270523
N_MH, MAP_ITERS = 3000, 100
TYPES = ("NGT", "IGT", "T2DM")


def _cohort(split):
    return build_cohort(split.glucose, split.timepoints, split.cpeptide,
                        split.ages, split.t2dm)


def _both(train, test):
    cat = {f: np.concatenate([getattr(train, f), getattr(test, f)])
           for f in ("glucose", "cpeptide", "ages", "types", "first_phase")}
    cohort = build_cohort(cat["glucose"], train.timepoints, cat["cpeptide"],
                          cat["ages"], cat["types"] == "T2DM")
    return cat, cohort


def _per_type(types, values):
    return {t: float(np.mean(values[types == t])) for t in TYPES
            if (types == t).any()}


def _cohort_mse(model, theta, betas, cohort):
    """``experiments/common.py::cohort_mse``: Tsit5 at the defaults."""
    res = simulate_cohort(model, theta, jnp.asarray(betas)[:, None], cohort)
    mse = np.mean((np.asarray(res.ys[:, :, 0])
                   - np.asarray(cohort.cpeptide)) ** 2, axis=1)
    return np.where(np.asarray(res.success), mse, np.inf)


def _post_hoc(ll, cohort, theta, sigma, eta, omega, init, post_key):
    """Posterior chains, MAPs and MLEs, as the experiment scripts call
    them."""
    chains, acc = _chains(ll, cohort)(theta, sigma, post_key, init, eta,
                                      omega)
    post_mean = np.asarray(chains[:, N_MH // 2:]).mean(axis=1)
    maps = np.asarray(_maps(ll, cohort)(theta, sigma, init, eta, omega))
    mles = np.asarray(_mles(ll, cohort)(theta, sigma, init))
    return chains, np.asarray(acc), post_mean, maps, mles


_JIT = {}


def _cached(name, make):
    if name not in _JIT:
        _JIT[name] = make()
    return _JIT[name]


def _chains(ll, cohort):
    return _cached(("chains", id(ll)), lambda: jax.jit(
        lambda th, s, k, init, eta, om: saem.posterior_chains(
            ll, th, s, cohort.individuals, cohort.cpeptide, k, init,
            eta=eta, omega=om, n_steps=N_MH)))


def _maps(ll, cohort):
    return _cached(("maps", id(ll)), lambda: jax.jit(
        lambda th, s, init, eta, om: saem.individual_maps(
            ll, th, s, cohort.individuals, cohort.cpeptide, init, eta=eta,
            omega=om, max_iters=MAP_ITERS)))


def _mles(ll, cohort):
    return _cached(("mles", id(ll)), lambda: jax.jit(
        lambda th, s, init: saem.individual_mles(
            ll, th, s, cohort.individuals, cohort.cpeptide, init,
            max_iters=MAP_ITERS)))


class Exp06:
    """``experiments/exp06_saem.py``'s body after the pre-train."""

    def __init__(self, pretrain: Path = ART / "saem_pretrain.npz"):
        train, test = load_npz(ART / "ohashi.npz")
        self.net = chain(4, 2, "tanh", input_dims=2)
        self.model = CPeptideModel(kind="conditional", net=self.net)
        self.cohort_train = _cohort(train)
        self.cat, self.cohort_all = _both(train, test)
        self.nn0 = jnp.asarray(np.load(pretrain)["nn_params"][0])
        self.ll = saem.cude_loglik(self.model, self.cohort_all.timepoints)
        cfg = saem.SAEMConfig(iterations=180, burnin=80, n_mcmc_steps=25,
                              initial_mcmc_steps=25)
        self.run = {mode: self._saem(dataclasses.replace(
            cfg, omega_as_variance=mode)) for mode in (False, True)}

    def _saem(self, cfg):
        return jax.jit(lambda k: saem.saem_cude(
            self.model, self.cohort_train, self.nn0, k, cfg))

    def block(self, res, post_key) -> dict:
        init = jnp.full((self.cohort_all.n,), float(res.eta))
        _, acc, post_mean, maps, mles = _post_hoc(
            self.ll, self.cohort_all, res.theta, res.sigma, res.eta,
            res.omega, init, post_key)
        mse = _cohort_mse(self.model, res.theta, maps, self.cohort_all)
        return {
            "final_nll": float(res.nll_trace[-1]),
            "sigma": float(res.sigma),
            "omega": float(res.omega),
            "eta": float(res.eta),
            "mse_map_per_type": _per_type(self.cat["types"], mse),
            "posterior_acceptance_mean": float(np.mean(acc)),
            "map_mle_correlation": float(np.corrcoef(maps, mles)[0, 1]),
            "posterior_map_correlation": float(
                np.corrcoef(post_mean, maps)[0, 1]),
            "posterior_map_spearman": spearman(post_mean, maps)}

    def __call__(self, saem_key: int, post_key: int) -> dict:
        res = self.run[False](jax.random.key(saem_key))
        out = self.block(res, jax.random.key(post_key))
        out.update({"final_acceptance": float(res.acceptance_trace[-1]),
                    "final_proposal_std": float(res.proposal_std_trace[-1])})
        res_c = self.run[True](jax.random.key(saem_key))
        out["consistent_omega"] = self.block(res_c, jax.random.key(post_key))
        return out

    def miss(self) -> dict:
        """JAX's MAPs and MLEs from the committed fit's fixed effects."""
        fit = np.load(ART / "saem_fit.npz")
        theta, sigma, eta, omega = (jnp.asarray(fit[k]) for k in
                                    ("nn_params", "sigma", "eta", "omega"))
        init = jnp.full((self.cohort_all.n,), float(eta))
        maps = np.asarray(_maps(self.ll, self.cohort_all)(
            theta, sigma, init, eta, omega))
        mles = np.asarray(_mles(self.ll, self.cohort_all)(theta, sigma, init))
        out = {}
        for name, got in (("beta_map", maps), ("beta_mle", mles)):
            diff = np.abs(got - fit[name])
            worst = int(np.argmax(diff))
            out[name] = {"max_abs": float(diff.max()), "subject": worst,
                         "max_abs_others": float(np.delete(diff, worst).max()),
                         "median_abs": float(np.median(diff)),
                         "values": got.tolist()}
        return out


class Exp06Symbolic:
    """``experiments/exp06a_saem_symreg.py`` (``discovered=False``) or
    ``exp06b_saem_discovered.py``'s body."""

    def __init__(self, discovered: bool):
        train, test = load_npz(ART / "ohashi.npz")
        self.cat, self.cohort = _both(train, test)
        self.discovered = discovered
        tp = self.cohort.timepoints
        self.ll = (saem.discovered_loglik(tp) if discovered
                   else saem.symbolic_loglik(tp))
        cfg = saem.SAEMConfig(iterations=180, burnin=80, n_mcmc_steps=25,
                              initial_mcmc_steps=25, pop_update_lbfgs=True,
                              update_prior_mean=False)
        fn, start = ((saem.saem_discovered, 0.43) if discovered
                     else (saem.saem_symbolic, 75.0))
        self.run = jax.jit(lambda k: fn(self.cohort, start, k, cfg))

    def __call__(self, saem_key: int, post_key: int) -> dict:
        res = self.run(jax.random.key(saem_key))
        init = jnp.zeros((self.cohort.n,))
        zero = jnp.asarray(0.0)
        _, acc, _, maps, mles = _post_hoc(
            self.ll, self.cohort, res.theta, res.sigma, zero, res.omega,
            init, jax.random.key(post_key))
        theta_map = float(res.theta) * np.exp(maps)
        tag = "b" if self.discovered else "km"
        out = {
            f"{tag}_pop": float(res.theta),
            "sigma": float(abs(res.sigma)),
            "omega": float(res.omega),
            "final_nll": float(res.nll_trace[-1]),
            f"{tag}_map_median": float(np.median(theta_map)),
            "map_mle_correlation": float(np.corrcoef(maps, mles)[0, 1]),
            "posterior_acceptance_mean": float(np.mean(acc))}
        if self.discovered:
            out["spearman_b_map_first_phase"] = spearman(
                theta_map, self.cat["first_phase"])
        return out


def flatten(metrics, prefix: str = "") -> dict[str, float]:
    out = {}
    for k, v in metrics.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[prefix + k] = float(v)
    return out


def spread(runs: list[dict]) -> dict[str, dict[str, float]]:
    flat = [flatten(r) for r in runs]
    out = {}
    for k in flat[0]:
        v = np.asarray([f[k] for f in flat])
        out[k] = {"min": float(v.min()), "max": float(v.max()),
                  "mean": float(v.mean()), "sd": float(v.std(ddof=1))}
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--keys", type=int, default=10,
                   help="key pairs beyond the scripts' own")
    p.add_argument("--only", nargs="+",
                   default=["miss", "exp06", "exp06a", "exp06b"])
    p.add_argument("--pretrain", type=Path, default=ART / "saem_pretrain.npz",
                   help="exp06's pre-train (nn_params[0] starts SAEM), e.g. "
                        "one the port retrained")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args()
    pairs = [(1000 + j, 2000 + j) for j in range(1, args.keys + 1)]
    report = {"keys": args.keys}
    exp06 = Exp06(args.pretrain) if {"miss", "exp06"} & set(args.only) \
        else None
    if "miss" in args.only:
        report["miss"] = exp06.miss()
        print(json.dumps({"miss": {k: {kk: vv for kk, vv in v.items()
                                       if kk != "values"}
                                   for k, v in report["miss"].items()}}),
              file=sys.stderr, flush=True)
    experiments = {"exp06": (lambda: exp06, (1, 2)),
                   "exp06a": (lambda: Exp06Symbolic(False), (SCRIPT_SEED, 1)),
                   "exp06b": (lambda: Exp06Symbolic(True), (SCRIPT_SEED, 1))}
    for name, (make, own) in experiments.items():
        if name not in args.only:
            continue
        run = make()
        runs, seconds = [], []
        for pair in [own, *pairs]:
            t0 = time.perf_counter()
            runs.append(run(*pair))
            seconds.append(time.perf_counter() - t0)
            print(json.dumps({name: pair, "seconds": seconds[-1],
                              **flatten(runs[-1])}), file=sys.stderr,
                  flush=True)
        committed = json.loads((RESULTS / f"{name}_metrics.json").read_text())
        report[name] = {
            "seconds": seconds,
            "reproduction": {
                k: {"jax_cpu": v, "committed": flatten(committed).get(k)}
                for k, v in flatten(runs[0]).items()},
            "spread": spread(runs),
            "runs": runs}
        if args.out is not None:
            args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    if args.out is not None:
        args.out.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
