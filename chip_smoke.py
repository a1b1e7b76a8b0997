"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py                  # from the repository root
    python3 chip_smoke.py --kernels-only   # steps 1-3 only; the last line
                                           # is {"ok": null, "partial": ...}

1. builds the five kernel sources from ``conditional_ude_tpu_torch/csrc``
   (one ``nvcc`` each, all started together; each source holds a 2-input
   body and the covariate model's 3-input body) and prints ptxas's
   registers and spills of all ten bodies;
2. holds each body against its plain PyTorch version on the card, at the
   main path's shape and at a ragged shape with random per-lane weights and
   one lane of huge weights (the covariate bodies with real ages):
   K4 (cohort RK4) and K1 (population screen) at rtol 1e-5 / atol 1e-6,
   K2 (value + gradient on packed lanes) and K5 (value + gradient on
   restart lanes) at rtol 1e-4 with gradients within 2e-4 of each row's
   largest, K3 (adaptive Tsit5) with the same ``ok`` mask and rtol 2e-2 /
   atol 1e-3; K1c-K5c are the covariate bodies, held alike, and K1c-K4c
   must read the age: two cohorts that differ only in the age column give
   different results.  K1 and K3 are also held at the enlarged
   multi-start's shapes (400,000 x 57 designs, 131,328 lanes).  K5 is also
   held against K2's packed route on the same inputs, at 2,304 x 57 and at
   the ragged shape: two layouts of one function, equal up to the order of
   the sums.  On real ages a random network is saturated and its weight
   gradient is what float32 leaves of cancelling terms, so there (and on
   the committed trained candidates, for both bodies) the weight gradient
   of each layout is held to a float64 witness, within 256 float32
   roundings of the row's largest sum of absolute terms;
3. times each body and its plain version at the path's shape (CUDA events),
   K2 also at K5's shape, and works out the bound of each from its inputs;
4. runs the frozen path of exp02 (``run_frozen_pipeline``) at full width
   and checks it against the committed results; K4's launches are counted
   over it;
5. runs the retrain path of exp02 (``run_training_pipeline``) at full
   width: 25,000 designs screened on the 57-subject fit split, 25 restarts
   of 1000 Adam and 1000 L-BFGS steps, the Tsit5 re-rank, selection and the
   (beta, sigma) refit; K1, K2 and K3's launches are counted over it, and
   the result is held to the spread of the JAX package's per-seed runs;
6. runs the frozen path of exp07, the covariate model (``covariate=True``),
   at full width and checks it against exp07's committed results; K4c's
   launches are counted over it;
7. runs the retrain path of exp07 at full width, as in 5; K1c, K2c and
   K3c's launches are counted over it, and the result is held to limits
   widened from the one JAX run of exp07;
8. runs the frozen path of exp02_xl, the enlarged multi-start (``xl=True``):
   the 96 committed candidates on the 25 validation subjects, the refit,
   the guarded selection's refit and both profile scans (K4 again), checked
   against exp02_xl's committed results;
9. runs the retrain path of exp02_xl at the width where the value+grad
   route switches to K5: 400,000 designs screened, 2,304 restarts (131,328
   lanes) refined; K5's launches are counted over it, K2's must be 0, and
   the guarded result is held to exp02's retrain limits;
10. trains the covariate model at that width with cut step counts
    (``train_conditional``), which counts K5c's launches: no experiment of
    the package pairs the covariate model with a multi-start this wide.

Every failure raises, so the exit code is non-zero.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
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

REPO = Path(__file__).resolve().parent
ARTIFACTS = REPO / "artifacts"
RK4_RTOL, RK4_ATOL = 1e-5, 1e-6          # K4, K1: the JAX suite's RK4 kernel
GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-4        # K2: tests/test_pallas_grad.py
TSIT5_RTOL, TSIT5_ATOL = 2e-2, 1e-3      # K3: tests/test_pallas_tsit5.py
# K5 and K2's packed route against float64: float32 roundings (2^-23) of a
# gradient row's largest sum of absolute per-point terms.  A restart's row
# sums 57 x 69 = 3,933 terms one after another, and each term carries the
# rounding of the forward solve through its residual, so the limit is 256
# roundings (3.1e-5 of that sum), not 1
EPS32, WITNESS_EPS = 2.0 ** -23, 256.0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside the
# tensor cores, and special-function (SFU) results/s: 16 per SM per clock,
# 132 SMs at the 1.98 GHz boost clock
PEAK_BYTES, PEAK_FLOPS, PEAK_SFU = 3.35e12, 67e12, 132 * 16 * 1.98e9
# operations of the canonical network, counted from csrc/cude_mlp.cuh:
# 4 + 4 tanh layers and the softplus head (multiplies, adds, the softplus
# arithmetic), and the transcendentals (8 tanhf, expf, log1pf)
MLP_FLOPS, MLP_SFU = 59, 10

# the TPU kernel each body replaces: the function that builds its 2-input
# body, and the line that adds the age input to its 3-input body
REPLACES = {"K4": "conditional_ude_tpu/ops/pallas_rk4.py:98",
            "K1": "conditional_ude_tpu/ops/pallas_rk4.py:251",
            "K2": "conditional_ude_tpu/ops/pallas_grad.py:314",
            "K3": "conditional_ude_tpu/ops/pallas_tsit5.py:42",
            "K4c": "conditional_ude_tpu/ops/pallas_rk4.py:115",
            "K1c": "conditional_ude_tpu/ops/pallas_rk4.py:291",
            "K2c": "conditional_ude_tpu/ops/pallas_grad.py:383",
            "K3c": "conditional_ude_tpu/ops/pallas_tsit5.py:61",
            "K5": "conditional_ude_tpu/ops/pallas_grad.py:188",
            "K5c": "conditional_ude_tpu/ops/pallas_grad.py:222"}
# the enlarged multi-start at the width where the value+grad route switches
# from K2 to K5: 2,304 restarts x 57 fit subjects = 131,328 lanes > 131,072
XL_INITS, XL_RESTARTS = 400_000, 2304
XL_ADAM, XL_LBFGS = 1000, 1000     # exp02_xl retrain: the full step counts
XLC_ADAM, XLC_LBFGS = 100, 50      # the covariate model at that width: cut


def mlp_flops(d: int) -> int:
    """Arithmetic of one network evaluation on ``d`` inputs: a 3rd input
    adds a multiply and an add to each of layer 1's four units."""
    return MLP_FLOPS + 8 * (d - 2)


def rhs_flops(d: int) -> int:
    return mlp_flops(d) + 16      # + ΔG blend and the two-state kinetics


def rk4_step_flops(d: int) -> int:
    return 4 * rhs_flops(d) + 30


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(out: torch.Tensor, ref: torch.Tensor, what: str,
            rtol: float = RK4_RTOL, atol: float = RK4_ATOL) -> float:
    """Kernel against plain: identical non-finite lanes, finite lanes within
    rtol / atol; returns the max absolute error."""
    fin_k, fin_p = torch.isfinite(out), torch.isfinite(ref)
    if not torch.equal(fin_k, fin_p):
        raise AssertionError(f"{what}: non-finite lanes differ "
                             f"({int((~fin_k).sum())} vs {int((~fin_p).sum())})")
    err = (out[fin_p] - ref[fin_p]).abs()
    bad = err > atol + rtol * ref[fin_p].abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / ref[fin_p].abs().clamp_min(1e-30)).max()) \
        if err.numel() else 0.0
    log(f"[kernel] {what}: {out.numel()} values, {int((~fin_p).sum())} "
        f"non-finite, max abs err {max_abs:.3e}, max rel err {max_rel:.3e}")
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} values outside "
                             f"rtol {rtol} / atol {atol}")
    return max_abs


def compare_scaled(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Gradient rows divided by each row's largest |reference| entry
    (``tests/test_pallas_grad.py:61-64``), within atol 2e-4; rows with a
    non-finite entry must be the same rows.  Returns the max absolute error
    of the unscaled finite rows."""
    fin_k = torch.isfinite(out).all(-1)
    fin_p = torch.isfinite(ref).all(-1)
    if not torch.equal(fin_k, fin_p):
        raise AssertionError(f"{what}: non-finite rows differ")
    o, r = out[fin_p], ref[fin_p]
    scale = r.abs().amax(-1, keepdim=True).clamp_min(1e-6)
    err = ((o - r) / scale).abs()
    max_scaled = float(err.max()) if err.numel() else 0.0
    max_abs = float((o - r).abs().max()) if err.numel() else 0.0
    log(f"[kernel] {what}: {r.shape[0]} finite rows, {int((~fin_p).sum())} "
        f"non-finite, max scaled err {max_scaled:.3e}, max abs err "
        f"{max_abs:.3e}")
    if max_scaled > GRAD_ATOL:
        raise AssertionError(f"{what}: scaled gradient error {max_scaled:.3e}"
                             f" > {GRAD_ATOL}")
    return max_abs


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_ms(fn):
    """``(fn(), milliseconds)`` of one call by CUDA events, no warm-up."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(n_bytes: float, flops: float, sfu: float) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it: bytes
    over the memory rate, or operations (float32 arithmetic or
    transcendentals) over their peak rates."""
    times = {"bytes": n_bytes / PEAK_BYTES,
             "operations": max(flops / PEAK_FLOPS, sfu / PEAK_SFU)}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def huge_weights(d: int) -> np.ndarray:
    """ΔG → head weights of 1e20 on a ``d``-input network: a rising glucose
    curve drives the trajectory past float32."""
    w1 = np.zeros((4, d))
    w1[:, 0] = 1e20
    return np.concatenate([w1.ravel(), np.zeros(4), np.eye(4).ravel(),
                           np.zeros(4), np.full(4, 1e20), [0.0]])


def glorot(rng: np.random.Generator, net, n: int) -> np.ndarray:
    bounds = [np.sqrt(6.0 / (fi + fo)) for fi, fo in net.layer_dims]
    return np.concatenate(
        [np.concatenate([rng.uniform(-b, b, (n, fo * fi)), np.zeros((n, fo))],
                        axis=1)
         for b, (fi, fo) in zip(bounds, net.layer_dims)], axis=1)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="build, compare and time the kernels, then "
                             "stop before the paths (the last line says "
                             "ok: null, so it passes for no full run)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is visible")
    sys.path.insert(0, str(REPO))
    from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
    from conditional_ude_tpu_torch.fit.train import (
        TrainConfig,
        train_conditional,
    )
    from conditional_ude_tpu_torch.models.cpeptide import (
        CPeptideModel,
        build_cohort,
    )
    from conditional_ude_tpu_torch.nn import chain
    from conditional_ude_tpu_torch.ops import (
        cuda_build,
        lane_grad,
        population_grad,
        rk4_cohort,
        rk4_population,
        tsit5_cohort,
    )
    from conditional_ude_tpu_torch.ops.interp import linspace
    from conditional_ude_tpu_torch.pipeline import (
        SEED,
        run_frozen_pipeline,
        run_training_pipeline,
    )
    from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint
    from conditional_ude_tpu_torch.utils.stats import (
        latin_hypercube,
        stratified_split,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{kind}, {torch.cuda.device_count()} visible")

    # -- build: one nvcc per source, all started together --------------------
    kernels = {"K4": rk4_cohort, "K1": rk4_population, "K2": lane_grad,
               "K3": tsit5_cohort, "K5": population_grad}
    t0 = time.perf_counter()
    built = cuda_build.build_all([m.kernel.source for m in kernels.values()])
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")
    for kid, mod in kernels.items():
        lib, sec, build_log = built[mod.kernel.source]
        log(f"[build] {kid} {lib.name} in {sec:.1f} s")
        body = kid
        for line in build_log.splitlines():
            if "entry function" in line:     # the template's input count
                body = kid + ("c" if "ILi3E" in line else "")
            elif "registers" in line or "spill" in line:
                log(f"[ptxas] {body}: {line.strip()}")

    def library(kid: str):
        mod = kernels[kid[:2]]
        return mod.kernel_age if kid.endswith("c") else mod.kernel

    def launch_count(kid: str) -> int:
        mod = kernels[kid[:2]]
        return mod.launches_age if kid.endswith("c") else mod.launches

    def reset_counts(*kids: str) -> None:
        for kid in kids:
            setattr(kernels[kid[:2]],
                    "launches_age" if kid.endswith("c") else "launches", 0)

    f32 = dict(dtype=torch.float32, device=dev)
    train, test = load_npz(ARTIFACTS / "ohashi.npz")
    both = OhashiSplit.concatenate(train, test)
    cohort = build_cohort(both.glucose, both.timepoints, both.cpeptide,
                          both.ages, both.t2dm, dev)
    tp = tuple(float(t) for t in cohort.timepoints)
    idx_fit, _ = stratified_split(np.random.default_rng(SEED), train.types,
                                  0.7)
    fit = train.subset(idx_fit)
    fit_cohort = build_cohort(fit.glucose, fit.timepoints, fit.cpeptide,
                              fit.ages, fit.t2dm, dev)
    n_fit = fit_cohort.n
    rng = np.random.default_rng(2705)
    results = {}
    wide = {}       # times of earlier kernels at the enlarged multi-start
    fit_ckpt, meta = load_checkpoint(ARTIFACTS / "cude_fit.npz")
    cov_ckpt, cov_meta = load_checkpoint(ARTIFACTS / "cude_covariate_fit.npz")
    cov_cand = np.load(ARTIFACTS / "cude_covariate_neural_parameters.npz")

    def kernel_phase(d: int) -> None:
        """Steps 2 and 3 for the bodies on ``d`` inputs."""
        sfx = "c" if d == 3 else ""
        with_age = d == 3
        net = chain(4, 2, input_dims=d)
        p, n_kin = net.num_params, 4 + with_age
        fit_args = (fit_cohort.glucose, fit_cohort.cpeptide,
                    fit_cohort.kinetics(with_age=with_age), tp)

        def designs(g: int, n: int):
            nn = torch.as_tensor(glorot(rng, net, g), **f32)
            lhs = latin_hypercube(rng, g, n, -2.0, 0.0)
            return nn, torch.as_tensor(lhs, **f32)

        def ragged(r: int, n: int):
            """r restarts of random weights (the last one huge) on the first
            n subjects, the last of them on a rising glucose curve."""
            pick = np.arange(n)
            glucose = both.glucose[pick].copy()
            glucose[-1] = [5.0, 6.0, 7.0, 8.0, 9.0]
            c = build_cohort(glucose, both.timepoints, both.cpeptide[pick],
                             both.ages[pick], both.t2dm[pick], dev)
            nn = glorot(rng, net, r) * rng.uniform(0.5, 3.0, (r, 1))
            nn[-1] = huge_weights(d)
            return (torch.as_tensor(nn, **f32),
                    torch.as_tensor(rng.uniform(-3.0, 0.5, (r, n)), **f32),
                    c.glucose, c.cpeptide, c.kinetics(with_age=with_age), tp)

        # -- K4: cohort RK4 ---------------------------------------------------
        s = 500                    # one chunk of a profile scan: 500 points
        if d == 2:                 # the census: Δβ points × all 117 subjects
            prof_cohort = cohort
            nn_row = np.load(ARTIFACTS / "cude_neural_parameters.npz")[
                "nn_params"][meta["best_model_index"]]
            centre = torch.as_tensor(
                np.concatenate([fit_ckpt["beta_train"],
                                fit_ckpt["beta_test"]]), device=dev)
            grid = torch.as_tensor(linspace(-10.0, 10.0, 1000)[:s],
                                   device=dev)
            chunk = f"census chunk ({s} x {cohort.n})"
        else:                      # exp07's test profile: β points × 35
            prof_cohort = build_cohort(test.glucose, test.timepoints,
                                       test.cpeptide, test.ages, test.t2dm,
                                       dev)
            best = cov_meta["best_model_index"]
            nn_row = cov_cand["nn_params"][best]
            lb, ub = cov_meta["bounds"]
            centre = torch.zeros(prof_cohort.n, **f32)
            grid = torch.as_tensor(linspace(lb - 1.0, ub + 1.0, 10_000)[:s],
                                   device=dev)
            chunk = f"test profile chunk ({s} x {prof_cohort.n})"
        n = prof_cohort.n
        lanes = s * n

        def expand(x):
            return x.expand(s, *x.shape).reshape(lanes, *x.shape[1:])

        prof = (torch.as_tensor(nn_row, device=dev).expand(lanes, -1),
                (grid[:, None] + centre[None, :]).reshape(-1),
                expand(prof_cohort.glucose), expand(prof_cohort.cpeptide),
                expand(prof_cohort.kinetics(with_age=with_age)))
        err = compare(rk4_cohort.cohort_sse(net, *prof, tp, 8),
                      rk4_cohort.cohort_sse_reference(net, *prof, tp, 8),
                      f"K4{sfx} {chunk}")
        # ragged lane count, per-lane random weights and subjects, one lane
        # of huge weights on a rising glucose curve
        n_lanes = 1237
        pick = rng.integers(0, cohort.n, n_lanes)
        nn_r = glorot(rng, net, n_lanes)
        nn_r[-1] = huge_weights(d)
        glucose = both.glucose[pick].copy()
        glucose[-1] = [5.0, 6.0, 7.0, 8.0, 9.0]
        k4_ragged = (torch.as_tensor(nn_r, **f32),
                     torch.as_tensor(rng.uniform(-4.0, 1.0, n_lanes), **f32),
                     torch.as_tensor(glucose, **f32),
                     torch.as_tensor(both.cpeptide[pick], **f32),
                     cohort.kinetics(with_age=with_age)[
                         torch.as_tensor(pick, device=dev)].contiguous())
        out = rk4_cohort.cohort_sse(net, *k4_ragged, tp, 8)
        if not bool(torch.isinf(out[-1])):
            raise AssertionError(f"K4{sfx}: the huge-weight lane's SSE is "
                                 "not inf")
        err = max(err, compare(out, rk4_cohort.cohort_sse_reference(
            net, *k4_ragged, tp, 8), f"K4{sfx} ragged (1237 lanes)"))
        ms = cuda_ms(lambda: rk4_cohort.cohort_sse(net, *prof, tp, 8),
                     reps=20)
        plain = cuda_ms(lambda: rk4_cohort.cohort_sse_reference(
            net, *prof, tp, 8), reps=3)
        results["K4" + sfx] = dict(
            err=err, ms=ms, plain=plain, shape=f"{chunk[:-1]}, {lanes} lanes)",
            bound=bound(4 * (p + lanes * (12 + n_kin)),
                        lanes * (32 * rk4_step_flops(d) + mlp_flops(d) + 10),
                        lanes * (32 * 4 * MLP_SFU + MLP_SFU)))

        # -- K1: population screen --------------------------------------------
        nn_s, b_s = designs(4096, n_fit)
        err = compare(
            rk4_population.population_sse(net, nn_s, b_s, *fit_args, 8),
            rk4_population.population_sse_reference(net, nn_s, b_s,
                                                    *fit_args, 8),
            f"K1{sfx} screen shape (4096 x {n_fit})")
        r_args = ragged(1237, 8)
        out = rk4_population.population_sse(net, *r_args, 8)
        if not bool(torch.isinf(out[-1])):
            raise AssertionError(f"K1{sfx}: the huge-weight restart's mean "
                                 "is not inf")
        err = max(err, compare(out, rk4_population.population_sse_reference(
            net, *r_args, 8), f"K1{sfx} ragged (1237 x 8)"))
        # the retrain path's own shape: all 25,000 designs on the fit split
        g_full = 25_000
        nn_s, b_s = designs(g_full, n_fit)
        err = max(err, compare(
            rk4_population.population_sse(net, nn_s, b_s, *fit_args, 8),
            rk4_population.population_sse_reference(net, nn_s, b_s,
                                                    *fit_args, 8),
            f"K1{sfx} path shape ({g_full} x {n_fit})"))
        ms = cuda_ms(lambda: rk4_population.population_sse(
            net, nn_s, b_s, *fit_args, 8), reps=5)
        plain = cuda_ms(lambda: rk4_population.population_sse_reference(
            net, nn_s, b_s, *fit_args, 8), reps=1)
        solves = g_full * n_fit
        # β (and the age) enter layer 1 only; their partials are hoisted
        hoisted = 8 * (d - 1)
        results["K1" + sfx] = dict(
            err=err, ms=ms, plain=plain, shape=f"{g_full} x {n_fit}",
            bound=bound(4 * (g_full * (p + n_fit + 1) + n_fit * (10 + n_kin)),
                        solves * (32 * (rk4_step_flops(d) - 4 * hoisted)
                                  + hoisted + mlp_flops(d)),
                        solves * (32 * 4 * MLP_SFU + MLP_SFU + 1)))

        # -- K2: value + gradient ---------------------------------------------
        def k2_compare(args, what):
            sse, gnn, gb = lane_grad.lane_sse_and_grad(net, *args, 8)
            r_sse, r_gnn, r_gb = lane_grad.lane_sse_and_grad_reference(
                net, *args, 8)
            e = compare(sse, r_sse, f"{what} value", GRAD_RTOL, 0.0)
            e = max(e, compare_scaled(gnn.reshape(-1, p), r_gnn.reshape(-1, p),
                                      f"{what} grad nn"))
            return max(e, compare_scaled(gb, r_gb, f"{what} grad beta"))

        r_path = 25
        nn_s, b_s = designs(r_path, n_fit)
        k2_path = (nn_s, b_s, *fit_args)
        err = k2_compare(k2_path,
                         f"K2{sfx} refine shape ({r_path} x {n_fit})")
        err = max(err, k2_compare(ragged(7, 13)[:5] + (tp,),
                                  f"K2{sfx} ragged (7 x 13)"))
        ms = cuda_ms(lambda: lane_grad.lane_sse_and_grad(net, *k2_path, 8),
                     reps=50)
        plain = cuda_ms(lambda: lane_grad.lane_sse_and_grad_reference(
            net, *k2_path, 8), reps=3)
        lanes = r_path * n_fit
        # the function's least work: one forward per point, then the VJP on
        # its stored activations (tanh' from h, one expf for the softplus'
        # sigmoid) and the accumulation; the kernel's second forward is its
        # own cost.  A 3rd input adds its 4 weight gradients.
        per_point = mlp_flops(d) + 95 + 38 + 8 * (d - 2)
        results["K2" + sfx] = dict(
            err=err, ms=ms, plain=plain, shape=f"{r_path} x {n_fit}",
            bound=bound(4 * (r_path * p + lanes * (1 + 1 + p + 1)
                             + n_fit * (10 + n_kin)),
                        lanes * (69 * per_point + 32 * 47 + 480),
                        lanes * (69 * (MLP_SFU + 1) + 1)))

        # -- K3: adaptive Tsit5 -----------------------------------------------
        def k3_compare(args, what):
            sse, ok = tsit5_cohort.cohort_sse_tsit5(net, *args)
            r_sse, r_ok = tsit5_cohort.cohort_sse_tsit5_reference(net, *args)
            if not torch.equal(ok, r_ok):
                raise AssertionError(f"{what}: ok masks differ "
                                     f"({int(ok.sum())} vs {int(r_ok.sum())})")
            return compare(sse, r_sse, what, TSIT5_RTOL, TSIT5_ATOL), ok

        err, ok = k3_compare(k2_path,
                             f"K3{sfx} re-rank shape ({r_path} x {n_fit})")
        e, ok = k3_compare(ragged(1237, 1), f"K3{sfx} ragged (1237 x 1)")
        if bool(ok[-1, 0]):
            raise AssertionError(f"K3{sfx}: the huge-weight lane did not fail")
        err = max(err, e)
        ms = cuda_ms(lambda: tsit5_cohort.cohort_sse_tsit5(net, *k2_path),
                     reps=20)
        plain = cuda_ms(lambda: tsit5_cohort.cohort_sse_tsit5_reference(
            net, *k2_path), reps=1)
        steps = int(tsit5_cohort.cohort_sse_tsit5_reference(
            net, *k2_path, return_steps=True)[2].sum())
        step_flops = 6 * (rhs_flops(d) + 32) + 200
        results["K3" + sfx] = dict(
            err=err, ms=ms, plain=plain,
            shape=f"{r_path} x {n_fit}, {steps} steps in all",
            bound=bound(4 * (r_path * p + lanes * 2 + n_fit * (10 + n_kin))
                        + lanes,
                        steps * step_flops + lanes * (2 * rhs_flops(d) + 40),
                        steps * (6 * MLP_SFU + 4) + lanes * 2 * MLP_SFU))

        # -- K5: value + gradient with restarts as threads --------------------
        def k5_compare(args, what, ref=None, grad_nn=True):
            """K5 against its plain version, or against ``ref``."""
            f, gnn, gb = population_grad.restart_sse_and_grad(net, *args, 8)
            if ref is None:
                ref = population_grad.restart_sse_and_grad_reference(
                    net, *args, 8)
            e = compare(f, ref[0], f"{what} value", GRAD_RTOL, 0.0)
            if grad_nn:
                e = max(e, compare_scaled(gnn, ref[1], f"{what} grad nn"))
            return max(e, compare_scaled(gb, ref[2], f"{what} grad beta"))

        def k5_against_packed(args, what, grad_nn=True):
            """K5 against K2's packed route on the same inputs: the other
            layout of the same function, which sums over the evaluation
            points and the individuals in another order.  Without
            ``grad_nn`` the value and the beta gradient only, which no sum
            over individuals enters."""
            k5_compare(args, what,
                       lane_grad.packed_sse_and_grad(net, *args, 8), grad_nn)

        def against_float64(args, what):
            """The weight gradient of both layouts against a float64 witness
            on the same float32 inputs: the packed plain version run in
            float64, which also gives each entry's sum of absolute
            per-point terms.  Where the terms cancel, that sum and not the
            entry is the scale of a float32 route's rounding, in either
            order of the sum.  Each row of each route must lie within
            ``WITNESS_EPS`` float32 roundings of its largest sum of terms;
            rows that are not finite must be the same rows in both."""
            a64 = tuple(t.double() if torch.is_tensor(t) else t for t in args)
            inv_n = 1.0 / args[1].shape[1]
            _, gnn, _, mag, _ = lane_grad.lane_sse_and_grad_reference(
                net, *a64, 8, magnitudes=True)
            g64, terms = gnn.sum(1) * inv_n, mag.sum(1) * inv_n
            routes = {
                f"K5{sfx}": population_grad.restart_sse_and_grad(
                    net, *args, 8)[1],
                f"K2{sfx} packed": lane_grad.packed_sse_and_grad(
                    net, *args, 8)[1]}
            k5_fin, k2_fin = (torch.isfinite(g).all(-1)
                              for g in routes.values())
            if not torch.equal(k5_fin, k2_fin):
                raise AssertionError(f"{what}: non-finite rows differ "
                                     "between the layouts")
            fin = k5_fin & torch.isfinite(terms).all(-1)
            scale = terms[fin].amax(-1, keepdim=True).clamp_min(1e-300)
            cancel = g64[fin].abs().amax(-1) / scale[:, 0]
            worst = {k: float(((g[fin].double() - g64[fin]).abs()
                               / scale).max()) / EPS32
                     for k, g in routes.items()}
            log(f"[kernel] {what} grad nn against float64: {int(fin.sum())} "
                "finite rows; a row's largest entry over its largest sum of "
                f"|terms|: median {float(cancel.median()):.3e}, least "
                f"{float(cancel.min()):.3e}; worst error in float32 "
                "roundings of that sum: "
                + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))
            if max(worst.values()) > WITNESS_EPS:
                raise AssertionError(
                    f"{what}: {worst} float32 roundings from the float64 "
                    f"witness, limit {WITNESS_EPS}")

        r_args = ragged(130, 13)
        f = population_grad.restart_sse_and_grad(net, *r_args, 8)[0]
        if not bool(torch.isinf(f[-1])):
            raise AssertionError(f"K5{sfx}: the huge-weight restart's mean "
                                 "is not inf")
        err = k5_compare(r_args, f"K5{sfx} ragged (130 x 13)")
        # on the real ages the two layouts' weight gradients are held to
        # the float64 witness only (see the wide shape below)
        k5_against_packed(r_args, f"K5{sfx} against K2{sfx}'s packed route, "
                          "ragged (130 x 13)", grad_nn=not with_age)
        against_float64(r_args, f"K5{sfx} and K2{sfx}'s packed route, ragged "
                        "(130 x 13)")
        r_wide = XL_RESTARTS
        nn_s, b_s = designs(r_wide, n_fit)
        k5_path = (nn_s, b_s, *fit_args)
        lanes = r_wide * n_fit
        ref, plain = timed_ms(
            lambda: population_grad.restart_sse_and_grad_reference(
                net, *k5_path, 8))
        err = max(err, k5_compare(
            k5_path, f"K5{sfx} wide shape ({r_wide} x {n_fit})", ref))
        k5_against_packed(k5_path, f"K5{sfx} against K2{sfx}'s packed route "
                          f"({r_wide} x {n_fit})", grad_nn=not with_age)
        if with_age:
            # A Glorot network on raw ages (30-70) is saturated: its output
            # hardly depends on dG, every point's gradient is nearly the
            # baseline's, and the weight gradient is what float32 leaves of
            # their cancellation, in either order of the sum.  Scaled by the
            # row's largest entry the two layouts then differ by more than
            # the entry itself, so on the raw ages both weight gradients
            # are held to the float64 witness (below), and to each other
            # with the age scaled by 1/100, as the JAX suite's covariate
            # tests scale it.
            kin = fit_args[2].clone()
            kin[:, 4] /= 100.0
            k5_against_packed((nn_s, b_s, fit_args[0], fit_args[1], kin, tp),
                              f"K5c against K2c's packed route, age / 100 "
                              f"({r_wide} x {n_fit})")
        against_float64(k5_path, f"K5{sfx} and K2{sfx}'s packed route "
                        f"({r_wide} x {n_fit})")
        # at a trained optimum the individuals' gradients cancel as well:
        # the committed candidates with their training betas on their fit
        # subjects
        cand = cov_cand if with_age else np.load(
            ARTIFACTS / "cude_neural_parameters.npz")
        s_fit = train.subset(cand["idx_fit"])
        c = build_cohort(s_fit.glucose, s_fit.timepoints, s_fit.cpeptide,
                         s_fit.ages, s_fit.t2dm, dev)
        trained = (torch.as_tensor(cand["nn_params"], **f32),
                   torch.as_tensor(cand["betas"][..., 0], **f32).contiguous(),
                   c.glucose, c.cpeptide, c.kinetics(with_age=with_age), tp)
        against_float64(trained, f"K5{sfx} and K2{sfx}'s packed route on the "
                        f"committed candidates ({trained[1].shape[0]} x "
                        f"{c.n})")
        ms = cuda_ms(lambda: population_grad.restart_sse_and_grad(
            net, *k5_path, 8), reps=5)
        # the least work is K2's, on every (restart, individual) pair; the
        # outputs are per restart
        results["K5" + sfx] = dict(
            err=err, ms=ms, plain=plain, shape=f"{r_wide} x {n_fit}",
            bound=bound(4 * (r_wide * (p + n_fit) + n_fit * (10 + n_kin)
                             + r_wide * (1 + p + n_fit)),
                        lanes * (69 * per_point + 32 * 47 + 480),
                        lanes * (69 * (MLP_SFU + 1) + 1)))
        ms = cuda_ms(lambda: lane_grad.lane_sse_and_grad(net, *k5_path, 8),
                     reps=20)
        wide["K2" + sfx] = dict(
            ms=ms, shape=f"{r_wide} x {n_fit}, {lanes} lanes",
            bound=bound(4 * (r_wide * p + lanes * (1 + 1 + p + 1)
                             + n_fit * (10 + n_kin)),
                        lanes * (69 * per_point + 32 * 47 + 480),
                        lanes * (69 * (MLP_SFU + 1) + 1)))
        # the wide paths' own shapes of K3 and K1: one launch over all
        # 131,328 lanes, one over all 400,000 designs
        e, _ = k3_compare(k5_path, f"K3{sfx} wide re-rank shape ({r_wide} x "
                          f"{n_fit})")
        results["K3" + sfx]["err"] = max(results["K3" + sfx]["err"], e)
        ms = cuda_ms(lambda: tsit5_cohort.cohort_sse_tsit5(net, *k5_path),
                     reps=5)
        wide["K3" + sfx] = dict(ms=ms, shape=f"{r_wide} x {n_fit}, {lanes} "
                                "lanes", bound=None)
        nn_s, b_s = designs(XL_INITS, n_fit)
        e = compare(
            rk4_population.population_sse(net, nn_s, b_s, *fit_args, 8),
            rk4_population.population_sse_reference(net, nn_s, b_s,
                                                    *fit_args, 8),
            f"K1{sfx} wide screen shape ({XL_INITS} x {n_fit})")
        results["K1" + sfx]["err"] = max(results["K1" + sfx]["err"], e)
        ms = cuda_ms(lambda: rk4_population.population_sse(
            net, nn_s, b_s, *fit_args, 8), reps=2)
        wide["K1" + sfx] = dict(ms=ms, shape=f"{XL_INITS} x {n_fit}",
                                bound=None)

    def live_age_check() -> None:
        """Each covariate body on exp07's committed candidates and training
        β's, on their fit subjects with their real ages and with every age
        10 years higher: the two cohorts differ only in the age column, and
        every body's result must differ between them."""
        net = chain(4, 2, input_dims=3)
        nn = torch.as_tensor(cov_cand["nn_params"], **f32)
        betas = torch.as_tensor(cov_cand["betas"][..., 0], **f32)
        s = train.subset(cov_cand["idx_fit"])
        c = build_cohort(s.glucose, s.timepoints, s.cpeptide, s.ages, s.t2dm,
                         dev)
        r, n = betas.shape
        outs = []
        for shift in (0.0, 10.0):
            kin = c.kinetics(with_age=True).clone()
            kin[:, 4] += shift
            args = (nn, betas, c.glucose, c.cpeptide, kin, tp)
            lanes = (nn.repeat_interleave(n, 0), betas.reshape(-1),
                     c.glucose.repeat(r, 1), c.cpeptide.repeat(r, 1),
                     kin.repeat(r, 1))
            outs.append({
                "K1c": rk4_population.population_sse(net, *args, 8),
                "K2c": lane_grad.lane_sse_and_grad(net, *args, 8)[1],
                "K3c": tsit5_cohort.cohort_sse_tsit5(net, *args)[0],
                "K4c": rk4_cohort.cohort_sse(net, *lanes, tp, 8)})
        for kid in ("K4c", "K1c", "K2c", "K3c"):
            a, b = outs[0][kid], outs[1][kid]
            differ = int((a != b).sum())
            log(f"[age] {kid}: {differ} of {a.numel()} values differ when "
                "every age is 10 years higher")
            if differ == 0:
                raise AssertionError(f"{kid} does not read the age")

    kernel_phase(2)
    kernel_phase(3)
    live_age_check()
    for kid, r in results.items():
        log(f"[time] {kid} at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain']:.3f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]})  [{card}]")
    for kid, r in wide.items():
        log(f"[time] {kid} at {r['shape']}: kernel {r['ms']:.4f} ms"
            + (f", bound {r['bound'][0]:.4f} ms ({r['bound'][1]})"
               if r["bound"] else "") + f"  [{card}]")
    if args.kernels_only:
        log(json.dumps({"ok": None, "partial": "kernels"}))
        return

    # -- the frozen paths (K4, then K4c) -------------------------------------
    for kid, covariate, metrics_file in (("K4", False, "exp02_metrics.json"),
                                         ("K4c", True, "exp07_metrics.json")):
        reset_counts(kid)
        t0 = time.perf_counter()
        res = run_frozen_pipeline(dev, ARTIFACTS, lbfgs_iters=1000,
                                  covariate=covariate)
        wall = time.perf_counter() - t0
        results[kid]["launches"] = launch_count(kid)
        exp = "exp07" if covariate else "exp02"
        for name, sec in res.seconds.items():
            log(f"[time] {exp} frozen stage {name}: {sec:.2f} s  [{card}]")
        log(f"[time] {exp} frozen path total: {wall:.2f} s  [{card}]")
        log(f"[path] {kid} launches during the {exp} frozen path: "
            f"{results[kid]['launches']}")
        metrics = json.loads((REPO / "results" / metrics_file).read_text())
        if covariate:
            failures = check_frozen_covariate(res, cov_ckpt, metrics)
        else:
            failures = check_frozen(res, fit_ckpt, metrics)
        if results[kid]["launches"] == 0:
            failures.append(f"{kid} was not launched by the profile scans")
        if failures:
            raise AssertionError(f"{exp} frozen path checks failed:\n  "
                                 + "\n  ".join(failures))

    # -- the retrain paths (K1, K2, K3, then K1c, K2c, K3c) ------------------
    for covariate in (False, True):
        kids = [k + ("c" if covariate else "") for k in ("K1", "K2", "K3")]
        exp = "exp07" if covariate else "exp02"
        reset_counts(*kids)
        t0 = time.perf_counter()
        res = run_training_pipeline(dev, ARTIFACTS, seed=SEED,
                                    lbfgs_iters=1000, profile_steps=0,
                                    census_steps=0, covariate=covariate)
        wall = time.perf_counter() - t0
        for kid in kids:
            results[kid]["launches"] = launch_count(kid)
        timings = res.training.timings
        for name in ("screen", "adam", "lbfgs", "final_eval"):
            log(f"[time] {exp} training stage {name}: {timings[name]:.2f} s  "
                f"[{card}]")
        for name, sec in res.seconds.items():
            log(f"[time] {exp} retrain stage {name}: {sec:.2f} s  [{card}]")
        log(f"[time] {exp} retrain path total: {wall:.2f} s  [{card}]")
        log(f"[path] {exp} screen_path {timings['screen_path']}, refine_path "
            f"{timings['refine_path']}; launches during the retrain path: "
            + ", ".join(f"{k} {results[k]['launches']}" for k in kids))
        failures = (check_retrain_covariate(res) if covariate
                    else check_retrain(res))
        failures += [f"{k} was not launched by the retrain path"
                     for k in kids if results[k]["launches"] == 0]
        if failures:
            raise AssertionError(f"{exp} retrain path checks failed:\n  "
                                 + "\n  ".join(failures))

    # -- exp02_xl, frozen: the 96 committed candidates ------------------------
    reset_counts("K4")
    t0 = time.perf_counter()
    res = run_frozen_pipeline(dev, ARTIFACTS, lbfgs_iters=1000, xl=True)
    wall = time.perf_counter() - t0
    for name, sec in res.seconds.items():
        log(f"[time] exp02_xl frozen stage {name}: {sec:.2f} s  [{card}]")
    log(f"[time] exp02_xl frozen path total: {wall:.2f} s  [{card}]")
    log(f"[path] K4 launches during the exp02_xl frozen path: "
        f"{launch_count('K4')}")
    failures = check_frozen_xl(res, json.loads(
        (REPO / "results" / "exp02_xl_metrics.json").read_text()))
    if launch_count("K4") == 0:
        failures.append("K4 was not launched by exp02_xl's profile scans")
    if failures:
        raise AssertionError("exp02_xl frozen path checks failed:\n  "
                             + "\n  ".join(failures))

    # -- exp02_xl, retrained at K5's width (K1, K5, K3; no K2) ----------------
    kids = ["K1", "K2", "K3", "K5"]
    reset_counts(*kids)
    cfg = TrainConfig(initial_guesses=XL_INITS, selected_initials=XL_RESTARTS,
                      adam_iters=XL_ADAM, lbfgs_iters=XL_LBFGS)
    log(f"[path] exp02_xl retrain: {XL_INITS} designs, {XL_RESTARTS} restarts "
        f"x {n_fit} fit subjects = {XL_RESTARTS * n_fit} lanes, "
        f"{XL_ADAM} Adam and {XL_LBFGS} L-BFGS steps")
    t0 = time.perf_counter()
    res = run_training_pipeline(dev, ARTIFACTS, seed=SEED, config=cfg,
                                lbfgs_iters=1000, profile_steps=0,
                                census_steps=0, xl=True)
    wall = time.perf_counter() - t0
    counts = {k: launch_count(k) for k in kids}
    results["K5"]["launches"] = counts["K5"]
    timings = res.training.timings
    for name in ("screen", "adam", "lbfgs", "final_eval"):
        log(f"[time] exp02_xl training stage {name}: {timings[name]:.2f} s  "
            f"[{card}]")
    for name, sec in res.seconds.items():
        log(f"[time] exp02_xl retrain stage {name}: {sec:.2f} s  [{card}]")
    log(f"[time] exp02_xl retrain path total: {wall:.2f} s  [{card}]")
    log(f"[path] exp02_xl screen_path {timings['screen_path']}, refine_path "
        f"{timings['refine_path']}; launches during the retrain path: "
        + ", ".join(f"{k} {c}" for k, c in counts.items()))
    failures = check_retrain_xl(res)
    if (counts["K1"], counts["K2"], counts["K3"]) != (1, 0, 1) \
            or counts["K5"] == 0:
        failures.append(f"launches {counts}: expected K1 1, K2 0, K3 1 and "
                        "K5 above 0")
    if failures:
        raise AssertionError("exp02_xl retrain path checks failed:\n  "
                             + "\n  ".join(failures))

    # -- the covariate model trained at K5c's width, step counts cut ----------
    kids = ["K1c", "K2c", "K3c", "K5c"]
    reset_counts(*kids)
    cfg = TrainConfig(initial_guesses=XL_INITS, selected_initials=XL_RESTARTS,
                      adam_iters=XLC_ADAM, lbfgs_iters=XLC_LBFGS)
    log(f"[path] covariate training at {XL_RESTARTS} restarts: {XL_INITS} "
        f"designs, {XLC_ADAM} Adam and {XLC_LBFGS} L-BFGS steps")
    t0 = time.perf_counter()
    tr = train_conditional(
        CPeptideModel(chain(4, 2, input_dims=3), "conditional_covariate"),
        fit_cohort, cfg,
        generator=torch.Generator(device=dev).manual_seed(SEED), seed=SEED)
    wall = time.perf_counter() - t0
    counts = {k: launch_count(k) for k in kids}
    results["K5c"]["launches"] = counts["K5c"]
    for name in ("screen", "adam", "lbfgs", "final_eval"):
        log(f"[time] covariate wide training stage {name}: "
            f"{tr.timings[name]:.2f} s  [{card}]")
    log(f"[time] covariate wide training total: {wall:.2f} s  [{card}]")
    log(f"[path] covariate wide training refine_path "
        f"{tr.timings['refine_path']}; launches: "
        + ", ".join(f"{k} {c}" for k, c in counts.items()))
    failures = check_wide_covariate_training(tr)
    if (counts["K1c"], counts["K2c"], counts["K3c"]) != (1, 0, 1) \
            or counts["K5c"] == 0:
        failures.append(f"launches {counts}: expected K1c 1, K2c 0, K3c 1 "
                        "and K5c above 0")
    if failures:
        raise AssertionError("covariate wide training checks failed:\n  "
                             + "\n  ".join(failures))

    log(json.dumps({"kernels": [{
        "name": library(kid).name,
        "route": "cuda",
        "source": str(library(kid).source.relative_to(REPO)),
        "replaces": REPLACES[kid],
        "launches": r["launches"],
        "max_abs_err": r["err"],
        "ms": r["ms"],
        "plain_ms": r["plain"],
        "bound_ms": r["bound"][0],
        "bound_by": r["bound"][1],
        "library_ms": None,
    } for kid, r in results.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def check_fits(res, fit: dict, beta_tol: float, sigma_tol: float,
               loose: dict | None = None) -> list[str]:
    """The (β, σ) refit against a committed fit, subject by subject.
    ``loose`` maps a split to subjects held only to (|Δβ|, relative σ)
    limits of their own."""
    failures = []
    for split in ("train", "test"):
        b, s = getattr(res, f"b_{split}"), getattr(res, f"s_{split}")
        for arr in (b, s, getattr(res, f"sse_{split}")):
            if not np.isfinite(arr).all():
                failures.append(f"non-finite {split} fit")
        db = np.abs(b - fit[f"beta_{split}"])
        ds = np.abs(s / fit[f"sigma_{split}"] - 1.0)
        tight = np.ones(len(db), bool)
        for i, (b_tol, s_tol) in (loose or {}).get(split, {}).items():
            tight[i] = False
            log(f"[check] {split} subject {i}: |dbeta| {db[i]:.2e}, rel "
                f"dsigma {ds[i]:.2e} (limits {b_tol}, {s_tol})")
            if db[i] > b_tol or ds[i] > s_tol:
                failures.append(f"{split} subject {i} off the committed fit")
        db, ds = db[tight], ds[tight]
        log(f"[check] {split}: max |dbeta| {db.max():.2e}, max rel dsigma "
            f"{ds.max():.2e} over {int(tight.sum())} subjects; median "
            f"{np.median(db):.2e}, {np.median(ds):.2e}")
        if db.max() > beta_tol or ds.max() > sigma_tol:
            failures.append(f"{split} beta/sigma off the committed fit")
    return failures


def check_census(got: dict, want: dict, name: str) -> list[str]:
    log(f"[check] census {name}: {got} (committed {want})")
    if any(abs(got.get(c, 0) - want.get(c, 0)) > 1
           for c in set(got) | set(want)):
        return [f"census {name} {got}"]
    return []


def check_summary(res, best: int, rho: float, sse_mean: float) -> list[str]:
    """Best candidate, first-phase Spearman ± 0.01, test SSE mean ± 3 %."""
    failures = []
    log(f"[check] best candidate {res.best} (committed {best})")
    if res.best != best:
        failures.append(f"best candidate {res.best}")
    got = res.spearman["first_phase"]
    log(f"[check] spearman first phase {got:.4f} (committed {rho:.4f}); "
        f"age {res.spearman['age']:.4f}, insulin sensitivity "
        f"{res.spearman['insulin_sensitivity']:.4f}")
    if abs(got - rho) > 0.01:
        failures.append(f"spearman {got}")
    got = float(np.mean(res.sse_test))
    log(f"[check] test SSE mean {got:.4f} (committed {sse_mean:.4f})")
    if abs(got / sse_mean - 1.0) > 0.03:
        failures.append(f"test SSE mean {got}")
    return failures


def check_frozen(res, fit: dict, metrics: dict) -> list[str]:
    """exp02's frozen path against the committed artifacts and metrics."""
    failures = check_summary(res, metrics["best_model_index"],
                             metrics["spearman"]["first_phase"],
                             metrics["test_sse_mean"])
    failures += check_fits(res, fit, 1e-2, 2e-2)
    for name, key in (("test", "identifiability_census_test"),
                      ("all", "identifiability_census_all")):
        failures += check_census(getattr(res, f"census_{name}"), metrics[key],
                                 name)
    prof, delta = res.profile.values, res.delta_profile.values
    if tuple(prof.shape) != (35, 10_000) or tuple(delta.shape) != (117, 1000):
        failures.append(f"profile shapes {tuple(prof.shape)}, "
                        f"{tuple(delta.shape)}")
    committed = fit["profile_values"]
    rel = np.abs(prof.cpu().numpy() / committed - 1.0)
    log(f"[check] test profile vs committed: median rel {np.median(rel):.2e}, "
        f"max rel {rel.max():.2e}")
    return failures


# exp07's committed fit came from the TPU.  JAX on the CPU reproduces it
# within exp02's limits (|Δβ| 1e-2, σ 2 %) on 114 of the 117 subjects and
# misses three (ROADMAP Queue 3): training subject 6 by 0.26 in β and test
# subject 6 by 0.57 in β (σ within 0.2 % for both), and training
# subject 64 by 12.9 % in σ (β at the upper bound in both).  Each of the
# three is held to about twice JAX's own miss.
COV_LOOSE = {"train": {6: (0.6, 2e-2), 64: (1e-2, 0.3)},
             "test": {6: (1.2, 2e-2)}}


def check_frozen_covariate(res, fit: dict, metrics: dict) -> list[str]:
    """exp07's frozen path against its committed fit and metrics: the test
    SSE mean is that of the committed fit's ``sse_test``; exp07 has a
    Raue-95 test census and no census over all subjects."""
    failures = check_summary(res, metrics["best_model_index"],
                             metrics["spearman"]["first_phase"],
                             float(np.mean(fit["sse_test"])))
    failures += check_fits(res, fit, 1e-2, 2e-2, COV_LOOSE)
    failures += check_census(res.census_test,
                             metrics["identifiability_census_test"], "test")
    if tuple(res.profile.values.shape) != (35, 10_000):
        failures.append(f"profile shape {tuple(res.profile.values.shape)}")
    if res.delta_profile is not None or res.census_all:
        failures.append("exp07 ran a census over all subjects")
    return failures


def check_retrain(res) -> list[str]:
    """The retrain path against the spread of the JAX package's per-seed
    runs (``results/exp02_seed_{11..55}.json``): best Tsit5 objective
    0.178-0.272 (committed artifact 0.246), test SSE mean 0.458-0.581
    widened by 10 %, Spearman -0.813 to -0.824."""
    return check_trained(res, 0.30, (0.41, 0.64), -0.77,
                         "JAX per-seed 0.178-0.272")


def check_retrain_covariate(res) -> list[str]:
    """exp07's retrain path against limits widened from its one JAX run
    (best Tsit5 objective 0.2328, test SSE mean 0.672, Spearman -0.626); no
    per-seed spread of exp07 exists."""
    return check_trained(res, 0.30, (0.50, 0.85), -0.45, "JAX run 0.2328")


def check_routes_and_objective(tr, refine_path: str, obj_max: float,
                               obj_ref: str) -> list[str]:
    """The kernels' routes a training took and its best Tsit5 objective."""
    failures = []
    timings = tr.timings
    if (timings["screen_path"], timings["refine_path"]) != ("cuda_k1",
                                                            refine_path):
        failures.append(f"routes {timings['screen_path']}, "
                        f"{timings['refine_path']}")
    best_obj = float(tr.objectives[0])
    log(f"[check] best restart's Tsit5 objective {best_obj:.4f} "
        f"({obj_ref}; limit {obj_max}); restarts finite: "
        f"{int(torch.isfinite(tr.objectives).sum())}/{tr.objectives.numel()}")
    if not np.isfinite(best_obj) or best_obj > obj_max:
        failures.append(f"best objective {best_obj}")
    return failures


def check_trained(res, obj_max: float, sse_range: tuple[float, float],
                  rho_max: float, obj_ref: str) -> list[str]:
    failures = check_routes_and_objective(res.training, "cuda_k2", obj_max,
                                          obj_ref)
    sse_mean = float(np.mean(res.sse_test))
    lo, hi = sse_range
    log(f"[check] retrain test SSE mean {sse_mean:.4f} (limits {lo}-{hi})")
    if not lo <= sse_mean <= hi:
        failures.append(f"test SSE mean {sse_mean}")
    rho = res.spearman["first_phase"]
    log(f"[check] retrain spearman first phase {rho:.4f} (limit {rho_max}); "
        f"best candidate {res.best}, orientation {res.orientation:+.0f}")
    if not rho <= rho_max:
        failures.append(f"spearman {rho}")
    return failures


def check_frozen_xl(res, metrics: dict) -> list[str]:
    """exp02_xl's frozen path against its committed metrics: the plain and
    the guarded selection, each with its test SSE mean +- 3 %, and the
    first-phase Spearman +- 0.01."""
    failures = check_summary(res, metrics["best_model_index"],
                             metrics["spearman_first_phase"],
                             metrics["test_sse_mean"])
    got = res.metrics()
    log(f"[check] guarded best candidate {got['guarded_best_model_index']} "
        f"(committed {metrics['guarded_best_model_index']}); guarded test "
        f"SSE mean {got['guarded_test_sse_mean']:.4f} (committed "
        f"{metrics['guarded_test_sse_mean']:.4f}), median "
        f"{got['guarded_test_sse_median']:.4f} (committed "
        f"{metrics['guarded_test_sse_median']:.4f}); test SSE median "
        f"{got['test_sse_median']:.4f} (committed "
        f"{metrics['test_sse_median']:.4f}); guarded spearman "
        f"{got['guarded_spearman_first_phase']:.4f}")
    if got["guarded_best_model_index"] != metrics["guarded_best_model_index"]:
        failures.append("guarded best candidate "
                        f"{got['guarded_best_model_index']}")
    if abs(got["guarded_test_sse_mean"] / metrics["guarded_test_sse_mean"]
           - 1.0) > 0.03:
        failures.append(f"guarded test SSE mean "
                        f"{got['guarded_test_sse_mean']}")
    if tuple(res.val_objectives.shape) != (96, 25):
        failures.append(f"validation objectives "
                        f"{tuple(res.val_objectives.shape)}")
    # exp02_xl committed no census: the scans are held to their shapes and
    # to every subject being classified
    log(f"[check] census test {res.census_test}, all {res.census_all} "
        "(no committed census)")
    for prof, shape, census in (
            (res.profile, (35, 10_000), res.census_test),
            (res.delta_profile, (117, 1000), res.census_all)):
        if prof is None or tuple(prof.values.shape) != shape \
                or sum(census.values()) != shape[0]:
            failures.append(f"profile scan of shape {shape}: census {census}")
    return failures


def check_retrain_xl(res) -> list[str]:
    """exp02_xl's retrain path at K5's width against exp02's retrain limits
    (the JAX per-seed spread, see ``check_retrain``), held by the guarded
    selection: more restarts must not do worse than 25."""
    failures = check_routes_and_objective(res.training, "cuda_k5", 0.30,
                                          "JAX per-seed 0.178-0.272 at 25 "
                                          "restarts")
    got = res.metrics()
    log(f"[check] exp02_xl retrain: best candidate {res.best} (test SSE mean "
        f"{got['test_sse_mean']:.4f}, spearman "
        f"{res.spearman['first_phase']:.4f}), guarded best "
        f"{res.guarded_best} (test SSE mean "
        f"{got['guarded_test_sse_mean']:.4f}, limits 0.41-0.64; spearman "
        f"{res.guarded_spearman:.4f}, limit -0.77)")
    if tuple(res.val_objectives.shape) != (XL_RESTARTS, 25):
        failures.append(f"validation objectives "
                        f"{tuple(res.val_objectives.shape)}")
    if not 0.41 <= got["guarded_test_sse_mean"] <= 0.64:
        failures.append(f"guarded test SSE mean "
                        f"{got['guarded_test_sse_mean']}")
    if not res.guarded_spearman <= -0.77:
        failures.append(f"guarded spearman {res.guarded_spearman}")
    return failures


def check_wide_covariate_training(tr) -> list[str]:
    """The covariate model's training at K5c's width, with cut step counts:
    K5c's route, every restart refined, a finite best objective no worse
    than the best screened design, and Adam losses that fell."""
    best_screen = float(tr.screen_losses[torch.isfinite(tr.screen_losses)].min())
    failures = check_routes_and_objective(
        tr, "cuda_k5", 1.05 * best_screen,
        f"best screened design {best_screen:.4f}")
    first, last = tr.loss_traces[:, 0], tr.loss_traces[:, -1]
    fell = int((last < first).sum())
    log(f"[check] covariate wide training: Adam loss fell in {fell} of "
        f"{first.numel()} restarts, median {float(first.median()):.4f} -> "
        f"{float(last.median()):.4f}")
    if tuple(tr.nn_params.shape) != (XL_RESTARTS, 41) \
            or fell < 0.9 * first.numel():
        failures.append(f"shape {tuple(tr.nn_params.shape)}, losses fell in "
                        f"{fell} restarts")
    return failures


if __name__ == "__main__":
    main()
