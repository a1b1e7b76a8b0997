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
   K4 (cohort RK4, a thread a lane) and K1 (population screen, a thread a
   (restart, individual) lane), K2 (value + gradient on packed lanes, a
   warp a lane), K5 (value + gradient per restart, a block a restart) and
   K3 (adaptive Tsit5, a thread a lane, the five productions of a step
   before its stages) bit for bit, K3 also with the same ``ok`` mask and
   inf where not ok; K1c-K5c are
   the covariate bodies, held alike, and K1c-K4c must read the age: two
   cohorts that differ only in the age column give different results.  K1
   and K3 are also held at the enlarged multi-start's shapes (400,000 x 57
   designs, 131,328 lanes), where K3's bound counts that run's own steps,
   and K1, K2 and K3 at the less-data ablation's (exp05): 10,000 designs
   and 10 restarts on its smallest and largest cohorts (8 and 82 of the
   committed training subjects; 80 and 820 lanes), the last design of huge
   weights, and K4 and K2 at SAEM's (exp06): K4 over 164, 82 and 117 lanes
   (an MCMC step's proposals and states, an iteration's likelihood, a
   posterior chains' step) on the committed pre-train network at β's up
   to |β| = 5, and with a network a lane, the last of huge weights; K2 at
   one restart on the 82 training subjects; and K2 at 4 substeps at
   exp_advi's steps (280, 5,700 and section 3's 656 lanes) and K4 at its
   profile chunk
   (500 x 35); and K4 and K4c at the gallery's CI chunk (500 points x the
   three test medians, 1,500 lanes).  K5 is held bit for bit
   against K2's lanes
   summed over the individuals in order, at 2,304 x 57 and at the ragged
   shape, and against K2's packed route (``Tensor.sum`` over the
   individuals): two layouts of one function, equal up to the order of the
   sums.  On real ages a random network is saturated and its weight
   gradient is what float32 leaves of cancelling terms, so there (and on
   the committed trained candidates, for both bodies) the weight gradient
   of each layout is held to a float64 witness, within 256 float32
   roundings of the row's largest sum of absolute terms;
3. times each body and its plain version at the path's shape (CUDA events
   around calls of the wrapper, the ``ms`` of the kernels line, and the
   device alone, ``device_ms``, by replaying a CUDA graph of the calls), K2
   also at K5's shape, K1 and K3 at the enlarged multi-start's, K1, K2 and
   K3 at exp05's, and works
   out the bound of each from its inputs (K4 and K2 also at SAEM's and
   exp_advi's shapes): K1 and K4 evaluate the network
   at 69 points a lane (``csrc/cude_rk4.cuh``), K3 3 a lane and 5 an
   attempted step (``tsit5_evaluations``), and K3's entries add the longest
   lane's attempted steps (``max_lane_steps``) and the device time per
   step of that lane (``us_per_step``);
4. runs the frozen path of exp02 (``run_frozen_pipeline``) at full width
   and checks it against the committed results, the SSE per NGT/IGT/T2DM
   class included, and its export (``cude_fit.npz``, as ``--out`` writes
   it) against the committed file's keys and shapes; K4's launches are
   counted over it;
5. runs the retrain path of exp02 (``run_training_pipeline``) at full
   width: 25,000 designs screened on the 57-subject fit split, 25 restarts
   of 1000 Adam and 1000 L-BFGS steps, the Tsit5 re-rank, selection and the
   (beta, sigma) refit; K1, K2 and K3's launches are counted over it, and
   the result is held to the spread of the JAX package's per-seed runs;
6. runs the frozen path of exp07, the covariate model (``covariate=True``),
   at full width and checks it against exp07's committed results and its
   export (``cude_covariate_fit.npz``) as in 4; K4c's launches are counted
   over it;
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
    the package pairs the covariate model with a multi-start this wide;
11. exp02's outputs, made by the frozen path of 4 and the retrain of 5:
    the dose-response table (built from the committed refit's β's, held to
    ``artifacts/ohashi_production.csv``), the sampled bands and the UDE
    against the cUDE, held to ``results/exp02_metrics.json``;
12. runs exp01, the non-conditional UDE, frozen (the committed network)
    and retrained at full width (``train_ude``: 10,000 designs, 10
    restarts, 1000 Adam and 1000 L-BFGS steps) at three seeds, held to the
    committed metrics and to the spread of the JAX package's own retrains
    (each draw's objective, the three draws' median MSE means);
13. runs the symbolic refits of exp03 (Ohashi), exp04 (Fujita) and
    exp_symreg_production (the discovered equation), held subject by
    subject to the committed fits.  No kernel computes these heads: 12
    and 13 must launch none;
14. runs exp02_seeds at seeds 11 and 22 (exp02's retrain path at each,
    held to exp02's retrain limits) and merges the two records;
15. runs exp05, the less-data ablation, at ablation seed 0 and fractions
    0.1, 0.5 and 1.0 (8, 41 and 82 training subjects), each row held to
    the committed five-seed range of its test-SSE median widened by 10 %;
    14 and 15 must launch K1, K2 and K3 and no other body;
16. runs the replication runner over exp01 (frozen) at two seeds, one
    child process a seed, held to the committed metrics;
17. runs exp06, SAEM on the cUDE, at full depth (the committed pre-train,
    180 iterations of 25 MCMC steps in both Ω modes, 3000-step chains,
    the MAPs and MLEs of all 117 subjects): it must launch K4 (one launch
    an MCMC step, an iteration and a chain step, counted exactly) and K2
    (one an Adam step) and nothing else; its metrics are held to the
    spread of the JAX package's own runs over 31 key pairs on the CPU
    (``scripts/saem_reference.py``) widened by half its width on each
    side, and MAPs and MLEs from the committed fit's fixed effects to
    twice JAX's own miss of ``artifacts/saem_fit.npz`` (its largest and
    median miss, subject 84's apart);
18. runs exp06 with its pre-train retrained at seed 11, which must launch
    K1, K2, K3 and K4, held to the spread of the JAX package's runs on the
    CPU over 31 key pairs from that same pre-train, widened as in 17 (the
    five-seed range of ``results/replicate_exp06_saem.json`` is printed
    beside it);
19. runs exp06a and exp06b (SAEM on the symbolic model and on the
    discovered equation) at full depth: no kernel computes these heads,
    so they must launch none; held to the JAX spread as 17;
20. runs exp_advi: first a reduced run (2 restarts, 35 test subjects, 200
    steps each) on the card and on the CPU (2 threads) from the same
    draws, held to each other array by array; then the full run (25
    restarts x 2,000 steps, 35 subjects x 1,500 steps, the profile at
    2,000 points) through the entry point, which must launch K2 exactly
    3,500 times and K4 4 and nothing else; its metrics and each test
    subject's β mean and sd are held to the spread of the JAX package's
    own runs over keys on the CPU (``scripts/advi_reference.py``) widened
    as in 17;
21. runs exp_suppression, which must launch no kernel, after exp_advi:
    the port's loss at the 25 restarts of each of the 14 committed
    ``artifacts/suppression_lambda=*.npz`` on its own training data
    (the true p4 exact, the objectives within max(1e-4, twice JAX-CPU's
    own miss of the file)); ``--test-only`` through the entry point with
    its L-BFGS cut to 20 steps (the selections, Spearmans and each
    restart's revalidation, but the three that JAX leaves undetermined at
    that depth, against JAX-CPU's at the same cut, from
    ``scripts/suppression_reference.py``; at full depth it takes ~16 min
    alone on an H100, ``scripts/suppression_runs.py``); and a reduced
    retrain (all 37 subjects, the full network, 10,000 designs and 25
    restarts, 100 Adam and 5 L-BFGS steps) whose metrics of each λ are
    held to JAX-CPU's spread over 16 keys, widened as in 17.
22. runs exp_symreg_search, the GP search for closed-form equations of
    the production surface, which must launch no kernel, after
    exp_suppression: one GP run of each of the script's configurations at
    full width (population 4096 on depth-4 trees and 2048 on depth-5
    trees, 80 constant-optimisation steps, elite 64 and 48, ``max_size``
    18) on its 720-sample fit split, at ``SYMREG_GENERATIONS`` = 300
    generations (the script's own: no cut), through
    ``run_exp_symreg_search``; each run's best loss, Pareto size and best
    holdout MSE held to JAX-CPU's spread over 16 keys at the same
    configuration, widened as in 17, and the reference equation's holdout
    MSE to the committed 0.005350096 within 1e-6 relative.
23. runs exp_figures, the gallery, at full size after exp01's retrains at
    seeds 11 and 22 in their child: first ``device_trace`` around one K4
    launch, whose trace must name the kernel; then every section through
    ``run_exp_figures``, which must launch K4 and K4c 20 times each (the
    CI-bound profiles: 10,000 points in chunks of 500) and nothing else,
    held to the JAX package's arrays on the CPU
    (``scripts/figures_reference.json``): the median subjects, their CI
    bounds within two grid steps and the trajectories there, the
    dose-response curves, the refits, every section's trajectories and
    bands, the p-values.
24. runs the mesh path (``parallel/mesh.py``) after the gallery in its
    child: exp02's retrain cut to 10 + 10 steps, the census (117 x 1,000),
    the test profiles of exp02 (K4) and exp07 (K4c), the (β, σ) refit of
    all 117 subjects at 10 L-BFGS steps, SAEM on the 117 at 4 iterations
    and the suppression sweep at the reduced retrain cut to 10 Adam and 10
    L-BFGS steps, each unsharded and on a 2-way mesh of ``cuda:0`` (25 restarts padded
    to 26, 117 and 35 subjects padded to 118 and 36), then exp02's retrain
    at full depth on the mesh; every stage launches exactly its kernels,
    the sharded run twice as often, and is held to the unsharded run bit
    for bit where its lanes are independent (``MESH_*``), the full-depth
    training to exp02's retrain limit.  With more than one card the census
    and the cut run over all of them too, held as the 2-way runs are.
25. runs the ETL path after exp04 in its child, on raw data files written
    as the tests write them (``tests/etl_fixtures.py``: the committed npz
    files back in the reference's CSV layout): exp00 through the entry
    point, whose ``ohashi.npz`` and ``fujita.npz`` must equal the
    committed ones bit for bit and whose metrics must equal
    ``results/exp00_metrics.json`` (p-values rtol 1e-12); exp_parity's
    computation (``parity_pipeline.run_parity``) at the reference's
    network of ``tests/golden/reference_parity_golden.npz``, its bounds
    the golden training β's widened by 10 %, no fitted β at the upper
    bound and at the lower one only a subject that the golden fit leaves at
    the reference's own lower bound (its likelihood falls toward β → −∞,
    so a wider bound moves it there too), each
    per-type SSE within 3 % and the refit's β mean within 1e-2 of
    ``results/exp_parity_metrics.json``, RK4 and Tsit5 within 2e-4; and
    exp_advi's section 3 (``advi_pipeline.reference_crosscheck``) at three
    committed candidates standing in for the reference's ADVI runs, finite
    statistics.  exp00 and exp_parity launch no kernel; section 3 launches
    K2 exactly 3 x 800 times and nothing else.  The JLD2 readers are not
    run: this machine has no h5py, so exp_parity's and section 3's entry
    points, which read the reference's JLD2 files, are driven through
    their computations.
    12-25 are bound by the host, so they run in seven child processes (this
    script with ``--side``) started once the kernels are timed, beside
    4-10; their logs are printed after 10, and a child that fails fails
    the run.

Every failure raises, so the exit code is non-zero; the children are
killed when this process ends.  The last line is ``{"ok": true,
"device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import json
import math
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
# exp05's training: 10,000 designs screened, 10 restarts refined
ABLATION_INITS, ABLATION_RESTARTS = 10_000, 10
# exp01's retrain against the JAX package's own train_ude at full width on
# the CPU at 20 seeds (``python tests/test_torch_ude.py``): best objective
# 1.4e-14 to 1.908e-4, train MSE mean 0.5807 to 27.44, test 0.7848 to 4.003,
# each widened by 10 %; the objective is an SSE, so its floor is 0.  The MSE
# means are heavy-tailed (two of JAX's 20 draws above 3.4 in test MSE), so
# each draw's objective is held to the spread, and so is the median of
# three draws' MSE means (the flagship's seed and two fixed others)
UDE_OBJ_MAX = 2.099e-4
UDE_TRAIN_MSE, UDE_TEST_MSE = (0.5226, 30.19), (0.7063, 4.403)
UDE_SEEDS = (270523, 11, 22)
# the committed dose-response table came from a TPU; the JAX experiment script's code
# on the CPU misses its productions by up to 7.8e-5, the port is held to
# twice that (``tests/test_torch_exp02_outputs.py``)
CSV_ATOL = 1.6e-4


def mlp_flops(d: int) -> int:
    """Arithmetic of one network evaluation on ``d`` inputs: a 3rd input
    adds a multiply and an add to each of layer 1's four units."""
    return MLP_FLOPS + 8 * (d - 2)


# the network evaluations of one RK4 lane on the OGTT grid at 8 substeps:
# the baseline and 2 x 8 + 1 points in each of the 4 segments
RK4_POINTS = 1 + 4 * (2 * 8 + 1)


def rk4_lane_work(d: int) -> tuple[int, int]:
    """(float32 operations, transcendentals) of the least work of one RK4
    lane on the OGTT grid: the network once at each of its 69 points (the
    products of layer 1 with e^beta and the age taken once a lane; a point
    adds its dG blend and takes the baseline off), 32 steps of the
    kinetics at four stages and the stage arithmetic, e^beta and the
    residuals."""
    lane_const = 4 * (d - 1)
    point = mlp_flops(d) - lane_const + 6
    flops = RK4_POINTS * point + 32 * (4 * 10 + 30) + lane_const + 10
    return flops, RK4_POINTS * MLP_SFU + 1


def tsit5_evaluations(lanes: int, steps: int) -> int:
    """Network evaluations of K3 over ``lanes`` lanes that attempted
    ``steps`` steps in all: the baseline and Hairer's initial step's two a
    lane, and five a step (stage 7's time is stage 6's, so it takes that
    production; ``tests/test_torch_tsit5_stages.py`` counts them in the
    plain version)."""
    return 3 * lanes + 5 * steps


def tsit5_work(d: int, lanes: int, steps: int, accepted: int, finished: int,
               n_save: int) -> tuple[int, int]:
    """(float32 operations, transcendentals) of K3's least work on these
    inputs: ``lanes`` lanes that attempted ``steps`` steps and accepted
    ``accepted`` of them, ``finished`` lanes that reached the end.  Each
    network evaluation with its glucose blend and dG (8 operations); an
    attempted step's six stages of the kinetics (10 each), their
    combinations (2 x 21 multiply-adds), the error norm and the controller
    (~75), one sqrtf and one powf (a log and an exp); an accepted step that
    another step follows, one more powf (the next step's err_prev term);
    a finished lane's n_save - 1 save times through the interpolant (~70
    each); a lane's Hairer start (~40, three sqrtf and a powf) and
    e^beta."""
    flops = (tsit5_evaluations(lanes, steps) * (mlp_flops(d) + 8)
             + steps * (6 * 10 + 2 * 21 * 3 + 75)
             + finished * (n_save - 1) * 70 + lanes * 40)
    sfu = (tsit5_evaluations(lanes, steps) * MLP_SFU + steps * 3
           + (accepted - finished) * 2 + lanes * 6)
    return flops, sfu


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


def same(outs, refs, what: str) -> None:
    """Bit for bit: each output equals its reference, non-finite entries in
    the same places."""
    for i, (o, r) in enumerate(zip(outs, refs)):
        torch.testing.assert_close(
            o, r, rtol=0, atol=0, equal_nan=True,
            msg=lambda m, i=i: f"{what}: output {i} is not bit for bit: {m}")
    log(f"[kernel] {what}: bit for bit")


def exact(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """``compare`` (which logs the error), then bit for bit: K1 and K4 do
    their plain versions' operations in the same order."""
    err = compare(out, ref, what)
    same((out,), (ref,), what)
    return err


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


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call: one replay of a CUDA graph of
    ``reps`` calls, timed by CUDA events, so the wrapper's host work is out
    of it (``cuda_ms`` is bound by that work for a kernel of ~0.1 ms)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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
    parser.add_argument("--side", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--side-out", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is visible")
    sys.path.insert(0, str(REPO))
    if args.side:
        run_side(args.side.split(";"), Path(args.side_out))
        return
    from conditional_ude_tpu_torch import ablation
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
    from conditional_ude_tpu_torch.convert import params_from_jax
    from conditional_ude_tpu_torch.pipeline import (
        SEED,
        dose_response,
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
        err = exact(rk4_cohort.cohort_sse(net, *prof, tp, 8),
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
        err = max(err, exact(out, rk4_cohort.cohort_sse_reference(
            net, *k4_ragged, tp, 8), f"K4{sfx} ragged (1237 lanes)"))
        ms = cuda_ms(lambda: rk4_cohort.cohort_sse(net, *prof, tp, 8),
                     reps=20)
        device = graph_ms(lambda: rk4_cohort.cohort_sse(net, *prof, tp, 8),
                          reps=50)
        plain = cuda_ms(lambda: rk4_cohort.cohort_sse_reference(
            net, *prof, tp, 8), reps=3)
        flops, sfu = rk4_lane_work(d)
        results["K4" + sfx] = dict(
            err=err, ms=ms, device=device, plain=plain,
            shape=f"{chunk[:-1]}, {lanes} lanes)",
            bound=bound(4 * (p + lanes * (12 + n_kin)), lanes * flops,
                        lanes * sfu))

        # -- K1: population screen --------------------------------------------
        nn_s, b_s = designs(4096, n_fit)
        err = exact(
            rk4_population.population_sse(net, nn_s, b_s, *fit_args, 8),
            rk4_population.population_sse_reference(net, nn_s, b_s,
                                                    *fit_args, 8),
            f"K1{sfx} screen shape (4096 x {n_fit})")
        r_args = ragged(1237, 8)
        out = rk4_population.population_sse(net, *r_args, 8)
        if not bool(torch.isinf(out[-1])):
            raise AssertionError(f"K1{sfx}: the huge-weight restart's mean "
                                 "is not inf")
        err = max(err, exact(out, rk4_population.population_sse_reference(
            net, *r_args, 8), f"K1{sfx} ragged (1237 x 8)"))
        # the retrain path's own shape: all 25,000 designs on the fit split
        g_full = 25_000
        nn_s, b_s = designs(g_full, n_fit)
        err = max(err, exact(
            rk4_population.population_sse(net, nn_s, b_s, *fit_args, 8),
            rk4_population.population_sse_reference(net, nn_s, b_s,
                                                    *fit_args, 8),
            f"K1{sfx} path shape ({g_full} x {n_fit})"))
        ms = cuda_ms(lambda: rk4_population.population_sse(
            net, nn_s, b_s, *fit_args, 8), reps=5)
        device = graph_ms(lambda: rk4_population.population_sse(
            net, nn_s, b_s, *fit_args, 8), reps=10)
        plain = cuda_ms(lambda: rk4_population.population_sse_reference(
            net, nn_s, b_s, *fit_args, 8), reps=1)

        def k1_bound(g, n=n_fit):
            """Every (restart, individual) lane's least work; the mean of
            each restart."""
            flops, sfu = rk4_lane_work(d)
            return bound(4 * (g * (p + n + 1) + n * (10 + n_kin)),
                         g * n * (flops + 1) + g, g * n * sfu)

        results["K1" + sfx] = dict(
            err=err, ms=ms, device=device, plain=plain,
            shape=f"{g_full} x {n_fit}", bound=k1_bound(g_full))

        # -- K2: value + gradient ---------------------------------------------
        def k2_compare(args, what, substeps=8):
            sse, gnn, gb = lane_grad.lane_sse_and_grad(net, *args, substeps)
            r_sse, r_gnn, r_gb = lane_grad.lane_sse_and_grad_reference(
                net, *args, substeps)
            e = compare(sse, r_sse, f"{what} value", GRAD_RTOL, 0.0)
            e = max(e, compare_scaled(gnn.reshape(-1, p), r_gnn.reshape(-1, p),
                                      f"{what} grad nn"))
            same((sse, gnn, gb), (r_sse, r_gnn, r_gb), what)
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
        device = graph_ms(lambda: lane_grad.lane_sse_and_grad(
            net, *k2_path, 8), reps=50)
        plain = cuda_ms(lambda: lane_grad.lane_sse_and_grad_reference(
            net, *k2_path, 8), reps=3)
        # the function's least work: one forward per point, then the VJP on
        # its stored activations (tanh' from h, one expf for the softplus'
        # sigmoid) and the accumulation; the kernel's second forward is its
        # own cost.  A 3rd input adds its 4 weight gradients.
        per_point = mlp_flops(d) + 95 + 38 + 8 * (d - 2)

        def k2_bound(r, n, substeps=8):
            """At ``substeps`` the network runs at 1 + 4 (2 substeps + 1)
            points a lane (69 at 8, 37 at 4) and the kinetics take 4
            substeps steps."""
            lanes, points = r * n, 1 + 4 * (2 * substeps + 1)
            return bound(4 * (r * p + lanes * (1 + 1 + p + 1)
                              + n * (10 + n_kin)),
                         lanes * (points * per_point + 4 * substeps * 47
                                  + 480),
                         lanes * (points * (MLP_SFU + 1) + 1))

        results["K2" + sfx] = dict(
            err=err, ms=ms, device=device, plain=plain,
            shape=f"{r_path} x {n_fit}", bound=k2_bound(r_path, n_fit))

        # -- K3: adaptive Tsit5 -----------------------------------------------
        def k3_compare(args, what):
            """K3 against its plain version: the same ``ok`` mask, inf where
            not ok, every SSE bit for bit.  Returns the max abs error, the
            mask, and the plain version's attempted and accepted steps a
            lane."""
            sse, ok = tsit5_cohort.cohort_sse_tsit5(net, *args)
            r_sse, r_ok, steps, accepted = \
                tsit5_cohort.cohort_sse_tsit5_reference(net, *args,
                                                        return_steps=True)
            if not torch.equal(ok, r_ok):
                raise AssertionError(f"{what}: ok masks differ "
                                     f"({int(ok.sum())} vs {int(r_ok.sum())})")
            if not bool(torch.isinf(sse[~ok]).all()):
                raise AssertionError(f"{what}: a failed lane's SSE is not inf")
            return exact(sse, r_sse, what), ok, (steps, accepted)

        def k3_timed(args, ok, counts, reps, **entry):
            """``entry`` with K3's times at ``args``, its bound from the
            steps the lanes attempted and accepted (``counts``) and the
            lanes that finished (``ok``), the longest lane's steps and the
            device time per step of that lane."""
            steps, accepted = counts
            r, n = steps.shape
            lanes, total = r * n, int(steps.sum())
            device = graph_ms(
                lambda: tsit5_cohort.cohort_sse_tsit5(net, *args), reps=reps)
            return dict(
                entry, device=device,
                ms=cuda_ms(lambda: tsit5_cohort.cohort_sse_tsit5(net, *args),
                           reps=reps),
                max_lane_steps=int(steps.max()),
                us_per_step=device * 1e3 / int(steps.max()),
                shape=f"{r} x {n}, {lanes} lanes, {total} steps",
                bound=bound(4 * (r * p + lanes * 2 + n * (10 + n_kin))
                            + lanes,
                            *tsit5_work(d, lanes, total, int(accepted.sum()),
                                        int(ok.sum()), len(args[-1]))))

        err, path_ok, counts = k3_compare(
            k2_path, f"K3{sfx} re-rank shape ({r_path} x {n_fit})")
        e, ok, _ = k3_compare(ragged(1237, 1), f"K3{sfx} ragged (1237 x 1)")
        if bool(ok[-1, 0]):
            raise AssertionError(f"K3{sfx}: the huge-weight lane did not fail")
        plain = cuda_ms(lambda: tsit5_cohort.cohort_sse_tsit5_reference(
            net, *k2_path), reps=1)
        results["K3" + sfx] = k3_timed(k2_path, path_ok, counts, 20,
                                       err=max(err, e),
                                       plain=plain)

        # -- K5: value + gradient with restarts as threads --------------------
        def k5_compare(args, what, ref=None, grad_nn=True):
            """K5 against its plain version (bit for bit), or against
            ``ref`` at the repository's tolerances."""
            f, gnn, gb = population_grad.restart_sse_and_grad(net, *args, 8)
            exact = ref is None or ref[3]
            if ref is None:
                ref = population_grad.restart_sse_and_grad_reference(
                    net, *args, 8)
            e = compare(f, ref[0], f"{what} value", GRAD_RTOL, 0.0)
            if grad_nn:
                e = max(e, compare_scaled(gnn, ref[1], f"{what} grad nn"))
            if exact:
                same((f, gnn, gb), ref[:3], what)
            return max(e, compare_scaled(gb, ref[2], f"{what} grad beta"))

        def k5_against_lanes(args, what):
            """K5 against K2's lanes on the same inputs, summed over the
            individuals 0..N-1 in order and times 1/N: the sums K5's block
            takes, so bit for bit."""
            sse, gnn, gb = lane_grad.lane_sse_and_grad(net, *args, 8)
            inv_n = np.float32(1.0 / args[1].shape[1])
            mean = population_grad.sum_in_order(sse) * inv_n
            same(population_grad.restart_sse_and_grad(net, *args, 8),
                 (torch.where(torch.isfinite(mean), mean, torch.inf),
                  population_grad.sum_in_order(gnn) * inv_n, gb * inv_n),
                 what)

        def k5_against_packed(args, what, grad_nn=True):
            """K5 against K2's packed route on the same inputs: the other
            layout of the same function, which sums over the evaluation
            points and the individuals in another order.  Without
            ``grad_nn`` the value and the beta gradient only, which no sum
            over individuals enters."""
            k5_compare(args, what,
                       (*lane_grad.packed_sse_and_grad(net, *args, 8), False),
                       grad_nn)

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
        k5_against_lanes(r_args, f"K5{sfx} against K2{sfx}'s lanes summed in "
                         "order, ragged (130 x 13)")
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
            k5_path, f"K5{sfx} wide shape ({r_wide} x {n_fit})",
            (*ref, True)))
        k5_against_lanes(k5_path, f"K5{sfx} against K2{sfx}'s lanes summed in "
                         f"order ({r_wide} x {n_fit})")
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
        device = graph_ms(lambda: population_grad.restart_sse_and_grad(
            net, *k5_path, 8), reps=10)
        # the least work is K2's, on every (restart, individual) pair; the
        # outputs are per restart
        results["K5" + sfx] = dict(
            err=err, ms=ms, device=device, plain=plain,
            shape=f"{r_wide} x {n_fit}",
            bound=bound(4 * (r_wide * (p + n_fit) + n_fit * (10 + n_kin)
                             + r_wide * (1 + p + n_fit)),
                        lanes * (69 * per_point + 32 * 47 + 480),
                        lanes * (69 * (MLP_SFU + 1) + 1)))
        ms = cuda_ms(lambda: lane_grad.lane_sse_and_grad(net, *k5_path, 8),
                     reps=20)
        device = graph_ms(lambda: lane_grad.lane_sse_and_grad(
            net, *k5_path, 8), reps=20)
        wide["K2" + sfx] = dict(
            ms=ms, device=device, shape=f"{r_wide} x {n_fit}, {lanes} lanes",
            bound=k2_bound(r_wide, n_fit))
        # the wide paths' own shapes of K3 and K1: one launch over all
        # 131,328 lanes, one over all 400,000 designs
        e, ok, counts = k3_compare(k5_path, f"K3{sfx} wide re-rank shape "
                                   f"({r_wide} x {n_fit})")
        results["K3" + sfx]["err"] = max(results["K3" + sfx]["err"], e)
        wide["K3" + sfx] = k3_timed(k5_path, ok, counts, 5)
        nn_s, b_s = designs(XL_INITS, n_fit)
        e = exact(
            rk4_population.population_sse(net, nn_s, b_s, *fit_args, 8),
            rk4_population.population_sse_reference(net, nn_s, b_s,
                                                    *fit_args, 8),
            f"K1{sfx} wide screen shape ({XL_INITS} x {n_fit})")
        results["K1" + sfx]["err"] = max(results["K1" + sfx]["err"], e)
        ms = cuda_ms(lambda: rk4_population.population_sse(
            net, nn_s, b_s, *fit_args, 8), reps=2)
        device = graph_ms(lambda: rk4_population.population_sse(
            net, nn_s, b_s, *fit_args, 8), reps=3)
        wide["K1" + sfx] = dict(ms=ms, device=device,
                                shape=f"{XL_INITS} x {n_fit}",
                                bound=k1_bound(XL_INITS))
        if d == 2:
            ablation_shapes(designs, k1_bound, k2_compare, k2_bound,
                            k3_compare, k3_timed)
            saem_shapes(k2_compare, k2_bound)
            advi_shapes(k2_compare, k2_bound)

    def ablation_shapes(designs, k1_bound, k2_compare, k2_bound, k3_compare,
                        k3_timed) -> None:
        """K1, K2 and K3 at exp05's shapes: its screen of 10,000 designs and
        its 10 restarts on the smallest (8) and the largest (82) of its
        cohorts, the subsets of ablation seed 0 from the committed rows,
        the last design of huge weights; each bit for bit its plain
        version, then timed."""
        net = chain(4, 2)
        drawn = ablation.subsets(train.types, SEED)
        for frac in (0.1, 1.0):
            sub = train.subset(drawn[frac][0])
            c = build_cohort(sub.glucose, sub.timepoints, sub.cpeptide,
                             sub.ages, sub.t2dm, dev)
            n, c_args = c.n, (c.glucose, c.cpeptide, c.kinetics(), tp)
            nn_s, b_s = designs(ABLATION_INITS, n)
            nn_s[-1] = torch.as_tensor(huge_weights(2), **f32)
            screen = (nn_s, b_s, *c_args)
            out = rk4_population.population_sse(net, *screen, 8)
            if not bool(torch.isinf(out[-1])):
                raise AssertionError(f"K1 at {ABLATION_INITS} x {n}: the "
                                     "huge-weight design's mean is not inf")
            results["K1"]["err"] = max(results["K1"]["err"], exact(
                out, rk4_population.population_sse_reference(net, *screen, 8),
                f"K1 exp05 screen shape ({ABLATION_INITS} x {n})"))
            ablation_times[f"K1 {n}"] = dict(
                ms=cuda_ms(lambda: rk4_population.population_sse(
                    net, *screen, 8), reps=5),
                device=graph_ms(lambda: rk4_population.population_sse(
                    net, *screen, 8), reps=10),
                shape=f"{ABLATION_INITS} x {n}",
                bound=k1_bound(ABLATION_INITS, n))
            # the refinement's and the re-rank's 10 restarts: 9 designs and
            # the huge one
            r = ABLATION_RESTARTS
            keep = torch.tensor([*range(r - 1), ABLATION_INITS - 1],
                                device=dev)
            refine = (nn_s[keep].contiguous(), b_s[keep].contiguous(), *c_args)
            lanes = f"{r} x {n} = {r * n} lanes"
            results["K2"]["err"] = max(results["K2"]["err"], k2_compare(
                refine, f"K2 exp05 refine shape ({lanes})"))
            ablation_times[f"K2 {n}"] = dict(
                ms=cuda_ms(lambda: lane_grad.lane_sse_and_grad(
                    net, *refine, 8), reps=50),
                device=graph_ms(lambda: lane_grad.lane_sse_and_grad(
                    net, *refine, 8), reps=50),
                shape=lanes, bound=k2_bound(r, n))
            e, ok, counts = k3_compare(refine,
                                       f"K3 exp05 re-rank shape ({lanes})")
            if bool(ok[-1].any()):
                raise AssertionError(f"K3 at {lanes}: a subject of the "
                                     "huge-weight restart did not fail")
            results["K3"]["err"] = max(results["K3"]["err"], e)
            ablation_times[f"K3 {n}"] = k3_timed(refine, ok, counts, 20)

    def saem_shapes(k2_compare, k2_bound) -> None:
        """K4 and K2 at SAEM's shapes (exp06): K4 over a step's proposals
        and current states (2 x 82 lanes), the iteration's likelihood (82)
        and the posterior chains' step (117), on the committed pre-train
        network expanded over the lanes as the path passes it, at β's of
        an MCMC run's range (up to |β| = 5); each also with weights of
        its own a lane, the last lane's huge on a rising glucose curve; K2
        at one restart on the 82 training subjects.  Each bit for bit its
        plain version, then timed."""
        net = chain(4, 2)
        p = net.num_params
        nn_row = torch.as_tensor(np.load(ARTIFACTS / "saem_pretrain.npz")[
            "nn_params"][0], **f32)
        c_train = build_cohort(train.glucose, train.timepoints,
                               train.cpeptide, train.ages, train.t2dm, dev)
        flops, sfu = rk4_lane_work(2)
        for what, c, m in (("a step's proposals and states", c_train, 2),
                           ("an iteration's likelihood", c_train, 1),
                           ("a posterior chains' step", cohort, 1)):
            lanes = m * c.n
            betas = np.clip(rng.normal(0.5, 1.5, lanes), -5.0, 5.0)
            betas[:2] = (-5.0, 5.0)
            rows = (c.glucose.repeat(m, 1), c.cpeptide.repeat(m, 1),
                    c.kinetics().repeat(m, 1))
            path = (nn_row[None].expand(lanes, -1),
                    torch.as_tensor(betas, **f32), *rows)
            shape = f"{what} ({lanes} lanes)"
            err = exact(rk4_cohort.cohort_sse(net, *path, tp, 8),
                        rk4_cohort.cohort_sse_reference(net, *path, tp, 8),
                        f"K4 SAEM {shape}")
            own = glorot(rng, net, lanes)
            own[-1] = huge_weights(2)
            glucose = rows[0].clone()
            glucose[-1] = torch.tensor([5.0, 6.0, 7.0, 8.0, 9.0], **f32)
            lane_args = (torch.as_tensor(own, **f32), path[1], glucose,
                         *rows[1:])
            out = rk4_cohort.cohort_sse(net, *lane_args, tp, 8)
            if not bool(torch.isinf(out[-1])):
                raise AssertionError(f"K4 SAEM {shape}: the huge-weight "
                                     "lane's SSE is not inf")
            err = max(err, exact(out, rk4_cohort.cohort_sse_reference(
                net, *lane_args, tp, 8), f"K4 SAEM {shape}, a network a "
                "lane"))
            results["K4"]["err"] = max(results["K4"]["err"], err)
            saem_times[f"K4 {lanes}"] = dict(
                ms=cuda_ms(lambda: rk4_cohort.cohort_sse(net, *path, tp, 8),
                           reps=50),
                device=graph_ms(lambda: rk4_cohort.cohort_sse(
                    net, *path, tp, 8), reps=50),
                plain=cuda_ms(lambda: rk4_cohort.cohort_sse_reference(
                    net, *path, tp, 8), reps=3),
                shape=shape,
                bound=bound(4 * (p + lanes * (12 + 4)), lanes * flops,
                            lanes * sfu))
        n = c_train.n
        betas = np.clip(rng.normal(0.5, 1.5, (1, n)), -5.0, 5.0)
        grad = (nn_row[None].contiguous(), torch.as_tensor(betas, **f32),
                c_train.glucose, c_train.cpeptide, c_train.kinetics(), tp)
        shape = f"SAEM's population gradient (1 x {n} lanes)"
        results["K2"]["err"] = max(results["K2"]["err"],
                                   k2_compare(grad, f"K2 {shape}"))
        saem_times[f"K2 {n}"] = dict(
            ms=cuda_ms(lambda: lane_grad.lane_sse_and_grad(net, *grad, 8),
                       reps=50),
            device=graph_ms(lambda: lane_grad.lane_sse_and_grad(
                net, *grad, 8), reps=50),
            plain=cuda_ms(lambda: lane_grad.lane_sse_and_grad_reference(
                net, *grad, 8), reps=3),
            shape=shape, bound=k2_bound(1, n))

    def advi_shapes(k2_compare, k2_bound) -> None:
        """K2 at 4 substeps at exp_advi's shapes and K4 at its profile
        chunk: the test stage's step (the selected network over 8 sample
        rows on the 35 test subjects, 280 lanes), the joint stage's step
        (the 25 committed candidates, each over 4 sample rows, on their 57
        fit subjects, 5,700 lanes; weights and β's drawn as the first step
        draws them, e^ρ = e^-2), section 3's step (a network over 8 sample
        rows on the 82 training subjects, 656 lanes), and K4 over 500 grid
        points on [-6, 2]
        times the 35 test subjects (17,500 lanes).  Each bit for bit its
        plain version, then timed."""
        net = chain(4, 2)
        p = net.num_params
        cand = np.load(ARTIFACTS / "cude_neural_parameters.npz")
        best = json.loads((REPO / "results" / "exp02_metrics.json")
                          .read_text())["best_model_index"]
        nn_best = torch.as_tensor(cand["nn_params"][best], **f32)
        c_test = build_cohort(test.glucose, test.timepoints, test.cpeptide,
                              test.ages, test.t2dm, dev)
        s_fit = train.subset(cand["idx_fit"])
        c_fit = build_cohort(s_fit.glucose, s_fit.timepoints,
                             s_fit.cpeptide, s_fit.ages, s_fit.t2dm, dev)
        rng = np.random.default_rng(12)     # the earlier phases' draws stay
        spread = np.exp(-2.0)
        test_step = (nn_best[None].expand(ADVI_TEST_SAMPLES, -1).contiguous(),
                     torch.as_tensor(rng.normal(-1.5, 1.0, (
                         ADVI_TEST_SAMPLES, c_test.n)), **f32),
                     c_test.glucose, c_test.cpeptide, c_test.kinetics(), tp)
        rows = ADVI_RESTARTS * ADVI_JOINT_SAMPLES
        nn_rows = np.repeat(cand["nn_params"], ADVI_JOINT_SAMPLES, 0)
        b_rows = np.repeat(cand["betas"][..., 0], ADVI_JOINT_SAMPLES, 0)
        joint_step = (
            torch.as_tensor(nn_rows + spread * rng.normal(size=nn_rows.shape),
                            **f32),
            torch.as_tensor(b_rows + spread * rng.normal(size=b_rows.shape),
                            **f32),
            c_fit.glucose, c_fit.cpeptide, c_fit.kinetics(), tp)
        # section 3's step: a run's network over 8 sample rows on the 82
        # training subjects (a committed candidate stands in for the run)
        c_train = build_cohort(train.glucose, train.timepoints,
                               train.cpeptide, train.ages, train.t2dm, dev)
        reference_step = (
            torch.as_tensor(cand["nn_params"][0], **f32)[None].expand(
                ADVI_TEST_SAMPLES, -1).contiguous(),
            torch.as_tensor(rng.normal(-1.0, 1.0, (ADVI_TEST_SAMPLES,
                                                   c_train.n)), **f32),
            c_train.glucose, c_train.cpeptide, c_train.kinetics(), tp)
        for what, args, (r, n) in (
                ("the test stage's step", test_step,
                 (ADVI_TEST_SAMPLES, c_test.n)),
                ("the joint stage's step", joint_step, (rows, c_fit.n)),
                ("section 3's step", reference_step,
                 (ADVI_TEST_SAMPLES, c_train.n))):
            shape = f"exp_advi {what} ({r} x {n} = {r * n} lanes, 4 substeps)"
            results["K2"]["err"] = max(results["K2"]["err"], k2_compare(
                args, f"K2 {shape}", substeps=ADVI_SUBSTEPS))
            advi_times[f"K2 {r * n}"] = dict(
                ms=cuda_ms(lambda: lane_grad.lane_sse_and_grad(
                    net, *args, ADVI_SUBSTEPS), reps=50),
                device=graph_ms(lambda: lane_grad.lane_sse_and_grad(
                    net, *args, ADVI_SUBSTEPS), reps=50),
                plain=cuda_ms(lambda: lane_grad.lane_sse_and_grad_reference(
                    net, *args, ADVI_SUBSTEPS), reps=3),
                shape=shape, bound=k2_bound(r, n, ADVI_SUBSTEPS))
        s = 500
        lanes = s * c_test.n
        grid = torch.as_tensor(linspace(-6.0, 2.0, 2000)[:s], device=dev)

        def expand(x):
            return x.expand(s, *x.shape).reshape(lanes, *x.shape[1:])

        prof = (nn_best.expand(lanes, -1),
                (grid[:, None] + torch.zeros(c_test.n, **f32)).reshape(-1),
                expand(c_test.glucose), expand(c_test.cpeptide),
                expand(c_test.kinetics()))
        shape = f"exp_advi's profile chunk ({s} x {c_test.n} = {lanes} lanes)"
        results["K4"]["err"] = max(results["K4"]["err"], exact(
            rk4_cohort.cohort_sse(net, *prof, tp, 8),
            rk4_cohort.cohort_sse_reference(net, *prof, tp, 8), f"K4 {shape}"))
        flops, sfu = rk4_lane_work(2)
        advi_times[f"K4 {lanes}"] = dict(
            ms=cuda_ms(lambda: rk4_cohort.cohort_sse(net, *prof, tp, 8),
                       reps=20),
            device=graph_ms(lambda: rk4_cohort.cohort_sse(net, *prof, tp, 8),
                            reps=50),
            plain=cuda_ms(lambda: rk4_cohort.cohort_sse_reference(
                net, *prof, tp, 8), reps=3),
            shape=shape, bound=bound(4 * (p + lanes * (12 + 4)),
                                     lanes * flops, lanes * sfu))

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

    def gallery_shapes() -> None:
        """K4 and K4c at the gallery's ``ci_bound_sims`` chunk: 500 points
        of Δβ ∈ [-10, 15] (of 10,000) around the β̂ of the three test
        medians, on exp02's selected network (Cantelli-95 profile) and on
        exp07's (Raue-95), 1,500 lanes.  Each bit for bit its plain
        version, then timed."""
        grid = torch.as_tensor(linspace(-10.0, 15.0, FIGURES_CI_STEPS)[
            :FIGURES_CHUNK], device=dev)
        for kid, d, fit, cand in (
                ("K4", 2, fit_ckpt, np.load(
                    ARTIFACTS / "cude_neural_parameters.npz")["nn_params"][
                    meta["best_model_index"]]),
                ("K4c", 3, cov_ckpt,
                 cov_cand["nn_params"][cov_meta["best_model_index"]])):
            net = chain(4, 2, input_dims=d)
            idx = figures_reference()[
                "cude" if kid == "K4" else "covariate"]["idx_med_test"]
            c = build_cohort(test.glucose[idx], test.timepoints,
                             test.cpeptide[idx], test.ages[idx],
                             test.t2dm[idx], dev)
            n = len(idx)
            lanes = FIGURES_CHUNK * n

            def expand(x):
                return x.expand(FIGURES_CHUNK, *x.shape).reshape(
                    lanes, *x.shape[1:])

            centre = torch.as_tensor(fit["beta_test"][idx], **f32)
            path = (torch.as_tensor(cand, **f32).expand(lanes, -1),
                    (grid[:, None] + centre[None, :]).reshape(-1),
                    expand(c.glucose), expand(c.cpeptide),
                    expand(c.kinetics(with_age=d == 3)))
            shape = (f"the gallery's CI chunk ({FIGURES_CHUNK} x {n} = "
                     f"{lanes} lanes)")
            results[kid]["err"] = max(results[kid]["err"], exact(
                rk4_cohort.cohort_sse(net, *path, tp, 8),
                rk4_cohort.cohort_sse_reference(net, *path, tp, 8),
                f"{kid} {shape}"))
            flops, sfu = rk4_lane_work(d)
            gallery_times[f"{kid} {lanes}"] = dict(
                ms=cuda_ms(lambda: rk4_cohort.cohort_sse(net, *path, tp, 8),
                           reps=50),
                device=graph_ms(lambda: rk4_cohort.cohort_sse(
                    net, *path, tp, 8), reps=50),
                plain=cuda_ms(lambda: rk4_cohort.cohort_sse_reference(
                    net, *path, tp, 8), reps=3),
                shape=shape,
                bound=bound(4 * (net.num_params + lanes * (12 + 4 + (d == 3))),
                            lanes * flops, lanes * sfu))

    ablation_times = {}     # K1, K2 and K3 at exp05's shapes
    saem_times = {}         # K4 and K2 at SAEM's shapes
    advi_times = {}         # K2 and K4 at exp_advi's shapes
    gallery_times = {}      # K4 and K4c at the gallery's CI chunk
    kernel_phase(2)
    kernel_phase(3)
    live_age_check()
    gallery_shapes()

    def notes(r) -> str:
        plain = f", plain {r['plain']:.3f} ms" if "plain" in r else ""
        steps = (f", longest lane {r['max_lane_steps']} steps, "
                 f"{r['us_per_step']:.3f} us a step"
                 if "max_lane_steps" in r else "")
        return (f" ({r['device']:.4f} ms on the device, CUDA graph){plain}, "
                f"bound {r['bound'][0]:.6f} ms ({r['bound'][1]}){steps}")

    for kid, r in [*results.items(), *wide.items(),
                   *ablation_times.items(), *saem_times.items(),
                   *advi_times.items(), *gallery_times.items()]:
        log(f"[time] {kid.split()[0]} at {r['shape']}: kernel "
            f"{r['ms']:.4f} ms{notes(r)}  [{card}]")
    if args.kernels_only:
        log(json.dumps({"ok": None, "partial": "kernels"}))
        return
    side = start_side()

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
        failures += check_exports(res, covariate,
                                  REPO / "build" / "chip_smoke_exports")
        if results[kid]["launches"] == 0:
            failures.append(f"{kid} was not launched by the profile scans")
        if not covariate:
            model = CPeptideModel(chain(4, 2))
            best = np.load(ARTIFACTS / "cude_neural_parameters.npz")[
                "nn_params"][meta["best_model_index"]]
            failures += check_dose_response(dose_response(
                model, params_from_jax(best, model.net, dev),
                fit_ckpt["beta_train"], train.glucose))
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

    # -- the paths run beside the ones above ----------------------------------
    finish_side(side, t_start)
    log(f"[time] whole script: {time.perf_counter() - t_start:.2f} s  "
        f"[{card}]")

    log(json.dumps({"kernels": [{
        "name": library(kid).name,
        "route": "cuda",
        "source": str(library(kid).source.relative_to(REPO)),
        "replaces": REPLACES[kid],
        "launches": r["launches"],
        "max_abs_err": r["err"],
        "ms": r["ms"],
        "device_ms": r.get("device"),
        "plain_ms": r["plain"],
        "bound_ms": r["bound"][0],
        "bound_by": r["bound"][1],
        "library_ms": None,
        **{key: r[key] for key in ("max_lane_steps", "us_per_step")
           if key in r},
    } for kid, r in results.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


# the paths beside the main one run in child processes, one list each,
# started once the kernels are timed: those that launch no kernel (exp01,
# the symbolic refits, SAEM on the analytic heads: eager PyTorch,
# host-bound), the replication experiments (exp02_seeds and exp05 train, so
# they launch K1, K2 and K3), SAEM on the cUDE (K4 and K2), and exp_advi (K2
# and K4) then exp_suppression and exp_symreg_search (no kernel) after
# exp_symreg_production, and the gallery (K4 and K4c) and the mesh path
# (K1-K4, K4c) after exp01's retrains at two seeds, the child that ended
# first, and the ETL path (K2 in its section-3 stage) after the symbolic
# refits, the child that ended first after that
SIDE = (("exp01 frozen", "exp01 retrain", "exp03", "exp04", "etl"),
        ("exp_symreg_production", "exp_advi", "exp_suppression",
         "exp_symreg_search"),
        (*(f"exp01 retrain, seed {seed}" for seed in UDE_SEEDS[1:]),
         "exp_figures", "mesh"),
        ("exp02_seeds",),
        ("exp05", "replicate"),
        ("exp06", "exp06a"),
        ("exp06 retrain, seed 11", "exp06b"))
SIDE_WAIT = 1150.0       # seconds from the start by which the children end
SIDE_MARGIN = 100.0      # the children should end this much before SIDE_WAIT
TRAINING_KERNELS = frozenset({"rk4_population", "lane_grad", "tsit5_cohort"})
# exp02_seeds beside the main run: two of the JAX experiment script's five
# seeds, then the merge of the two
SEEDS_RUN = (11, 22)
# exp05 beside the main run: ablation seed 0 at its smallest cohort, a
# middle one and the fraction that holds nothing out, each held to the
# committed five-seed range of its test-SSE median
# (results/exp05_ablation.csv) widened by 10 %
ABLATION_LIMITS = {0.1: (8, 0.1809, 0.3992), 0.5: (41, 0.1526, 0.2417),
                   1.0: (82, 0.1672, 0.2732)}
REPLICATE_SEEDS = (11, 22)
# SAEM: the two packages' random streams differ, so each run is held to the
# spread of the JAX package's own experiments on the CPU over their keys and 30
# further key pairs (python scripts/saem_reference.py --keys 30: the
# metrics' least and greatest over 31 runs each), widened by half its width
# on each side (``widen``)
SAEM_SPREAD = {
    "exp06a": {"km_pop": (67.4859, 97.7738), "sigma": (0.25367, 0.254693),
               "omega": (0.731691, 0.74891),
               "final_nll": (-507.466, -505.592),
               "km_map_median": (48.1755, 48.615),
               "map_mle_correlation": (0.998218, 0.998538),
               "posterior_acceptance_mean": (0.296115, 0.304577)},
    "exp06b": {"b_pop": (-0.511179, 0.501692),
               "sigma": (0.346046, 0.419735), "omega": (0.251437, 0.59162),
               "final_nll": (-328.031, -215.284),
               "b_map_median": (-0.503937, 0.502467),
               "map_mle_correlation": (0.704971, 0.830647),
               "posterior_acceptance_mean": (0.29609, 0.304496),
               "spearman_b_map_first_phase": (-0.827885, 0.826814)},
    "exp06": {"sigma": (0.349648, 0.763924),
              "omega": (0.00250644, 23.6156),
              "eta": (-3.0233, 1.31918),
              "final_nll": (-240.103, 94.237),
              "final_acceptance": (0.0282927, 0.622439),
              "posterior_acceptance_mean": (0.274662, 0.303893),
              "mse_map_per_type.NGT": (0.0771735, 0.838286),
              "mse_map_per_type.IGT": (0.0658641, 2.41702),
              "mse_map_per_type.T2DM": (0.0698845, 0.754328),
              "posterior_map_spearman": (-0.403865, 0.998322),
              "consistent_omega.sigma": (0.329206, 0.718088),
              "consistent_omega.omega": (0.380221, 2.80447),
              "consistent_omega.eta": (-0.778871, 1.75062),
              "consistent_omega.final_nll": (-268.465, 61.8123),
              "consistent_omega.posterior_acceptance_mean": (0.289098,
                                                             0.31518),
              "consistent_omega.mse_map_per_type.NGT": (0.0724547, 0.465439),
              "consistent_omega.mse_map_per_type.IGT": (0.0673014, 0.931897),
              "consistent_omega.mse_map_per_type.T2DM": (0.0683719, 0.388275),
              "consistent_omega.posterior_map_spearman": (-0.633368, 0.952862)},
}
# JAX's own individual_maps and individual_mles on the CPU, from the fixed
# effects of artifacts/saem_fit.npz, miss its beta_map and beta_mle by these
# at the median over the 117 subjects and at most (beta_mle: over all but
# subject 84, whose likelihood is flat and which it misses by 0.6952; the
# same script's ``miss``); the port's are held to twice each
SAEM_MISS = {"beta_map": {"max": 4.316e-5, "median": 1.669e-6},
             "beta_mle": {"max": 1.003e-3, "median": 3.038e-4}}
SAEM_FLAT_SUBJECT, SAEM_FLAT_MISS = 84, 0.6952
# exp06 retrained at seed 11: the spread of JAX's exp06 on the CPU from the
# pre-train the port retrains at seed 11 (``saem_pretrain.npz`` of
# ``python -m conditional_ude_tpu_torch --experiment exp06 --retrain --seed 11
# --out DIR`` on the card; two runs there gave the same metrics), over its
# keys and 30 further key pairs (``scripts/saem_reference.py --pretrain FILE
# --only exp06 --keys 30``), widened as ``SAEM_SPREAD``
SAEM_RETRAIN_SPREAD = {
    "sigma": (0.290044, 0.773513),
    "omega": (0.00754627, 38.2286),
    "eta": (-5.3094, 1.78717),
    "final_nll": (-334.037, 97.9025),
    "final_acceptance": (0.0370732, 0.805366),
    "posterior_acceptance_mean": (0.284312, 0.314795),
    "mse_map_per_type.NGT": (0.0857385, 0.835373),
    "mse_map_per_type.IGT": (0.0611471, 1.2761),
    "mse_map_per_type.T2DM": (0.0646251, 0.897619),
    "posterior_map_spearman": (-0.337012, 0.99955),
    "consistent_omega.sigma": (0.262198, 0.658235),
    "consistent_omega.omega": (0.467878, 4.34092),
    "consistent_omega.eta": (-3.8768, 1.43849),
    "consistent_omega.final_nll": (-353.819, 42.9306),
    "consistent_omega.posterior_acceptance_mean": (0.287175, 0.307799),
    "consistent_omega.mse_map_per_type.NGT": (0.0870105, 1.15031),
    "consistent_omega.mse_map_per_type.IGT": (0.0611852, 3.04497),
    "consistent_omega.mse_map_per_type.T2DM": (0.0585541, 6.11564),
    "consistent_omega.posterior_map_spearman": (-0.528496, 0.998876)}
SAEM_KERNELS = frozenset({"rk4_cohort", "lane_grad"})
# exp_advi: K2 at 4 substeps, one launch a step of each stage (25 restarts x
# 4 samples over 57 fit subjects, then 8 samples over 35 test subjects),
# and K4 over the profile's 2,000 points in 4 chunks of 500
ADVI_RESTARTS, ADVI_JOINT_SAMPLES, ADVI_TEST_SAMPLES = 25, 4, 8
ADVI_SUBSTEPS = 4
ADVI_JOINT_STEPS, ADVI_TEST_STEPS, ADVI_PROFILE_CHUNKS = 2000, 1500, 4
ADVI_KERNELS = frozenset({"lane_grad", "rk4_cohort"})
# the reduced run of both stages on the card and on the CPU from the same
# draws: K2 is bit for bit its plain version, so only the eager float32 ops
# differ (on the card a division by a Python number is a multiply by its
# reciprocal; exp and log round differently), each step's rounding carried
# into the next by Adam; held at the tolerance at which the port on the
# CPU matches the JAX package (tests/test_torch_advi.py), whose K2 sums in
# another order
ADVI_REDUCED = dict(restarts=2, joint_steps=200, test_steps=200,
                    profile_steps=200)
ADVI_SAME_RTOL, ADVI_SAME_ATOL = 1e-4, 1e-5
# the reduced run's CPU half takes this many threads, not the machine's
# cores, which the main paths and the other children use beside it
ADVI_CPU_THREADS = 2
# the JAX package's exp_advi body on the CPU (python scripts/advi_reference.py
# --keys 60 --only test, --keys 30 --only joint): each metric's least and
# greatest over the script's key and 60 further keys (the test stage) or 30
# (the joint stage), widened by half the width on each side (``widen``)
ADVI_SPREAD = {
    "test_spearman_first_phase": (-0.860545, -0.855782),
    "test_beta_std_median": (0.0506728, 0.0586996),
    "advi_sd_vs_profile_ci_corr": (0.917983, 0.929805),
    "identifiable_fraction": (30 / 35, 30 / 35),
    "joint_elbo_final_best": (-155.857, -119.891),
    "joint_beta_pointfit_corr_mean": (0.781051, 0.802499),
}
# each test subject's least and greatest beta_mean and beta_std over the
# same 61 test-stage runs (``per_subject``), widened as ``ADVI_SPREAD``
ADVI_SUBJECT_SPREAD = {
    "beta_mean": (
        [-1.05519, -3.76813, -0.886551, -1.09525, -1.8544, -1.24428, -3.7427,
         -0.939806, -0.770185, -1.44936, -1.12406, -0.973718, -0.91097,
         -1.11135, -0.760989, -0.789948, -0.838881, -1.479, -0.948866,
         -0.687597, -0.223718, -0.0432996, -0.134628, 0.180771, -0.198614,
         -0.287604, -0.135011, -0.39991, -0.642944, -0.277926, -2.64404,
         -0.379007, -0.121602, -0.276087, -0.0816495],
        [-1.04486, -3.70166, -0.87714, -1.08595, -1.83325, -1.22328, -3.65021,
         -0.904578, -0.762523, -1.43988, -1.11785, -0.97025, -0.904178,
         -1.09665, -0.750596, -0.781919, -0.826884, -1.46318, -0.944041,
         -0.681021, -0.218377, -0.0336401, -0.127596, 0.284703, -0.19324,
         -0.281195, -0.129497, -0.391047, -0.638009, -0.274941, -2.57085,
         -0.364177, -0.115458, -0.270247, -0.0763422]),
    "beta_std": (
        [0.0726361, 0.833166, 0.0628515, 0.0746606, 0.211143, 0.163, 0.733328,
         0.303968, 0.0361656, 0.0843766, 0.0488006, 0.0257639, 0.0452093,
         0.121641, 0.056814, 0.0612054, 0.107298, 0.121645, 0.0308754,
         0.0338266, 0.0337863, 0.049923, 0.0449151, 0.0898995, 0.025397,
         0.0461386, 0.0187735, 0.0498791, 0.0216614, 0.00810896, 0.772146,
         0.0967415, 0.030001, 0.0265747, 0.0263272],
        [0.0778866, 0.910065, 0.0662276, 0.077993, 0.226293, 0.171756,
         0.80283, 0.322383, 0.0381675, 0.0890344, 0.0513543, 0.0269607,
         0.0482635, 0.128151, 0.0603543, 0.0647054, 0.112299, 0.128155,
         0.0322877, 0.0358353, 0.0376898, 0.0612973, 0.049779, 0.16182,
         0.027865, 0.0491587, 0.0242041, 0.0526796, 0.0226729, 0.0103324,
         0.830906, 0.101965, 0.0434651, 0.0300916, 0.0354498]),
}

# exp_suppression: no kernel serves it.  The committed test stage at the
# λ = 0.01 artifact (results/exp_suppression_metrics.json) and the limit of
# its Spearmans and of each revalidated restart's correlation_valid;
# JAX-CPU's own largest relative miss of the committed loss_valid of those
# 25 restarts revalidated at full depth (scripts/suppression_reference.py
# --only test: restart 24, whose refit is the least determined), of which
# the port's may miss twice
SUPPRESSION_TEST_STAGE = {"selected_restart": 4, "best_valid_rho_restart": 5,
                          "spearman": 0.7568213392609059,
                          "spearman_best_valid_rho_restart":
                              0.8531814392886915}
SUPPRESSION_RHO_TOL = 0.01
SUPPRESSION_VALID_MISS = 7.912e-3
# JAX-CPU's largest relative miss of each committed
# artifacts/suppression_lambda=<λ>.npz's objectives, on its own training
# data (scripts/suppression_reference.py --only artifacts); the port's loss
# is held to max(1e-4, twice that)
SUPPRESSION_ARTIFACT_MISS = {
    0.0: 4.241e-4, 0.001: 5.746e-05, 0.01: 2.134e-05,
    0.015848931925: 1.454e-05, 0.025118864315: 1.061e-05, 0.039810717055: 2.027e-05,
    0.063095734448: 1.919e-05, 0.1: 1.693e-05, 0.158489319246: 1.669e-05,
    0.251188643151: 1.299e-05, 1.0: 9.203e-05, 10.0: 2.73e-05,
    100.0: 1.293e-05, 1000.0: 1.788e-06}
# the reduced retrain beside the main run: the full population, network,
# designs and restarts, fewer steps and validation candidates.  A
# value+grad takes ~0.25-0.4 s of host time alone on an H100 80GB HBM3 at
# 700 W (~22,000 launches of eager PyTorch, 45 ms of device time) whatever
# the rows, so the steps are cut: 100 Adam and 5 L-BFGS (the validations'
# too), and the frozen test stage's L-BFGS to SUPPRESSION_TEST_LBFGS steps
# (its full depth, 2,000, took 954.65 s alone on that card:
# scripts/suppression_runs.py)
SUPPRESSION_REDUCED = dict(initial_space=10_000, select_best_n=25,
                           adam_iters=100, lbfgs_iters=5, valid_inits=1000)
SUPPRESSION_TEST_LBFGS = 20
# JAX-CPU's --test-only with its L-BFGS cut to SUPPRESSION_TEST_LBFGS steps
# (scripts/suppression_reference.py --only test --lbfgs-iters 20): the
# selections and Spearmans (± SUPPRESSION_RHO_TOL) the card's cut run is
# held to, and each restart's loss_valid (within SUPPRESSION_CUT_RTOL) and
# correlation_valid (± SUPPRESSION_RHO_TOL).  Not the restarts that the cut
# leaves undetermined, SUPPRESSION_CUT_UNDETERMINED: JAX-CPU's own refits
# of them move by more than those limits when the candidates move one
# float32 ulp (--perturb, then --compare: restart 24 by 3.3 % and 0.0102,
# 23 by 0.59 %, 3 by 0.10 %; every other restart by 5e-5 at most), since
# L-BFGS in float32 is chaotic mid-descent; they are printed as a report
SUPPRESSION_CUT = {
    "selected_restart": 8, "best_valid_rho_restart": 13,
    "spearman": 0.8865240345,
    "spearman_best_valid_rho_restart": 0.9220894693,
    "loss_valid": np.asarray([
        0.40428326, 0.3895908, 0.38452187, 1.8129168, 0.47621715,
        0.38943484, 0.38049975, 0.37919179, 0.37897202, 0.40047902,
        2.4512663, 0.40034291, 0.38516685, 0.38548964, 0.39439034,
        0.39051285, 0.40364966, 0.38655746, 0.42014727, 0.42459783,
        0.40676895, 0.39163283, 0.39194605, 1.0059018, 1.0040753]),
    "correlation_valid": np.asarray([
        0.97063404, 0.95817575, 0.92791991, 0.12569522, 0.83982202,
        0.97152392, 0.96751947, 0.96529477, 0.96529477, -0.97196885,
        -0.91679644, -0.88876529, 0.95995551, 0.97196885, 0.96440489,
        -0.96084538, 0.96440489, -0.96484983, 0.96573971, 0.85272525,
        0.96307008, -0.96618465, 0.70189099, 0.75305895, 0.78286986])}
SUPPRESSION_CUT_RTOL = 1e-3
SUPPRESSION_CUT_UNDETERMINED = (3, 23, 24)
# JAX-CPU's reduced retrain at SUPPRESSION_REDUCED (10,000 designs, 25
# restarts, 100 Adam and 5 L-BFGS steps, 1,000 validation candidates) over
# 16 keys (scripts/suppression_reference.py --only spread --seeds 270523 11
# 22 ... 165, then --merge; the merged output is
# scripts/suppression_spread.json): each λ's least and greatest, widened
# as SAEM_SPREAD.  At this depth the λ = 1 network is not yet flat, so its
# ρ's spread; at full depth it is (the committed run's λ ≥ 1 restarts
# all have validation ρ −0.2436, results/suppression_selection_sensitivity)
SUPPRESSION_SPREAD = {
    "0.0": {
        "best_correlation_train": (0.29255571360834515, 0.6064485538169748),
        "best_correlation_valid": (0.9692992213570634, 0.9826473859844269),
        "best_objective": (1.5556408166885376, 1.7411478757858276)},
    "0.001": {
        "best_correlation_train": (0.29255571360834515, 0.6064485538169748),
        "best_correlation_valid": (0.9706340378197997, 0.9839822024471635),
        "best_objective": (1.5796664953231812, 1.7611535787582397)},
    "0.01": {
        "best_correlation_train": (0.2726410621147463, 0.6064485538169748),
        "best_correlation_valid": (0.971078976640712, 0.9822024471635149),
        "best_objective": (1.7622030973434448, 1.9345649480819702)},
    "0.1": {
        "best_correlation_train": (0.27240398293029866, 0.6102418207681365),
        "best_correlation_valid": (0.9759733036707454, 0.9835372636262512),
        "best_objective": (2.583693504333496, 3.0973563194274902)},
    "1.0": {
        "best_correlation_train": (0.23992413466097673, 0.5723091512565197),
        "best_correlation_valid": (0.435817575083426, 0.7383759733036708),
        "best_objective": (4.784222602844238, 4.82206392288208)}}


# exp_symreg_search: one GP run of each of the script's configurations at
# full width and the script's 300 generations (its child ends first, with
# room for them, so nothing is cut).  torch's draws are not JAX's and a GP
# run is chaotic in its draws, so each run's best loss (the last row of its
# Pareto front), front size and best holdout MSE are held to the spread of
# the JAX package's runs at 16 keys of the same configuration on the CPU
# (python scripts/symreg_reference.py; the keys' values are
# scripts/symreg_spread.json), widened as SAEM_SPREAD
SYMREG_GENERATIONS = 300
SYMREG_SPREAD = {
    4: {"best_loss": (0.0005309018888510764, 0.02532055787742138),
        "pareto_size": (4, 11),
        "best_holdout_mse": (0.0005397972076470455, 0.021665909015176312)},
    5: {"best_loss": (0.0005807605339214206, 0.009422264993190765),
        "pareto_size": (5, 10),
        "best_holdout_mse": (0.0006408460783514485, 0.010078582539795369)}}
SYMREG_REFERENCE_MSE = 0.005350096      # results/exp_symreg_metrics.json
SYMREG_REFERENCE_RTOL = 1e-6
# exp_figures: ci_bound_sims profiles three subjects over 10,000 points of
# Δβ in chunks of 500 (analysis/profiles.py), one launch of K4 (the cUDE)
# and of K4c (the covariate model) a chunk; the JAX package's values on the
# CPU from the committed fits (scripts/figures_reference.py) and the limits
# the card's gallery is held to
FIGURES_CI_STEPS, FIGURES_CHUNK = 10_000, 500
FIGURES_LAUNCHES = FIGURES_CI_STEPS // FIGURES_CHUNK
FIGURES_KERNELS = frozenset({"rk4_cohort", "rk4_cohort (3-input)"})
FIGURES_REFERENCE = REPO / "scripts" / "figures_reference.json"
FIGURES_CI_TOL = 2 * 25.0 / FIGURES_CI_STEPS      # two grid steps of Δβ
FIGURES_CI_SIMS = dict(rtol=1e-3, atol=1e-4)
FIGURES_CURVES = dict(rtol=1e-4, atol=1.6e-4)     # exp02's table
FIGURES_TRAJ = dict(rtol=1e-4, atol=1e-5)
FIGURES_BETA_TOL, FIGURES_RHO_TOL = 1e-2, 0.01
FIGURES_BEST = {"exp02": 19, "exp07": 16}   # artifacts/cude*_fit.json
# the mesh path: each sharded subsystem at full width on a 2-way mesh of
# cuda:0 (and on every card where there are more), beside its unsharded
# run.  The lanes of the screen, the profiles and the refit are
# independent, so those are held bit for bit; the rest at the JAX suite's
# tolerances (tests/test_parallel.py): training objectives rtol 5e-3, SAEM's
# nll_trace atol 1e-4 and θ atol 1e-5, the suppression sweep rtol 5e-2 +
# atol 1e-4.  Every stage of both runs must launch exactly the kernels
# named in MESH_STAGE_KERNELS, the sharded run twice as often
MESH_SHARDS = 2
MESH_CUT = dict(adam_iters=10, lbfgs_iters=10)
MESH_TRAIN_RTOL, MESH_OBJ_MAX = 5e-3, 0.30       # exp02's retrain limit
MESH_CENSUS_STEPS, MESH_PROFILE_STEPS = 1_000, 10_000
# the refit and the sweep launch no kernel and their lanes are independent,
# so bit for bit does not depend on depth: each runs the fewest steps that
# still pad, split and gather (their eager steps dominated the path's time)
MESH_REFIT_LBFGS = 10
MESH_SAEM = dict(iterations=4, burnin=2, n_mcmc_steps=25,
                 initial_mcmc_steps=25)   # exp06's steps, 4 iterations
MESH_SAEM_ATOL = {"nll_trace": 1e-4, "theta": 1e-5}
MESH_SWEEP_STEPS = dict(adam_iters=10, lbfgs_iters=10)
MESH_SWEEP_TOL = dict(rtol=5e-2, atol=1e-4)
MESH_STAGE_KERNELS = {
    "train cut": {"rk4_population", "lane_grad", "tsit5_cohort"},
    "census": {"rk4_cohort"}, "test profile": {"rk4_cohort"},
    "exp07 test profile": {"rk4_cohort (3-input)"}, "refit": set(),
    "saem": {"rk4_cohort", "lane_grad"}, "sweep": set()}
# the ETL path: exp_parity at the golden network, held to the committed
# metrics (the SSEs relative, the β mean absolute), and section 3 of
# exp_advi at the first ETL_RUNS committed candidates
ETL_PARITY = REPO / "tests" / "golden" / "reference_parity_golden.npz"
ETL_PARITY_METRICS = REPO / "results" / "exp_parity_metrics.json"
ETL_SSE_RTOL = 0.03
ETL_BETA_ATOL = 1e-2
ETL_RUNS = 3
ETL_STAGE_KERNELS = {"exp00": {}, "exp_parity": {},
                     "section 3": {"lane_grad": ETL_RUNS * 800}}
MESH_KERNELS = frozenset({"rk4_population", "lane_grad", "tsit5_cohort",
                          "rk4_cohort", "rk4_cohort (3-input)"})


def new_paths(dev):
    """Name -> (run, check, the kernels it must launch) of each path beside
    the main one; every other kernel must launch 0 times."""
    from conditional_ude_tpu_torch.pipeline import SEED, run_ude_pipeline
    from conditional_ude_tpu_torch.saem_pipeline import run_exp06a, run_exp06b
    from conditional_ude_tpu_torch.symbolic_pipeline import (
        run_exp03,
        run_exp04,
        run_symreg_production,
    )
    none = frozenset()
    retrains = {
        "exp01 retrain" + ("" if seed == SEED else f", seed {seed}"): (
            lambda seed=seed: run_ude_pipeline(dev, ARTIFACTS, retrain=True,
                                               seed=seed),
            check_ude_retrain, none)
        for seed in UDE_SEEDS}
    return {
        "exp01 frozen": (lambda: run_ude_pipeline(dev, ARTIFACTS),
                         check_ude_frozen, none),
        **retrains,
        "exp03": (lambda: run_exp03(dev, ARTIFACTS), check_exp03, none),
        "exp04": (lambda: run_exp04(dev, ARTIFACTS), check_exp04, none),
        "exp_symreg_production": (
            lambda: run_symreg_production(dev, ARTIFACTS),
            check_symreg_production, none),
        "exp02_seeds": (lambda: run_seeds_path(dev), check_seeds_path,
                        TRAINING_KERNELS),
        "exp05": (lambda: run_ablation_path(dev), check_ablation_path,
                  TRAINING_KERNELS),
        "replicate": (lambda: run_replicate_path(dev), check_replicate_path,
                      none),
        "exp06": (lambda: run_saem_path(dev), check_saem_path, SAEM_KERNELS),
        "exp06 retrain, seed 11": (
            lambda: run_saem_path(dev, seed=11, retrain=True),
            check_saem_retrain, SAEM_KERNELS | TRAINING_KERNELS),
        "exp_advi": (lambda: run_advi_path(dev), check_advi_path,
                     ADVI_KERNELS),
        "exp_suppression": (lambda: run_suppression_path(dev),
                            check_suppression_path, none),
        "exp_symreg_search": (lambda: run_symreg_search_path(dev),
                              check_symreg_search_path, none),
        "exp_figures": (lambda: run_figures_path(dev), check_figures_path,
                        FIGURES_KERNELS),
        "mesh": (lambda: run_mesh_path(dev), check_mesh_path, MESH_KERNELS),
        "etl": (lambda: run_etl_path(dev), check_etl_path,
                frozenset({"lane_grad"})),
        "exp06a": (lambda: run_exp06a(dev, ARTIFACTS),
                   lambda res: check_saem_spread(res.metrics, "exp06a"), none),
        "exp06b": (lambda: run_exp06b(dev, ARTIFACTS),
                   lambda res: check_saem_spread(res.metrics, "exp06b"),
                   none)}


def run_seeds_path(dev):
    """exp02_seeds at ``SEEDS_RUN`` through the package's functions, as
    ``--experiment exp02_seeds`` runs them, then the merge of their
    records (under ``build/``)."""
    import shutil
    from types import SimpleNamespace

    from conditional_ude_tpu_torch import seeds
    from conditional_ude_tpu_torch.pipeline import run_training_pipeline
    out = REPO / "build" / "chip_smoke_seeds"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    results, seconds = {}, {}
    for s in SEEDS_RUN:
        res = run_training_pipeline(dev, ARTIFACTS, seed=s, profile_steps=0,
                                    census_steps=0)
        record = seeds.seed_record(res, s)
        seeds.seed_path(out, s).write_text(json.dumps(record, indent=2))
        results[s] = (res, record)
        seconds.update({f"seed {s} {k}": v for k, v in res.seconds.items()})
        seconds.update({f"seed {s} train_{k}": res.training.timings[k]
                        for k in ("screen", "adam", "lbfgs", "final_eval")})
    return SimpleNamespace(results=results, seconds=seconds,
                           summary=seeds.merge_directory(out))


def run_ablation_path(dev):
    """exp05 at ablation seed 0 and the fractions of ``ABLATION_LIMITS``,
    each on its subset as the full sweep draws it."""
    from types import SimpleNamespace

    from conditional_ude_tpu_torch import ablation
    from conditional_ude_tpu_torch.pipeline import SEED
    fractions = tuple(ABLATION_LIMITS)
    rows = ablation.run_ablation(dev, ARTIFACTS, SEED, n_seeds=1,
                                 fractions=fractions)
    return SimpleNamespace(
        rows=rows, metrics=ablation.aggregate_ablation(rows, fractions),
        seconds={f"fraction {r['fraction']}": r["seconds"] for r in rows})


def run_replicate_path(dev):
    """The replication runner over exp01 (frozen) at ``REPLICATE_SEEDS``:
    one child process a seed, on ``dev`` (under ``build/``)."""
    import shutil
    from types import SimpleNamespace

    from conditional_ude_tpu_torch import replicate
    out = REPO / "build" / "chip_smoke_replicate"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    replicate.main(["--experiment", "exp01", "--seeds",
                    *map(str, REPLICATE_SEEDS), "--out", str(out), "--",
                    "--device", str(dev)])
    return SimpleNamespace(
        result=json.loads((out / "replicate_exp01.json").read_text()),
        seconds={"children": time.perf_counter() - t0})


def run_saem_path(dev, seed: int | None = None, retrain: bool = False):
    """exp06 through ``run_exp06`` (both Ω modes, the chains, MAPs and MLEs
    of all 117 subjects), the kernels' launches over it, and, on the
    committed pre-train, MAPs and MLEs from the fixed effects of
    ``artifacts/saem_fit.npz``, which launch no kernel."""
    from types import SimpleNamespace

    from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
    from conditional_ude_tpu_torch.fit import saem
    from conditional_ude_tpu_torch.models.cpeptide import (
        CPeptideModel,
        build_cohort,
    )
    from conditional_ude_tpu_torch.nn import chain
    from conditional_ude_tpu_torch.ops import lane_grad, rk4_cohort
    from conditional_ude_tpu_torch.saem_pipeline import run_exp06
    kw = {} if seed is None else {"seed": seed}
    run = run_exp06(dev, ARTIFACTS, retrain=retrain, **kw)
    out = SimpleNamespace(run=run, metrics=run.metrics,
                          seconds=dict(run.seconds),
                          launches={"K4": rk4_cohort.launches,
                                    "K2": lane_grad.launches})
    if retrain:
        return out
    both = OhashiSplit.concatenate(*load_npz(ARTIFACTS / "ohashi.npz"))
    ll = saem.cude_loglik(CPeptideModel(chain(4, 2)), build_cohort(
        both.glucose, both.timepoints, both.cpeptide, both.ages, both.t2dm,
        dev))
    fit = np.load(ARTIFACTS / "saem_fit.npz")
    theta, sigma, eta, omega = (torch.as_tensor(fit[k], device=dev) for k in
                                ("nn_params", "sigma", "eta", "omega"))
    init = torch.full((both.glucose.shape[0],), float(eta), device=dev)
    t0 = time.perf_counter()
    out.maps = saem.individual_maps(ll, theta, sigma, init, eta,
                                    omega).cpu().numpy()
    out.mles = saem.individual_mles(ll, theta, sigma, init).cpu().numpy()
    out.seconds["estimators_at_committed_fit"] = time.perf_counter() - t0
    out.fit = fit
    return out


def run_advi_path(dev):
    """exp_advi.  First a reduced run of both stages (``ADVI_REDUCED``) on
    the card and on this machine's CPU (``ADVI_CPU_THREADS``), each from
    the same draws, made on the CPU.  Then, with every kernel's count at
    0, the full run through the entry point (``--experiment exp_advi --out
    DIR``, in this process, DIR under ``build/``), its counts read just
    after and its outputs read back from DIR."""
    import contextlib
    import io
    import shutil
    from types import SimpleNamespace

    from conditional_ude_tpu_torch import __main__ as entry
    from conditional_ude_tpu_torch import advi_pipeline
    from conditional_ude_tpu_torch.ops import (
        lane_grad,
        population_grad,
        rk4_cohort,
        rk4_population,
        tsit5_cohort,
    )
    from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint
    seconds, reduced = {}, {}
    threads = torch.get_num_threads()
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        if name == "cpu":
            torch.set_num_threads(ADVI_CPU_THREADS)
        t0 = time.perf_counter()
        reduced[name] = advi_pipeline.run_exp_advi(where, ARTIFACTS,
                                                   **ADVI_REDUCED)
        seconds[f"reduced, {name}"] = time.perf_counter() - t0
    torch.set_num_threads(threads)
    out = REPO / "build" / "chip_smoke_advi"
    shutil.rmtree(out, ignore_errors=True)
    stdout, stderr = io.StringIO(), io.StringIO()
    for mod in (rk4_cohort, rk4_population, lane_grad, tsit5_cohort,
                population_grad):
        mod.launches = mod.launches_age = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(
            stderr):
        entry.main(["--experiment", "exp_advi", "--out", str(out),
                    "--device", str(dev)])
    seconds["entry point"] = time.perf_counter() - t0
    launches = {"K2": lane_grad.launches, "K4": rk4_cohort.launches}
    for line in stderr.getvalue().strip().splitlines():
        log(f"[exp_advi] standard error: {line}")
    metrics = json.loads(stdout.getvalue().strip().splitlines()[-1])
    seconds.update({f"full {k}": v
                    for k, v in metrics["stage_seconds"].items()})
    return SimpleNamespace(
        reduced=reduced, metrics=metrics, launches=launches,
        joint=load_checkpoint(out / "advi_cude_results.npz")[0],
        test=load_checkpoint(out / "advi_test_posteriors.npz")[0],
        seconds=seconds)


def run_suppression_path(dev):
    """exp_suppression, which launches no kernel: the port's loss at every
    committed ``artifacts/suppression_lambda=*.npz`` on its own training
    data; ``--experiment exp_suppression --test-only --lbfgs-iters
    SUPPRESSION_TEST_LBFGS`` through the entry point (in this process, its
    outputs under ``build/``); and the reduced retrain
    (``SUPPRESSION_REDUCED``) through ``run_exp_suppression``."""
    import contextlib
    import io
    import shutil
    from types import SimpleNamespace

    from conditional_ude_tpu_torch import __main__ as entry
    from conditional_ude_tpu_torch import suppression_pipeline as pipe
    from conditional_ude_tpu_torch.models import suppression as sup
    seconds, artifacts = {}, {}
    t0 = time.perf_counter()
    data, gt = sup.generate_data(pipe.GROUP_MEANS, pipe.FULL.train,
                                 pipe.TIMEPOINTS, 0.1,
                                 rng=np.random.default_rng(pipe.DATA_SEED),
                                 device=dev)
    net = sup.suppression_net()
    for path in sorted(ARTIFACTS.glob("suppression_lambda=*.npz")):
        ck = np.load(path)
        lam = json.loads(path.with_suffix(".json").read_text())["lambda"]
        with torch.no_grad():
            loss = sup.suppression_loss(
                net, torch.as_tensor(ck["nn_params"], device=dev),
                torch.as_tensor(ck["thetas"], device=dev), data,
                pipe.TIMEPOINTS, torch.full((25,), lam, device=dev))
        artifacts[lam] = (loss.cpu().numpy(), ck["objectives"],
                          bool(np.array_equal(ck["gt_train"], gt)))
    seconds["committed artifacts"] = time.perf_counter() - t0

    out = REPO / "build" / "chip_smoke_suppression"
    shutil.rmtree(out, ignore_errors=True)
    stdout, stderr = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(
            stderr):
        entry.main(["--experiment", "exp_suppression", "--test-only",
                    "--lbfgs-iters", str(SUPPRESSION_TEST_LBFGS), "--out",
                    str(out), "--device", str(dev)])
    seconds["test-only entry point"] = time.perf_counter() - t0
    lines = stderr.getvalue().strip().splitlines()
    revalidated = next(json.loads(line)["revalidated"] for line in lines
                       if line.startswith('{"revalidated"'))
    test_only = json.loads(stdout.getvalue().strip().splitlines()[-1])
    seconds.update({f"test-only {k}": v
                    for k, v in test_only["stage_seconds"].items()})

    red = SUPPRESSION_REDUCED
    sizes = pipe.Sizes(valid_inits=red["valid_inits"], fit=sup.
                       SuppressionFitConfig(**{k: v for k, v in red.items()
                                               if k != "valid_inits"}))
    t0 = time.perf_counter()
    retrain = pipe.run_exp_suppression(dev, ARTIFACTS, sizes=sizes,
                                       no_test_stage=True)
    seconds["reduced retrain"] = time.perf_counter() - t0
    seconds.update({f"reduced {k}": v for k, v in retrain.seconds.items()})
    return SimpleNamespace(artifacts=artifacts, test_only=test_only,
                           revalidated=revalidated, retrain=retrain,
                           seconds=seconds)


def run_symreg_search_path(dev):
    """exp_symreg_search through ``run_exp_symreg_search``: one GP run of
    each of the script's configurations, at ``SYMREG_GENERATIONS``, on the
    port's own generator (keys 270523 and 270524), no output written."""
    import dataclasses

    from conditional_ude_tpu_torch import symreg_pipeline as pipe
    configs = tuple((dataclasses.replace(cfg, generations=SYMREG_GENERATIONS),
                     1) for cfg, _ in pipe.FULL)
    return pipe.run_exp_symreg_search(dev, ARTIFACTS, configs=configs)


def figures_reference() -> dict:
    """``scripts/figures_reference.json``: the JAX package's gallery arrays
    on the CPU, non-finite entries as NaN and ±inf."""
    def decode(x):
        if isinstance(x, dict):
            return {k: decode(v) for k, v in x.items()}
        if isinstance(x, list):
            return [decode(v) for v in x]
        if x is None:
            return math.nan
        return float(x) if x in ("inf", "-inf") else x

    return decode(json.loads(FIGURES_REFERENCE.read_text()))


def run_figures_path(dev):
    """exp_figures.  First ``device_trace`` around one K4 launch at the
    gallery's CI chunk (its trace must name the kernel); then, with every
    kernel's count at 0, the whole gallery at full size through
    ``run_exp_figures`` (its figures drawn under ``build/`` where
    matplotlib is installed), and the counts read just after."""
    import shutil
    from types import SimpleNamespace

    from conditional_ude_tpu_torch import figures_pipeline as fp
    from conditional_ude_tpu_torch.ops import (
        lane_grad,
        population_grad,
        rk4_cohort,
        rk4_population,
        tsit5_cohort,
    )
    from conditional_ude_tpu_torch.utils.profiling import device_trace
    out = REPO / "build" / "chip_smoke_figures"
    shutil.rmtree(out, ignore_errors=True)
    g = fp.Gallery(dev, ARTIFACTS, fp.RESULTS, fp.FULL)
    model = fp.cude_model()
    fit, meta = (np.load(ARTIFACTS / "cude_fit.npz"),
                 json.loads((ARTIFACTS / "cude_fit.json").read_text()))
    nn = torch.as_tensor(np.load(ARTIFACTS / "cude_neural_parameters.npz")[
        "nn_params"][meta["best_model_index"]], device=dev)
    sub = fp.rows(g.cohort_test, [0, 1, 2])
    lanes = FIGURES_CHUNK * sub.n
    with device_trace(out / "trace") as trace:
        rk4_cohort.cohort_sse(
            model.net, nn.expand(lanes, -1),
            torch.as_tensor(np.repeat(fit["beta_test"][None, :3],
                                      FIGURES_CHUNK, 0).ravel(), device=dev),
            sub.glucose.repeat(FIGURES_CHUNK, 1),
            sub.cpeptide.repeat(FIGURES_CHUNK, 1),
            sub.kinetics().repeat(FIGURES_CHUNK, 1),
            tuple(float(t) for t in sub.timepoints), 8)
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    mods = (rk4_cohort, rk4_population, lane_grad, tsit5_cohort,
            population_grad)
    for mod in mods:
        mod.launches = mod.launches_age = 0
    t0 = time.perf_counter()
    run = fp.run_exp_figures(dev, ARTIFACTS, out=out)
    seconds = {"gallery": time.perf_counter() - t0, **run.seconds}
    return SimpleNamespace(run=run, seconds=seconds, trace_kernels=kernels,
                           launches={"K4": rk4_cohort.launches,
                                     "K4c": rk4_cohort.launches_age})


def _launch_counts() -> dict[str, int]:
    from conditional_ude_tpu_torch.__main__ import launches
    return launches()


def _launched_since(before: dict[str, int]) -> dict[str, int]:
    after = _launch_counts()
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def run_etl_path(dev):
    """The raw-data path: exp00 through the entry point on CSV files
    written from the committed npz files (``tests/etl_fixtures.py``; in
    this process, under ``build/``), exp_parity's computation at the golden
    network and exp_advi's section 3 at ``ETL_RUNS`` committed candidates,
    each stage's seconds and launches."""
    import contextlib
    import importlib.util
    import io
    import shutil
    from types import SimpleNamespace

    from conditional_ude_tpu_torch import __main__ as entry
    from conditional_ude_tpu_torch import advi_pipeline, parity_pipeline
    from conditional_ude_tpu_torch.data.ohashi import load_npz
    sys.path.insert(0, str(REPO / "tests"))
    from etl_fixtures import write_fujita_csv, write_ohashi_csvs
    root = REPO / "build" / "chip_smoke_etl"
    shutil.rmtree(root, ignore_errors=True)
    write_ohashi_csvs(root / "data")
    write_fujita_csv(root / "data")
    h5py = importlib.util.find_spec("h5py") is not None
    log(f"[etl] h5py {'is' if h5py else 'is not'} installed here; the JLD2 "
        "readers are held to the JAX package's on the CPU only "
        "(tests/test_torch_jld2.py)")
    seconds, launched = {}, {}
    stdout = io.StringIO()
    before, t0 = _launch_counts(), time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        entry.main(["--experiment", "exp00", "--data-dir",
                    str(root / "data"), "--out", str(root / "out")])
    seconds["exp00"], launched["exp00"] = (time.perf_counter() - t0,
                                           _launched_since(before))
    exp00 = json.loads(stdout.getvalue().strip().splitlines()[-1])

    golden = np.load(ETL_PARITY)
    train, test = load_npz(root / "out" / "ohashi.npz")
    before, t0 = _launch_counts(), time.perf_counter()
    parity = parity_pipeline.run_parity(
        dev, golden["nn"], golden["betas_train"], train, test,
        json.loads(ETL_PARITY_METRICS.read_text())["best_model_index"])
    seconds["exp_parity"], launched["exp_parity"] = (
        time.perf_counter() - t0, _launched_since(before))
    seconds.update({f"exp_parity {k}": v for k, v in parity.seconds.items()})

    with np.load(ARTIFACTS / "cude_neural_parameters.npz") as z:
        ref = {"parameters": z["nn_params"][:ETL_RUNS],
               "betas": z["betas"][:ETL_RUNS, :, 0], "width": 4, "depth": 2}
    before, t0 = _launch_counts(), time.perf_counter()
    crosscheck = advi_pipeline.reference_crosscheck(dev, ref, train)
    seconds["section 3"], launched["section 3"] = (
        time.perf_counter() - t0, _launched_since(before))
    return SimpleNamespace(out=root / "out", exp00=exp00, parity=parity,
                           crosscheck=crosscheck, seconds=seconds,
                           launched=launched)


def run_mesh_path(dev):
    """The sharded subsystems (``parallel/mesh.py``) at full width, each
    unsharded then on a 2-way mesh of ``dev`` (``MESH_SHARDS``), with the
    seconds and the kernels' launches of each run: exp02's retrain cut to
    ``MESH_CUT`` steps (restarts 25 padded to 26), the census (117 x 1,000)
    and the test profiles of exp02 (35 x 10,000, K4) and exp07 (K4c), the
    (β, σ) refit of all 117 subjects at ``MESH_REFIT_LBFGS`` L-BFGS steps,
    SAEM on the 117 (``MESH_SAEM``) and the suppression sweep at the reduced
    retrain cut to ``MESH_SWEEP_STEPS``; then exp02's retrain at
    full depth on the mesh alone (the unsharded one is the main path's), its
    value+grad evaluations counted.  With more than one card the census
    and the training cut run again over all of them."""
    from types import SimpleNamespace

    from conditional_ude_tpu_torch import suppression_pipeline as sp
    from conditional_ude_tpu_torch.analysis.profiles import (
        cohort_beta_profiles,
    )
    from conditional_ude_tpu_torch.convert import params_from_jax
    from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
    from conditional_ude_tpu_torch.fit import saem
    from conditional_ude_tpu_torch.fit.train import (
        TrainConfig,
        fit_betas_sigma,
        train_conditional,
    )
    from conditional_ude_tpu_torch.models import suppression as sup
    from conditional_ude_tpu_torch.models.cpeptide import (
        CPeptideModel,
        build_cohort,
    )
    from conditional_ude_tpu_torch.nn import chain
    from conditional_ude_tpu_torch.parallel import mesh as pmesh
    from conditional_ude_tpu_torch.pipeline import SEED
    from conditional_ude_tpu_torch.utils.stats import stratified_split

    def cohort(split):
        return build_cohort(split.glucose, split.timepoints, split.cpeptide,
                            split.ages, split.t2dm, dev)

    train, test = load_npz(ARTIFACTS / "ohashi.npz")
    both = OhashiSplit.concatenate(train, test)
    idx_fit, _ = stratified_split(np.random.default_rng(SEED), train.types,
                                  0.7)
    fit_cohort, test_cohort, all_cohort = (
        cohort(train.subset(idx_fit)), cohort(test), cohort(both))
    model = CPeptideModel(chain(4, 2))
    cov_model = CPeptideModel(chain(4, 2, "tanh", input_dims=3),
                              "conditional_covariate")
    nn = torch.as_tensor(np.load(ARTIFACTS / "cude_neural_parameters.npz")[
        "nn_params"][FIGURES_BEST["exp02"]], device=dev)
    nn_cov = torch.as_tensor(np.load(
        ARTIFACTS / "cude_covariate_neural_parameters.npz")["nn_params"][
        FIGURES_BEST["exp07"]], device=dev)
    fit, cov_fit = (np.load(ARTIFACTS / f) for f in
                    ("cude_fit.npz", "cude_covariate_fit.npz"))
    lb, ub = json.loads((ARTIFACTS / "cude_fit.json").read_text())["bounds"]
    clb, cub = json.loads((ARTIFACTS / "cude_covariate_fit.json")
                          .read_text())["bounds"]
    devices = [dev] * MESH_SHARDS
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh_r = pmesh.make_mesh(("restarts",), devices=devices)
    mesh_i = pmesh.make_mesh(("individuals",), devices=devices)
    stages, seconds = {}, {}

    def run(name, shards, fn):
        before = _launch_counts()
        for c in cards:
            torch.cuda.synchronize(c)
        t0 = time.perf_counter()
        res = fn()
        for c in cards:
            torch.cuda.synchronize(c)
        sec = time.perf_counter() - t0
        after = _launch_counts()
        stages.setdefault(name, {})[shards] = {
            "seconds": sec, "launches": {
                k: after.get(k, 0) - before.get(k, 0) for k in after
                if after.get(k, 0) != before.get(k, 0)}}
        seconds[f"{name} x{shards}"] = sec
        return res

    def pair(name, plain, sharded, shards=MESH_SHARDS):
        return run(name, 1, plain), run(name, shards, sharded)

    # value+grad evaluations of the sharded trainings: K2 launches once a
    # shard each
    evals, real_vg = [0], pmesh.sharded_population_vg

    def counted_vg(*args, **kwargs):
        vg = real_vg(*args, **kwargs)

        def wrapped(nn_, b_):
            evals[0] += 1
            return vg(nn_, b_)
        return wrapped

    def train(cfg, mesh=None):
        evals[0] = 0
        return train_conditional(
            model, fit_cohort, cfg,
            generator=torch.Generator(device=dev).manual_seed(SEED),
            seed=SEED, mesh=mesh)

    out = SimpleNamespace(stages=stages, seconds=seconds)
    pmesh.sharded_population_vg = counted_vg
    try:
        cut = TrainConfig(**MESH_CUT)
        out.cut = pair("train cut", lambda: train(cut),
                       lambda: train(cut, mesh_r))
        out.cut_evals = evals[0]

        out.census = pair(
            "census",
            lambda: cohort_beta_profiles(
                model, nn, all_cohort, sigmas=np.concatenate(
                    [fit["sigma_train"], fit["sigma_test"]]), lower=-10.0,
                upper=10.0, steps=MESH_CENSUS_STEPS, center=np.concatenate(
                    [fit["beta_train"], fit["beta_test"]])),
            lambda: pmesh.sharded_beta_profiles(
                model, nn, all_cohort, mesh_i, sigmas=np.concatenate(
                    [fit["sigma_train"], fit["sigma_test"]]), lower=-10.0,
                upper=10.0, steps=MESH_CENSUS_STEPS, center=np.concatenate(
                    [fit["beta_train"], fit["beta_test"]])))
        for name, m, net_, f, lo, hi in (
                ("test profile", model, nn, fit, lb, ub),
                ("exp07 test profile", cov_model, nn_cov, cov_fit, clb, cub)):
            kw = dict(sigmas=f["sigma_test"], lower=float(lo) - 1.0,
                      upper=float(hi) + 1.0, steps=MESH_PROFILE_STEPS)
            setattr(out, name.replace(" ", "_"), pair(
                name, lambda m=m, n_=net_, kw=kw: cohort_beta_profiles(
                    m, n_, test_cohort, **kw),
                lambda m=m, n_=net_, kw=kw: pmesh.sharded_beta_profiles(
                    m, n_, test_cohort, mesh_i, **kw)))

        refit_kw = dict(initial_beta=-1.0, bounds=(float(lb), float(ub)),
                        lbfgs_iters=MESH_REFIT_LBFGS)
        out.refit = pair(
            "refit",
            lambda: fit_betas_sigma(model, nn, all_cohort, **refit_kw),
            lambda: pmesh.sharded_fit_betas(model, nn, all_cohort, mesh_i,
                                            sigma=True, **refit_kw))

        nn0 = params_from_jax(np.load(ARTIFACTS / "saem_pretrain.npz")[
            "nn_params"][0], model.net, dev)
        scfg = saem.SAEMConfig(**MESH_SAEM)
        out.saem = pair(
            "saem",
            lambda: saem.saem_cude(model, all_cohort, nn0, torch.Generator(
                device=dev).manual_seed(1), scfg),
            lambda: saem.saem_cude(
                model, pmesh.shard_cohort(all_cohort, mesh_i), nn0,
                torch.Generator(device=dev).manual_seed(1), scfg))

        data, _ = sup.generate_data(sp.GROUP_MEANS, sp.FULL.train,
                                    sp.TIMEPOINTS, 0.1,
                                    rng=np.random.default_rng(sp.DATA_SEED),
                                    device=dev)
        red = {k: v for k, v in SUPPRESSION_REDUCED.items()
               if k != "valid_inits"}
        scfg_sup = sup.SuppressionFitConfig(**{**red, **MESH_SWEEP_STEPS})

        def sweep(mesh=None):
            return sup.fit_suppression_sweep(
                sup.suppression_net(), data, sp.TIMEPOINTS, sp.LAMBDAS,
                scfg_sup, device=dev,
                generator=torch.Generator().manual_seed(SEED), mesh=mesh)
        out.sweep = pair("sweep", sweep, lambda: sweep(mesh_r))

        out.full = run("train full", MESH_SHARDS,
                       lambda: train(TrainConfig(), mesh_r))
        out.full_evals = evals[0]

        count = len(cards)
        out.cards = count
        if count > 1:
            out.cards_census = run(
                "census", count, lambda: pmesh.sharded_beta_profiles(
                    model, nn, all_cohort,
                    pmesh.make_mesh(("individuals",), devices=cards),
                    sigmas=np.concatenate([fit["sigma_train"],
                                           fit["sigma_test"]]),
                    lower=-10.0, upper=10.0, steps=MESH_CENSUS_STEPS,
                    center=np.concatenate([fit["beta_train"],
                                           fit["beta_test"]])))
            out.cards_cut = run("train cut", count, lambda: train(
                cut, pmesh.make_mesh(("restarts",), devices=cards)))
    finally:
        pmesh.sharded_population_vg = real_vg
    return out


def run_side(names: list[str], out: Path) -> None:
    """A child process: run ``names``, each with every kernel's count at 0
    before it, and write each one's failures, kernel launches, the kernels
    it must launch, its seconds and the time it ended to ``out`` (JSON) as
    it ends."""
    from conditional_ude_tpu_torch.__main__ import launches
    from conditional_ude_tpu_torch.ops import (
        lane_grad,
        population_grad,
        rk4_cohort,
        rk4_population,
        tsit5_cohort,
    )
    mods = (rk4_cohort, rk4_population, lane_grad, tsit5_cohort,
            population_grad)
    dev = torch.device("cuda", 0)
    card = card_line()
    paths = new_paths(dev)
    report = {}
    for name in names:
        for mod in mods:
            mod.launches = mod.launches_age = 0
        run, check, kernels = paths[name]
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        stages = (res.seconds if hasattr(res, "seconds")
                  else res.metrics["stage_seconds"])
        for stage, sec in stages.items():
            log(f"[time] {name} stage {stage}: {sec:.2f} s  [{card}]")
        log(f"[time] {name} path total: {wall:.2f} s  [{card}]")
        launched = launches()
        log(f"[path] kernel launches during {name}: {launched or 'none'}")
        report[name] = {"failures": check(res), "launches": launched,
                        "must_launch": sorted(kernels), "seconds": wall,
                        "ended": time.time()}
        if name.startswith("exp01 retrain"):
            report[name]["metrics"] = {
                k: res.metrics()[k] for k in ("objective_best",
                                              "train_mse_mean",
                                              "test_mse_mean")}
        out.write_text(json.dumps(report))


def _die_with_parent() -> None:
    """In a child: be killed when the process that started it ends."""
    import ctypes
    import signal
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)      # PR_SET_PDEATHSIG


def start_side() -> list:
    """Start one child process for each list of ``SIDE``; each writes its
    log and its report under ``build/``."""
    import atexit
    import os
    import signal
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    procs = []
    for i, names in enumerate(SIDE):
        out, logf = build / f"chip_smoke_side{i}.json", \
            build / f"chip_smoke_side{i}.log"
        out.unlink(missing_ok=True)
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--side",
             ";".join(names), "--side-out", str(out)],
            cwd=REPO, stdout=logf.open("w"), stderr=subprocess.STDOUT,
            preexec_fn=_die_with_parent, start_new_session=True)
        procs.append((proc, names, out, logf))
        log(f"[side] child {i} (pid {proc.pid}): {', '.join(names)}")

    def stop():
        # each child leads a process group of its own, with the processes
        # it starts (the replication runner's seeds)
        for proc, *_ in procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()

    atexit.register(stop)
    return procs


def finish_side(procs: list, t_start: float) -> None:
    """Wait for the children, print their logs, and fail on any failure:
    a child that did not end well, a path not run, a check that failed, a
    kernel launched that the path must not launch, or one it must launch
    that it did not."""
    import os
    import signal
    failures, retrains = [], []
    epoch_start = time.time() - (time.perf_counter() - t_start)
    for i, (proc, names, out, logf) in enumerate(procs):
        try:
            rc = proc.wait(timeout=max(1.0, SIDE_WAIT
                                       - (time.perf_counter() - t_start)))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            rc = proc.wait()
            failures.append(f"child {i} did not end in time")
        for line in logf.read_text().splitlines():
            log(line)
        report = json.loads(out.read_text()) if out.exists() else {}
        if rc != 0:
            failures.append(f"child {i} exited with {rc}")
        for name in names:
            got = report.get(name)
            if got is None:
                failures.append(f"{name} did not run to its end")
                continue
            failures += [f"{name}: {f}" for f in got["failures"]]
            ended = got["ended"] - epoch_start
            log(f"[side] {name} ended {ended:.1f} s from the start (the "
                f"children should end by {SIDE_WAIT - SIDE_MARGIN:.0f} s)")
            if set(got["launches"]) != set(got["must_launch"]):
                failures.append(f"{name} launched {got['launches'] or 'none'}"
                                f"; it must launch {got['must_launch']} (each"
                                " more than 0 times) and nothing else")
            if "metrics" in got:
                retrains.append(got["metrics"])
    failures += check_ude_retrain_median(retrains)
    if failures:
        raise AssertionError("paths beside the main one failed:\n  "
                             + "\n  ".join(failures))


def check_etl_path(res) -> list[str]:
    """The ETL path: exp00's outputs bit for bit and its metrics as
    committed; exp_parity with no β at a bound but where the golden fit
    sits at the reference's lower bound, each per-type SSE within
    ``ETL_SSE_RTOL`` and the refit's β mean within ``ETL_BETA_ATOL`` of the
    committed metrics, the solvers in agreement; section 3's statistics
    finite; each stage's launches exactly ``ETL_STAGE_KERNELS``'."""
    failures = []
    for stage, want in ETL_STAGE_KERNELS.items():
        log(f"[check] etl {stage}: launches {res.launched[stage] or 'none'}"
            f" (must be {want or 'none'})")
        if res.launched[stage] != want:
            failures.append(f"{stage} launched {res.launched[stage]}, must "
                            f"launch {want or 'nothing'}")
    for name in ("ohashi.npz", "fujita.npz"):
        with np.load(res.out / name) as got, np.load(ARTIFACTS / name) as w:
            differ = [k for k in w.files if k not in got.files
                      or got[k].dtype != w[k].dtype
                      or not np.array_equal(got[k], w[k])]
        log(f"[check] etl exp00 {name}: "
            f"{'bit for bit' if not differ else 'differs in ' + str(differ)}")
        if differ:
            failures.append(f"exp00's {name} differs in {differ}")
    committed = json.loads((REPO / "results" / "exp00_metrics.json")
                           .read_text())
    got = dict(res.exp00)
    p_got, p_want = (got.pop("age_mann_whitney_p"),
                     committed.pop("age_mann_whitney_p"))
    if got != committed:
        failures.append(f"exp00 metrics {got} != {committed}")
    failures += [f"exp00 p-value {k}: {p_got.get(k)} vs {v}"
                 for k, v in p_want.items()
                 if not math.isclose(p_got.get(k, math.nan), v,
                                     rel_tol=1e-12, abs_tol=0.0)]
    log(f"[check] etl exp00 p-values {p_got} (committed {p_want})")

    m, want = res.parity.metrics, json.loads(ETL_PARITY_METRICS.read_text())
    lb, ub = res.parity.bounds
    golden = np.load(ETL_PARITY)
    golden_lb = min(golden["betas_train"].min(), golden["betas_test"].min())
    for tag, fit in res.parity.fits.items():
        # the fits clamp to the bounds in float32
        at_lb = np.flatnonzero(fit["beta"] <= np.float32(lb)).tolist()
        at_ub = np.flatnonzero(fit["beta"] >= np.float32(ub)).tolist()
        flat = np.flatnonzero(golden[f"betas_{tag}"] <= golden_lb).tolist()
        log(f"[check] etl exp_parity {tag}: bounds ({lb:.6f}, {ub:.6f}), β "
            f"range ({fit['beta'].min():.6f}, {fit['beta'].max():.6f}); at "
            f"the lower bound {at_lb}, at the upper {at_ub}; the golden fit "
            f"at its own lower bound {flat}")
        # where the golden fit sits at the reference's lower bound the
        # likelihood falls toward β → −∞, and a wider bound moves there too
        if at_ub or not set(at_lb) <= set(flat):
            failures.append(f"exp_parity {tag}: β at the lower bound "
                            f"{at_lb}, the upper {at_ub}; only {flat} may "
                            "sit at the lower one")
    log(f"[check] etl exp_parity metrics {json.dumps(m)}")
    for key in ("sse_per_type_combined", "sse_per_type_train",
                "sse_per_type_test"):
        for t, v in want[key].items():
            if not abs(m[key].get(t, math.inf) / v - 1) <= ETL_SSE_RTOL:
                failures.append(f"exp_parity {key} {t}: {m[key].get(t)} vs "
                                f"{v} ± {ETL_SSE_RTOL:.0%}")
    if not abs(m["beta_mean_train_refit"]
               - want["beta_mean_train_refit"]) <= ETL_BETA_ATOL:
        failures.append(f"exp_parity beta_mean_train_refit "
                        f"{m['beta_mean_train_refit']} vs "
                        f"{want['beta_mean_train_refit']} ± {ETL_BETA_ATOL}")
    if m["solver_agreement_ok"] is not True:
        failures.append(f"exp_parity solvers apart by "
                        f"{m['solver_max_abs_delta']}")

    c = res.crosscheck
    log(f"[check] etl section 3: {json.dumps(c)}")
    numbers = [v for k, v in c.items() if k not in ("note", "n_files")]
    numbers = [x for v in numbers for x in (v if isinstance(v, list)
                                            else [v])]
    if c["n_files"] != ETL_RUNS or not np.isfinite(numbers).all():
        failures.append(f"section 3: {c['n_files']} runs, statistics "
                        f"{numbers}")
    return failures


def check_mesh_path(res) -> list[str]:
    """The mesh path: each stage's launches (exactly the kernels of
    ``MESH_STAGE_KERNELS``, the sharded run twice as often as the unsharded
    one; the full-depth training K1 and K3 once a shard and K2 once a shard
    an evaluation), the lanes-independent results bit for bit, the rest at
    the ``MESH_*`` tolerances, and the full-depth training's objective and
    routes."""
    failures = []
    card = card_line()
    for name, runs in res.stages.items():
        for shards, r in sorted(runs.items()):
            log(f"[time] mesh {name} x{shards}: {r['seconds']:.2f} s, "
                f"launches {r['launches'] or 'none'}  [{card}]")
        if name not in MESH_STAGE_KERNELS:
            continue
        plain = runs[1]["launches"]
        for shards, r in runs.items():
            if set(r["launches"]) != MESH_STAGE_KERNELS[name]:
                failures.append(f"mesh {name} x{shards} launched "
                                f"{r['launches']}")
            elif r["launches"] != {k: shards * v for k, v in plain.items()}:
                failures.append(f"mesh {name} x{shards} launched "
                                f"{r['launches']}, not {shards} x {plain}")
    want = {"census": 2 * MESH_CENSUS_STEPS // 1000,
            "test profile": MESH_PROFILE_STEPS // 500}
    for name, n in want.items():
        got = res.stages[name][1]["launches"].get("rk4_cohort")
        if got != n:
            failures.append(f"mesh {name} unsharded: K4 {got}, not {n}")
    cut_k2 = res.stages["train cut"][1]["launches"].get("lane_grad")
    log(f"[check] mesh training cut: {res.cut_evals} value+grad evaluations"
        f" sharded, K2 {cut_k2} launches unsharded")
    if cut_k2 != res.cut_evals:
        failures.append(f"mesh train cut: {res.cut_evals} evaluations, K2 "
                        f"{cut_k2} unsharded")
    saem_want = {"rk4_cohort": MESH_SAEM["iterations"]
                 * (MESH_SAEM["n_mcmc_steps"] + 1),
                 "lane_grad": MESH_SAEM["iterations"] * 5}
    if res.stages["saem"][1]["launches"] != saem_want:
        failures.append(f"mesh saem unsharded launched "
                        f"{res.stages['saem'][1]['launches']}, not "
                        f"{saem_want}")
    full = res.stages["train full"][MESH_SHARDS]["launches"]
    full_want = {"rk4_population": MESH_SHARDS, "tsit5_cohort": MESH_SHARDS,
                 "lane_grad": MESH_SHARDS * res.full_evals}
    log(f"[check] mesh training at full depth: {res.full_evals} value+grad "
        f"evaluations, launches {full} (want {full_want})")
    if full != full_want:
        failures.append(f"mesh train full launched {full}, not {full_want}")

    def exact(name, pairs):
        diffs = {k: float((a.double() - b.double()).abs().max())
                 if a.shape == b.shape else math.inf for k, (a, b) in
                 pairs.items()}
        same_ = all(torch.equal(a, b) for a, b in pairs.values())
        log(f"[check] mesh {name}: sharded {'equals' if same_ else 'differs from'}"
            f" unsharded bit for bit (largest differences {diffs})")
        return same_, diffs

    plain, sharded = res.cut
    same_cut, diffs = exact("train cut", {
        k: (getattr(plain, k), getattr(sharded, k))
        for k in ("screen_losses", "objectives", "nn_params", "betas",
                  "loss_traces")})
    if not torch.equal(sharded.screen_losses, plain.screen_losses):
        failures.append("mesh train cut: the sharded screen is not the "
                        "unsharded one bit for bit")
    if not same_cut and not torch.allclose(
            sharded.objectives, plain.objectives, rtol=MESH_TRAIN_RTOL,
            atol=0.0):
        failures.append(f"mesh train cut objectives {diffs}")
    if (sharded.timings["screen_path"], sharded.timings["refine_path"]) != (
            f"cuda_k1+mesh{MESH_SHARDS}", f"cuda_k2+mesh{MESH_SHARDS}"):
        failures.append(f"mesh routes {sharded.timings}")
    for name in ("census", "test_profile", "exp07_test_profile"):
        p0, p1 = getattr(res, name)
        if not exact(name, {"values": (p0.values, p1.values)})[0]:
            failures.append(f"mesh {name} not bit for bit")
    if getattr(res, "cards_census", None) is not None and not torch.equal(
            res.cards_census.values, res.census[0].values):
        failures.append(f"mesh census over {res.cards} cards not bit for "
                        "bit")
    if getattr(res, "cards_cut", None) is not None:
        cards_cut = res.cards_cut
        same_cards, diffs = exact(f"train cut over {res.cards} cards", {
            k: (getattr(plain, k), getattr(cards_cut, k))
            for k in ("screen_losses", "objectives")})
        if not torch.equal(cards_cut.screen_losses, plain.screen_losses):
            failures.append(f"mesh train cut over {res.cards} cards: the "
                            "screen is not the unsharded one bit for bit")
        if not same_cards and not torch.allclose(
                cards_cut.objectives, plain.objectives, rtol=MESH_TRAIN_RTOL,
                atol=0.0):
            failures.append(f"mesh train cut over {res.cards} cards "
                            f"objectives {diffs}")
    if not exact("refit", dict(zip(("beta", "sigma", "objective"),
                                   zip(*res.refit))))[0]:
        failures.append("mesh (β, σ) refit not bit for bit")
    s0, s1 = res.saem
    exact("saem", {"nll_trace": (s0.nll_trace, s1.nll_trace),
                   "theta": (s0.theta, s1.theta)})
    for key, atol in MESH_SAEM_ATOL.items():
        if not torch.allclose(getattr(s1, key), getattr(s0, key), rtol=0.0,
                              atol=atol):
            failures.append(f"mesh saem {key} beyond atol {atol}")
    w0, w1 = res.sweep
    exact("sweep", {"objectives": (w0.objectives, w1.objectives),
                    "thetas": (w0.thetas, w1.thetas)})
    if not torch.allclose(w1.objectives, w0.objectives, **MESH_SWEEP_TOL):
        failures.append("mesh sweep objectives beyond rtol 5e-2 + atol "
                        "1e-4")
    tr = res.full
    log(f"[check] mesh training at full depth: routes "
        f"{tr.timings['screen_path']}, {tr.timings['refine_path']}; stages "
        + ", ".join(f"{k} {tr.timings[k]:.2f} s" for k in
                    ("screen", "adam", "lbfgs", "final_eval")))
    failures += check_routes_and_objective(
        tr, f"cuda_k2+mesh{MESH_SHARDS}", MESH_OBJ_MAX,
        "exp02's retrain limit", f"cuda_k1+mesh{MESH_SHARDS}")
    return failures


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
    got = res.metrics()
    for split in ("train", "test"):
        key = f"{split}_sse_per_type"
        log(f"[check] {split} SSE per type {got[key]} (committed "
            f"{metrics[key]})")
        for kind, want in metrics[key].items():
            if abs(got[key][kind] / want - 1.0) > 0.03:
                failures.append(f"{split} SSE of {kind} {got[key][kind]}")
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
    return failures + check_exp02_outputs(res, metrics)


def within(got: float, want: float, tol: float, name: str) -> list[str]:
    """``got`` within a relative ``tol`` of ``want``, logged."""
    log(f"[check] {name} {got:.6g} (committed {want:.6g}, rel "
        f"{got / want - 1.0:+.2e}, limit {tol})")
    return [f"{name} {got}"] if abs(got / want - 1.0) > tol else []


def per_subject(got: np.ndarray, want: np.ndarray, tol: float,
                name: str) -> list[str]:
    """Every subject within a relative ``tol`` of the committed fit."""
    rel = np.abs(np.asarray(got) / np.asarray(want) - 1.0)
    i = int(np.argmax(rel))
    log(f"[check] {name}: max rel {rel[i]:.2e} (subject {i}), median "
        f"{np.median(rel):.2e} over {rel.size} subjects (limit {tol})")
    if not np.isfinite(got).all() or rel.max() > tol:
        return [f"{name} off the committed fit (subject {i}, {rel[i]:.3e})"]
    return []


def check_exp02_outputs(res, metrics: dict) -> list[str]:
    """exp02's sampled bands and UDE comparison against the committed
    metrics: each within 3 %, the fraction the cUDE fits better within one
    subject of 35."""
    failures = []
    if res.dose_response is None or res.dose_response.shape != (900, 3) \
            or not np.isfinite(res.dose_response).all():
        failures.append("no finite dose-response table")
    for t, band in metrics["sampled_simulation_bands"].items():
        for key, want in band.items():
            failures += within(res.bands[t][key], want, 0.03,
                               f"band {t} {key}")
    got, want = res.ude_vs_cude, metrics["ude_vs_cude"]
    for key in ("test_mse_ude_mean", "test_mse_cude_mean"):
        failures += within(got[key], want[key], 0.03, key)
    log(f"[check] cude_better_fraction {got['cude_better_fraction']:.4f} "
        f"(committed {want['cude_better_fraction']:.4f})")
    if abs(got["cude_better_fraction"] - want["cude_better_fraction"]) \
            > 1.0 / 35 + 1e-9:
        failures.append(f"cude_better_fraction {got['cude_better_fraction']}")
    return failures


def check_dose_response(table: np.ndarray) -> list[str]:
    """The dose-response table from the committed refit's training β's
    against ``artifacts/ohashi_production.csv``, row by row: β and ΔG
    exactly, the productions at rtol 1e-4 and atol ``CSV_ATOL``."""
    committed = np.genfromtxt(ARTIFACTS / "ohashi_production.csv",
                              delimiter=",", skip_header=1)
    err = np.abs(table[:, 2] - committed[:, 2])
    log(f"[check] dose-response table vs committed: {table.shape[0]} rows, "
        f"max abs err {err.max():.3e}, max rel "
        f"{(err / np.maximum(np.abs(committed[:, 2]), 1e-30)).max():.3e}")
    if table.shape != committed.shape \
            or not np.array_equal(table[:, :2], committed[:, :2]) \
            or (err > 1e-4 * np.abs(committed[:, 2]) + CSV_ATOL).any():
        return ["dose-response table off the committed one"]
    return []


def check_ude_frozen(res) -> list[str]:
    """exp01 on the committed network against ``results/exp01_metrics.json``:
    the objective as stored, the MSE means and each type's within 3 %."""
    want = json.loads((REPO / "results" / "exp01_metrics.json").read_text())
    got = res.metrics()
    failures = [] if got["objective_best"] == want["objective_best"] \
        else [f"objective {got['objective_best']}"]
    for key in ("train_mse_mean", "test_mse_mean"):
        failures += within(got[key], want[key], 0.03, f"exp01 {key}")
    for key in ("train_mse_per_type", "test_mse_per_type"):
        for t, w in want[key].items():
            failures += within(got[key][t], w, 0.03, f"exp01 {key} {t}")
    return failures


def check_ude_retrain(res) -> list[str]:
    """One exp01 retrain on the card: ten candidates best first, finite,
    and the best objective inside the spread of the JAX package's own
    ``train_ude`` (``UDE_OBJ_MAX``); its MSE means are held with the other
    draws' (``check_ude_retrain_median``)."""
    got = res.metrics()
    obj = got["objective_best"]
    log(f"[check] exp01 retrain: objective {obj:.4g} (limit {UDE_OBJ_MAX}), "
        f"train MSE mean {got['train_mse_mean']:.4f}, test MSE mean "
        f"{got['test_mse_mean']:.4f}; restarts' objectives "
        f"{np.array2string(res.objectives, precision=3)}")
    failures = []
    if tuple(res.nn_params.shape) != (10, 33) \
            or not np.isfinite(res.objectives).all() \
            or (np.diff(res.objectives) < 0).any():
        failures.append(f"candidates {tuple(res.nn_params.shape)}, "
                        f"objectives {res.objectives}")
    if not 0.0 <= obj <= UDE_OBJ_MAX:
        failures.append(f"objective {obj}")
    return failures


def check_ude_retrain_median(draws: list[dict]) -> list[str]:
    """The median over the exp01 retrains at ``UDE_SEEDS`` of the train and
    the test MSE means inside the JAX spread (``UDE_TRAIN_MSE``,
    ``UDE_TEST_MSE``)."""
    if len(draws) != len(UDE_SEEDS):
        return [f"{len(draws)} exp01 retrains of {len(UDE_SEEDS)}"]
    failures = []
    for key, (lo, hi) in (("train_mse_mean", UDE_TRAIN_MSE),
                          ("test_mse_mean", UDE_TEST_MSE)):
        values = sorted(d[key] for d in draws)
        med = float(np.median(values))
        log(f"[check] exp01 retrain {key} at seeds {UDE_SEEDS}: "
            f"{', '.join(f'{v:.4f}' for v in values)}; median {med:.4f} "
            f"(limits {lo}-{hi})")
        if not lo <= med <= hi:
            failures.append(f"exp01 retrain median {key} {med}")
    return failures


def check_seeds_path(res) -> list[str]:
    """exp02_seeds at ``SEEDS_RUN``: each seed within exp02's retrain
    limits (the JAX per-seed spread, ``check_retrain``), its record's
    objective too, with a UDE comparison; the merge of the two records has
    ``n_seeds`` 2, their seeds, and every ``beta_orientation`` 1.0 (the
    gauge the records carry already gives a negative first-phase ρ)."""
    failures = []
    for s, (r, record) in res.results.items():
        log(f"[check] exp02_seeds seed {s}: objective_best "
            f"{record['objective_best']:.4f} (limit 0.30), test SSE mean "
            f"{record['test_sse_mean']:.4f}, median "
            f"{record['test_sse_median']:.4f}, spearman "
            f"{record['spearman']}, best {record['best_model_index']}, "
            f"train_seconds {record['train_seconds']:.2f}, ude_vs_cude "
            f"{record['ude_vs_cude']}")
        failures += [f"seed {s}: {f}" for f in check_trained(
            r, 0.30, (0.41, 0.64), -0.77, "JAX per-seed 0.178-0.272")]
        if not record["objective_best"] <= 0.30:
            failures.append(f"seed {s}: objective_best "
                            f"{record['objective_best']}")
        if record["ude_vs_cude"] is None:
            failures.append(f"seed {s}: no UDE comparison")
    summary = res.summary
    log(f"[check] exp02_seeds merge: n_seeds {summary['n_seeds']}, seeds "
        f"{summary['seeds']}, beta_orientations "
        f"{summary['beta_orientations']}; test SSE mean "
        f"{summary['test_sse_mean']}; spearman first phase "
        f"{summary['spearman.first_phase']}")
    if (summary["n_seeds"], summary["seeds"], summary["beta_orientations"]) \
            != (len(SEEDS_RUN), list(SEEDS_RUN), [1.0] * len(SEEDS_RUN)):
        failures.append(f"merge {summary['n_seeds']} seeds "
                        f"{summary['seeds']}, orientations "
                        f"{summary['beta_orientations']}")
    return failures


def check_ablation_path(res) -> list[str]:
    """exp05's rows at ``ABLATION_LIMITS``' fractions: the cohort's size,
    a restart among the 10 (restart 0 at 1.0, which holds nothing out), a
    finite training objective, every test subject's SSE finite, and the
    test-SSE median inside the committed five-seed range widened by 10 %."""
    failures = []
    if [r["fraction"] for r in res.rows] != list(ABLATION_LIMITS):
        failures.append(f"fractions {[r['fraction'] for r in res.rows]}")
    for r in res.rows:
        n, lo, hi = ABLATION_LIMITS[r["fraction"]]
        log(f"[check] exp05 fraction {r['fraction']}: n_train {r['n_train']}"
            f" (want {n}), selected restart {r['selected_restart']}, train "
            f"objective {r['train_objective']:.4f}, test SSE median "
            f"{r['test_sse_median']:.4f} (limits {lo}-{hi}), mean "
            f"{r['test_sse_mean']:.4f}, inlier mean "
            f"{r['test_sse_mean_inliers']:.4f}, outliers {r['n_outliers']}, "
            f"non-finite {r['n_nonfinite']}, {r['seconds']} s")
        if r["n_train"] != n:
            failures.append(f"fraction {r['fraction']}: n_train "
                            f"{r['n_train']}")
        if not 0 <= r["selected_restart"] < ABLATION_RESTARTS or (
                r["fraction"] == 1.0 and r["selected_restart"] != 0):
            failures.append(f"fraction {r['fraction']}: selected restart "
                            f"{r['selected_restart']}")
        if not np.isfinite(r["train_objective"]) or r["n_nonfinite"]:
            failures.append(f"fraction {r['fraction']}: train objective "
                            f"{r['train_objective']}, {r['n_nonfinite']} "
                            "non-finite test SSEs")
        if not lo <= r["test_sse_median"] <= hi:
            failures.append(f"fraction {r['fraction']}: test SSE median "
                            f"{r['test_sse_median']}")
    if res.metrics["n_seeds"] != 1:
        failures.append(f"aggregate of {res.metrics['n_seeds']} seeds")
    return failures


def check_replicate_path(res) -> list[str]:
    """The replication runner over exp01 (frozen): both seeds' metrics, and
    their aggregate's train and test MSE means (min and max) within 3 % of
    ``results/exp01_metrics.json``."""
    rep = res.result
    want = json.loads((REPO / "results" / "exp01_metrics.json").read_text())
    failures = []
    if (rep["script"], rep["seeds"], sorted(rep["per_seed"])) != (
            "exp01", list(REPLICATE_SEEDS), sorted(map(str, REPLICATE_SEEDS))):
        failures.append(f"replicate {rep['script']} seeds {rep['seeds']}")
    for key in ("train_mse_mean", "test_mse_mean"):
        agg = rep["aggregate"].get(key)
        log(f"[check] replicate exp01 {key}: {agg}")
        if agg is None:
            failures.append(f"replicate exp01: no aggregate of {key}")
            continue
        for stat in ("min", "max"):
            failures += within(agg[stat], want[key], 0.03,
                               f"replicate exp01 {key} {stat}")
    return failures


def widen(lo: float, hi: float) -> tuple[float, float]:
    """A range of a JAX spread widened by half its width on each side.
    Over 31 runs this puts a 32nd draw of a normal metric outside with
    odds near 6e-4, where a tenth of the width gives 3 % a metric: too many
    false failures over the ~60 metrics held."""
    pad = 0.5 * (hi - lo)
    return lo - pad, hi + pad


def check_saem_spread(metrics: dict, name: str,
                      spread: dict | None = None) -> list[str]:
    """Each metric of ``spread`` (default ``SAEM_SPREAD[name]``) inside
    that JAX spread, widened."""
    from conditional_ude_tpu_torch.replicate import flatten
    got, failures = flatten(metrics), []
    spread = SAEM_SPREAD[name] if spread is None else spread
    for key, (lo, hi) in spread.items():
        lo, hi = widen(lo, hi)
        value = got.get(key, float("nan"))
        log(f"[check] {name} {key} {value:.6g} (JAX on the CPU over its "
            f"keys, widened: {lo:.6g} to {hi:.6g})")
        if not lo <= value <= hi:
            failures.append(f"{name} {key} {value}")
    return failures


def check_saem_path(res) -> list[str]:
    """exp06 on the card: the likelihood on K4 and the population gradient
    on K2, one K4 launch an MCMC step (its proposals and states together)
    and one an iteration, one a chain step and one to start the chains, one
    K2 launch an Adam step, in both Ω modes; the metrics inside the JAX
    spread; the fit finite; and the MAPs and MLEs from the committed fit's
    fixed effects within twice JAX's own miss of its ``beta_map`` and
    ``beta_mle`` (``SAEM_MISS``; the flat subject's MLE on its own)."""
    run, failures = res.run, []
    if run.route != "cuda_k4_k2":
        failures.append(f"route {run.route}")
    k4 = 2 * (180 * (25 + 1) + 3000 + 1)
    k2 = 2 * 180 * 5
    log(f"[check] exp06 launches: K4 {res.launches['K4']} (expected {k4}), "
        f"K2 {res.launches['K2']} (expected {k2})")
    if (res.launches["K4"], res.launches["K2"]) != (k4, k2):
        failures.append(f"launches {res.launches}")
    failures += check_saem_spread(res.metrics, "exp06")
    for k, v in run.fit.items():
        if not np.isfinite(v).all():
            failures.append(f"saem_fit {k} not finite")
    if run.fit["nll_trace"].shape != (180,):
        failures.append(f"nll_trace {run.fit['nll_trace'].shape}")
    for name, got in (("beta_map", res.maps), ("beta_mle", res.mles)):
        diff = np.abs(got - res.fit[name])
        stats = {"median": np.median(diff), "max": diff.max()}
        limits = {k: 2 * v for k, v in SAEM_MISS[name].items()}
        if name == "beta_mle":
            flat = f"subject {SAEM_FLAT_SUBJECT}"
            stats["max"] = np.delete(diff, SAEM_FLAT_SUBJECT).max()
            stats[flat] = diff[SAEM_FLAT_SUBJECT]
            limits[flat] = 2 * SAEM_FLAT_MISS
        for stat, value in stats.items():
            log(f"[check] exp06 {name} from the committed fit's fixed "
                f"effects: {stat} |diff| {value:.3e} (limit "
                f"{limits[stat]:.3e}, twice JAX's own miss)")
            if not value <= limits[stat]:
                failures.append(f"{name} off the committed fit: {stat} "
                                f"{value}")
    return failures


def check_saem_retrain(res) -> list[str]:
    """exp06 with its pre-train retrained at seed 11: the metrics of
    ``SAEM_SPREAD["exp06"]`` inside the spread of JAX's runs from that same
    pre-train (``SAEM_RETRAIN_SPREAD``), widened; the five-seed range of
    ``results/replicate_exp06_saem.json`` (other pre-trains) is printed
    beside them and holds nothing."""
    agg = json.loads((REPO / "results" / "replicate_exp06_saem.json")
                     .read_text())["aggregate"]
    for key in sorted(set(agg) & set(SAEM_RETRAIN_SPREAD)):
        log(f"[report] exp06 retrain, seed 11 {key}: the committed five "
            f"seeds {agg[key]['min']:.6g} to {agg[key]['max']:.6g}")
    failures = ([] if res.run.route == "cuda_k4_k2"
                else [f"route {res.run.route}"])
    return failures + check_saem_spread(res.metrics, "exp06 retrain, seed 11",
                                        SAEM_RETRAIN_SPREAD)


def check_advi_path(res) -> list[str]:
    """exp_advi on the card: the launches (K2 one a step of each stage, K4
    one a profile chunk, exactly); the reduced run on the card against the
    same on the CPU, array by array; the written posteriors finite; and
    each metric, and each test subject's β mean and sd, inside the JAX
    spread widened (the committed TPU values printed beside them as a
    report)."""
    failures = []
    k2, k4 = ADVI_JOINT_STEPS + ADVI_TEST_STEPS, ADVI_PROFILE_CHUNKS
    log(f"[check] exp_advi launches: K2 {res.launches['K2']} (expected {k2}),"
        f" K4 {res.launches['K4']} (expected {k4})")
    if (res.launches["K2"], res.launches["K4"]) != (k2, k4):
        failures.append(f"launches {res.launches}")

    card, cpu = res.reduced["card"], res.reduced["cpu"]
    for stage in ("joint", "test"):
        for k, want in getattr(cpu, stage).items():
            got = getattr(card, stage)[k]
            err = np.abs(got - want)
            worst = float(np.max(err / (ADVI_SAME_ATOL
                                        + ADVI_SAME_RTOL * np.abs(want))))
            log(f"[check] exp_advi reduced, card against CPU, {stage} {k}: "
                f"max abs diff {float(err.max()):.3e}, {worst:.3f} of the "
                f"limit (rtol {ADVI_SAME_RTOL}, atol {ADVI_SAME_ATOL})")
            if not worst <= 1.0:
                failures.append(f"reduced {stage} {k}: {worst} of the limit")
    for k, want in cpu.metrics.items():
        if k in ("stage_seconds", "n_restarts"):
            continue
        got = card.metrics[k]
        log(f"[check] exp_advi reduced {k}: card {got!r}, CPU {want!r}")
        if not np.isclose(got, want, rtol=ADVI_SAME_RTOL, atol=0.0):
            failures.append(f"reduced {k}: card {got}, CPU {want}")

    for name, arrays in (("advi_cude_results", res.joint),
                         ("advi_test_posteriors", res.test)):
        failures += [f"{name}.npz {k} not finite" for k, v in arrays.items()
                     if not np.isfinite(v).all()]

    committed = json.loads((REPO / "results" / "exp_advi_metrics.json")
                           .read_text())
    for key, (lo, hi) in ADVI_SPREAD.items():
        lo, hi = widen(lo, hi)
        value = res.metrics.get(key)
        value = float("nan") if value is None else value
        log(f"[check] exp_advi {key} {value:.6g} (JAX on the CPU over its "
            f"keys, widened: {lo:.6g} to {hi:.6g}; the committed TPU run "
            f"{committed[key]:.6g})")
        if not lo <= value <= hi:
            failures.append(f"exp_advi {key} {value}")
    tpu = np.load(ARTIFACTS / "advi_test_posteriors.npz")
    for key, (lo, hi) in ADVI_SUBJECT_SPREAD.items():
        lo, hi = widen(np.asarray(lo), np.asarray(hi))
        got = res.test[key]
        outside = np.flatnonzero(~((lo <= got) & (got <= hi)))
        margin = np.minimum(got - lo, hi - got) / (hi - lo)
        log(f"[check] exp_advi test {key}: {35 - outside.size} of 35 "
            "subjects inside JAX's per-subject spread widened (least margin "
            f"{float(margin.min()):.3f} of the widened width, subject "
            f"{int(np.argmin(margin))}); max |diff| from the committed TPU "
            f"run {float(np.abs(got - tpu[key]).max()):.4g}")
        failures += [f"exp_advi test {key} subject {i}: {got[i]:.6g} outside "
                     f"{lo[i]:.6g} to {hi[i]:.6g}" for i in outside]
    return failures


def check_suppression_path(res) -> list[str]:
    """exp_suppression on the card: (i) the committed artifacts' objectives
    and true p4; (ii) ``--test-only`` at ``SUPPRESSION_TEST_LBFGS`` L-BFGS
    steps against JAX-CPU's at the same cut; (iii) each λ's
    reduced-retrain metrics inside JAX-CPU's spread over keys, widened.
    That no kernel launched is the caller's check."""
    failures = []
    for lam, (loss, want, gt_exact) in res.artifacts.items():
        miss = float(np.max(np.abs(loss / want - 1)))
        limit = max(1e-4, 2 * SUPPRESSION_ARTIFACT_MISS[lam])
        log(f"[check] exp_suppression artifact λ={lam}: objectives' largest "
            f"relative miss {miss:.3e} (limit {limit:.3e}), true p4 "
            f"{'exact' if gt_exact else 'DIFFERS'}")
        if not (miss <= limit and gt_exact):
            failures.append(f"artifact λ={lam}: miss {miss}, p4 {gt_exact}")

    # (ii) at SUPPRESSION_TEST_LBFGS steps, against JAX-CPU at the same cut
    ts, want = res.test_only.get("test_stage", {}), SUPPRESSION_CUT
    for key in ("selected_restart", "best_valid_rho_restart"):
        log(f"[check] exp_suppression --test-only at {SUPPRESSION_TEST_LBFGS}"
            f" L-BFGS steps, {key}: {ts.get(key)} (JAX-CPU {want.get(key)})")
        if ts.get(key) != want.get(key):
            failures.append(f"--test-only {key} {ts.get(key)}")
    for key in ("spearman", "spearman_best_valid_rho_restart"):
        got, ref = ts.get(key, float("nan")), want.get(key, float("nan"))
        log(f"[check] exp_suppression --test-only {key}: {got:.6g} (JAX-CPU "
            f"{ref:.6g} ± {SUPPRESSION_RHO_TOL}; at full depth the "
            f"committed {SUPPRESSION_TEST_STAGE[key]:.6g})")
        if not abs(got - ref) <= SUPPRESSION_RHO_TOL:
            failures.append(f"--test-only {key} {got}")
    loss = np.asarray([r["loss_valid"] for r in res.revalidated])
    rho = np.asarray([r["correlation_valid"] for r in res.revalidated])
    if loss.shape != (25,):
        failures.append(f"--test-only revalidated {loss.shape} restarts")
    else:
        loss_miss = np.abs(loss / want["loss_valid"] - 1)
        rho_miss = np.abs(rho - want["correlation_valid"])
        for r in SUPPRESSION_CUT_UNDETERMINED:
            log(f"[check] exp_suppression --test-only, restart {r} (not "
                f"determined at the cut, a report): loss_valid "
                f"{loss[r]:.6g} against JAX-CPU's {want['loss_valid'][r]:.6g}"
                f", correlation_valid {rho[r]:.4f} against "
                f"{want['correlation_valid'][r]:.4f}")
        held = np.setdiff1d(np.arange(25), SUPPRESSION_CUT_UNDETERMINED)
        loss_miss, rho_miss = loss_miss[held], rho_miss[held]
        log(f"[check] exp_suppression --test-only, the other 22 restarts "
            f"revalidated: loss_valid's largest relative miss of JAX-CPU's "
            f"{loss_miss.max():.3e} (restart {int(held[loss_miss.argmax()])}"
            f"; limit {SUPPRESSION_CUT_RTOL}), correlation_valid's "
            f"{rho_miss.max():.4f} (restart {int(held[rho_miss.argmax()])}; "
            f"limit {SUPPRESSION_RHO_TOL})")
        loss_miss, rho_miss = float(loss_miss.max()), float(rho_miss.max())
        if not (loss_miss <= SUPPRESSION_CUT_RTOL
                and rho_miss <= SUPPRESSION_RHO_TOL):
            failures.append(f"--test-only revalidation: loss {loss_miss}, "
                            f"ρ {rho_miss}")

    return failures + check_suppression_spread(res.retrain.rows)


def check_symreg_search_path(run) -> list[str]:
    """exp_symreg_search on the card: the reference equation's holdout MSE
    as committed; each GP run's best loss, front size and best holdout MSE
    inside ``SYMREG_SPREAD`` of its depth, widened."""
    failures = []
    ref = run.metrics["holdout"]["reference_equation_mse"]
    log(f"[check] exp_symreg_search reference equation holdout MSE {ref!r} "
        f"(committed {SYMREG_REFERENCE_MSE})")
    if abs(ref - SYMREG_REFERENCE_MSE) > SYMREG_REFERENCE_RTOL \
            * SYMREG_REFERENCE_MSE:
        failures.append(f"exp_symreg_search reference equation MSE {ref} "
                        f"!= {SYMREG_REFERENCE_MSE}")
    for r in run.runs:
        front = r["front"]
        got = {"best_loss": front[-1]["loss"] if front else math.inf,
               "pareto_size": len(front),
               "best_holdout_mse": min((f["holdout_mse"] for f in front),
                                       default=math.inf)}
        best = min(front, key=lambda f: f["holdout_mse"]) if front else None
        log(f"[check] exp_symreg_search depth {r['depth']} (key {r['key']}): "
            f"{got}; best holdout {best and best['equation']}")
        spread = SYMREG_SPREAD.get(r["depth"])
        if not spread:
            failures.append(f"no JAX spread for depth {r['depth']}")
            continue
        for key, (lo, hi) in spread.items():
            wlo, whi = widen(lo, hi)
            log(f"[check] exp_symreg_search depth {r['depth']} {key} "
                f"{got[key]!r} in [{wlo:.6g}, {whi:.6g}] (JAX-CPU over 16 "
                f"keys [{lo:.6g}, {hi:.6g}], widened)")
            if not wlo <= got[key] <= whi:
                failures.append(f"exp_symreg_search depth {r['depth']} {key}"
                                f" {got[key]} outside [{wlo}, {whi}]")
    log(f"[check] exp_symreg_search metrics: "
        f"{json.dumps({k: v for k, v in run.metrics.items() if k != 'seeds'})}")
    return failures


def close(got, want, what: str, rtol: float, atol: float) -> list[str]:
    """``got`` within ``atol + rtol·|want|`` of ``want`` everywhere, NaN
    where it is NaN, logged."""
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    if got.shape != want.shape:
        return [f"{what}: shape {got.shape}, want {want.shape}"]
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        return [f"{what}: NaN (an open CI side) where JAX has none, or not"]
    fin = ~np.isnan(want)
    err = np.abs(got - want)[fin]
    worst = float(np.max(err - rtol * np.abs(want[fin]))) if err.size else 0.0
    log(f"[check] {what}: largest |diff| {float(np.max(err, initial=0)):.3e}"
        f" (limit {atol:g} + {rtol:g}·|JAX|)")
    return [] if worst <= atol else [f"{what}: off by {worst:.3e} beyond "
                                     f"rtol {rtol:g}"]


def check_medians(types, got_err, want_err, got_idx, want_idx,
                  what: str) -> list[str]:
    """Each type's median subject: equal to JAX's where JAX's margin to its
    next candidate exceeds the port's miss of the distances to the median;
    else one JAX could pick within that miss (an even count has two
    equidistant middle subjects)."""
    failures = []
    present = [t for t in ("NGT", "IGT", "T2DM") if (types == t).any()]
    if not len(got_idx) == len(want_idx) == len(present):
        return [f"{what}: {len(got_idx)} median subjects"]
    for t, gi, wi in zip(present, got_idx, want_idx):
        sel = np.flatnonzero(types == t)
        dw = np.abs(want_err[sel] - np.median(want_err[sel]))
        dg = np.abs(got_err[sel] - np.median(got_err[sel]))
        miss = float(np.max(np.abs(dg - dw)))
        srt = np.sort(dw)
        margin = float(srt[1] - srt[0])
        log(f"[check] {what} {t}: subject {gi} (JAX {wi}), JAX's margin "
            f"{margin:.3e}, the port's miss {miss:.3e}")
        if margin > miss and gi != wi:
            failures.append(f"{what} {t}: subject {gi}, JAX {wi}")
        elif margin <= miss and not (
                dw[np.flatnonzero(sel == gi)[0]] <= srt[0] + 2 * miss):
            failures.append(f"{what} {t}: subject {gi} is no candidate")
    return failures


def check_ci(got: dict, want: dict, what: str) -> list[str]:
    """CI bounds (Δβ) within two grid steps, open on the same sides, and
    the trajectories at the bounds."""
    failures = []
    for key in ("lower", "upper"):
        a, b = np.asarray(got[key]), np.asarray(want[key], np.float64)
        if not np.array_equal(np.isfinite(a), np.isfinite(b)):
            failures.append(f"{what} {key}: open sides {a}, JAX {b}")
            continue
        fin = np.isfinite(b)
        miss = float(np.max(np.abs(a[fin] - b[fin]), initial=0.0))
        log(f"[check] {what} CI {key}: {a}, JAX {b} (|diff| {miss:.2e}, "
            f"limit {FIGURES_CI_TOL:g})")
        if miss > FIGURES_CI_TOL:
            failures.append(f"{what} CI {key} off by {miss:.2e}")
    return failures + close(got["sims"], want["sims"],
                            f"{what} trajectories at the CI bounds",
                            **FIGURES_CI_SIMS)


def check_figures_path(res) -> list[str]:
    """exp_figures on the card against ``scripts/figures_reference.json``:
    the trace names K4; K4 and K4c launched ``FIGURES_LAUNCHES`` times each
    (``run_side`` holds every other body at 0); every section computed;
    the median subjects and their CI-bound trajectories, the dose-response
    curves, the runner-up and type-mean refits, the trajectories and bands
    of every section and the p-values at the limits of ``FIGURES_*``."""
    from conditional_ude_tpu_torch.figures_pipeline import SECTIONS
    ref = figures_reference()
    a = res.run.arrays
    log(f"[check] exp_figures trace kernels: {res.trace_kernels}")
    failures = []
    if not any("rk4_cohort_sse_kernel" in k for k in res.trace_kernels):
        failures.append("the device trace does not name K4")
    for kid, n in res.launches.items():
        log(f"[check] exp_figures {kid} launches {n} (want "
            f"{FIGURES_LAUNCHES})")
        if n != FIGURES_LAUNCHES:
            failures.append(f"exp_figures launched {kid} {n} times")
    if set(a) != set(SECTIONS):
        return failures + [f"sections computed: {sorted(a)}"]
    log(f"[check] exp_figures rendered {res.run.manifest['count']} figures "
        f"(matplotlib {'present' if res.run.rendered else 'absent'})")
    for (x, y), p in a["data"]["pvalues"].items():
        failures += close(p, ref["data"][f"{x}-{y}"], f"p-value {x}-{y}",
                          1e-12, 0.0)
    c, rc = a["cude"], ref["cude"]
    if c["best"] != FIGURES_BEST["exp02"] or c["second"] != rc["second"]:
        failures.append(f"cude best {c['best']}, second {c['second']}")
    for split in ("train", "test"):
        failures += check_medians(
            c[f"types_{split}"], c[f"err_{split}"],
            np.asarray(rc[f"err_{split}"]), c[f"idx_med_{split}"],
            rc[f"idx_med_{split}"], f"cude {split} median")
    failures += check_ci(c["ci"], rc["ci"], "cude")
    failures += close(c["sims_test"], rc["sims_test"], "cude test fits",
                      **FIGURES_TRAJ)
    failures += close(c["nn_curves"], rc["nn_curves"],
                      "cude dose-response curves", **FIGURES_CURVES)
    for what, got, want in (
            ("runner-up refit", c["b2_all"], rc["b2_all"]),
            ("type-mean refit", c["comparison"]["b_mean"], rc["b_mean"])):
        failures += close(got, want, what, 0.0, FIGURES_BETA_TOL)
    failures += close(c["rho2"], rc["rho2"], "runner-up Spearman", 0.0,
                      FIGURES_RHO_TOL)
    for key in ("sims_cude", "sims_ude"):
        failures += close(c["comparison"][key], rc[key], f"type-mean {key}",
                          **FIGURES_CI_SIMS if key == "sims_cude"
                          else FIGURES_TRAJ)
    v, rv = a["covariate"], ref["covariate"]
    if list(v["idx_med_test"]) != rv["idx_med_test"]:
        failures.append(f"covariate medians {v['idx_med_test']}")
    failures += check_ci(v["ci"], rv["ci"], "covariate")
    failures += close(a["ude"]["sims"], ref["ude"]["sims"], "UDE fits",
                      **FIGURES_TRAJ)
    s, rs = a["symbolic"], ref["symbolic"]
    failures += close(s["sims"], rs["sims"], "symbolic fits", **FIGURES_TRAJ)
    failures += check_medians(s["types_all"], s["err"], np.asarray(rs["err"]),
                              s["idx_med"], rs["idx_med"], "symbolic median")
    for key in ("nn_curves", "sym_curves", "disc_curves"):
        failures += close(s[key], rs[key], f"symbolic {key}",
                          **FIGURES_CURVES)
    failures += close(a["external"]["sims"], ref["external"]["sims"],
                      "external fits", **FIGURES_TRAJ)
    u, ru = a["suppression"], ref["suppression"]
    if u["restart"] != ru["restart"] or list(u["idx"]) != ru["idx"]:
        failures.append(f"suppression restart {u['restart']}, subjects "
                        f"{u['idx']}")
    failures += close(u["ys"], ru["ys"], "suppression trajectories",
                      **FIGURES_TRAJ)
    for t, w in ref["saem"].items():
        b = a["saem"]["bands"][t]
        if b["subject"] != w["subject"]:
            failures.append(f"SAEM {t} subject {b['subject']}")
        for key in ("p05", "p95", "median"):
            failures += close(b[key], w[key], f"SAEM {t} band {key}",
                              **FIGURES_TRAJ)
    return failures


def check_exports(res, covariate: bool, out: Path) -> list[str]:
    """The fit export the entry point writes with ``--out`` (``fit_export``
    into ``out``): the committed file's keys and shapes, the run's own
    arrays, the selected candidate."""
    from conditional_ude_tpu_torch.pipeline import fit_export
    from conditional_ude_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    name, arrays, meta = fit_export(res, covariate)
    save_checkpoint(out / name, arrays, metadata=meta)
    got, got_meta = load_checkpoint(out / name)
    want = np.load(ARTIFACTS / name)
    exp = "exp07" if covariate else "exp02"
    failures = []
    if set(got) != set(want.files):
        failures.append(f"{name} keys {sorted(got)}")
    for key in want.files:
        if key in got and got[key].shape != want[key].shape:
            failures.append(f"{name} {key} shape {got[key].shape}")
        elif key in got and not np.array_equal(got[key], arrays[key]):
            failures.append(f"{name} {key} is not the run's own")
    if got_meta["best_model_index"] != FIGURES_BEST[exp]:
        failures.append(f"{name} best {got_meta['best_model_index']}")
    log(f"[check] {exp} export {name}: keys {sorted(got)}, best "
        f"{got_meta['best_model_index']}, bounds {got_meta['bounds']}")
    return failures


def check_suppression_spread(rows: list[dict]) -> list[str]:
    """Each λ's best train and validation ρ and best objective of a reduced
    retrain's ``rows`` inside ``SUPPRESSION_SPREAD``, widened."""
    failures = []
    for lam, spread in SUPPRESSION_SPREAD.items():
        lam_rows = [r for r in rows if r["lambda"] == float(lam)]
        got = {"best_correlation_train": max(r["correlation_train"]
                                             for r in lam_rows),
               "best_correlation_valid": max(r["correlation_valid"]
                                             for r in lam_rows),
               "best_objective": min(r["loss_train"] for r in lam_rows)}
        for key, (lo, hi) in spread.items():
            lo, hi = widen(lo, hi)
            log(f"[check] exp_suppression reduced retrain λ={lam} {key} "
                f"{got[key]:.6g} (JAX on the CPU over its keys, widened: "
                f"{lo:.6g} to {hi:.6g})")
            if not lo <= got[key] <= hi:
                failures.append(f"reduced retrain λ={lam} {key} {got[key]}")
    if not SUPPRESSION_SPREAD:
        failures.append("no JAX spread for the reduced retrain")
    return failures


def committed_sse(fit: dict, sigmas: str, objectives: str,
                  n_t: int) -> np.ndarray:
    s = fit[sigmas]
    return (fit[objectives] - (n_t / 2) * np.log(s**2)) * (2 * s**2)


def check_spearman(got: dict, want: dict, name: str) -> list[str]:
    failures = []
    for key, w in want.items():
        log(f"[check] {name} spearman {key} {got[key]:.4f} (committed "
            f"{w:.4f})")
        if abs(got[key] - w) > 0.01:
            failures.append(f"{name} spearman {key} {got[key]}")
    return failures


def check_exp03(res) -> list[str]:
    """exp03 against ``symreg_fit.npz`` and ``results/exp03_metrics.json``:
    each subject's k and σ within 2 %, the Spearmans within 0.01, the SSE
    mean and each type's within 3 %, the census within 1 a class."""
    fit = np.load(ARTIFACTS / "symreg_fit.npz")
    want = json.loads((REPO / "results" / "exp03_metrics.json").read_text())
    got = res.metrics
    failures = per_subject(res.fits["ks"], fit["ks"], 0.02, "exp03 k")
    failures += per_subject(res.fits["sigmas"], fit["sigmas"], 0.02,
                            "exp03 sigma")
    failures += check_spearman(got["spearman"], want["spearman"], "exp03")
    sse = committed_sse(res.fits, "sigmas", "objectives", 5)
    failures += within(float(sse.mean()), float(committed_sse(
        fit, "sigmas", "objectives", 5).mean()), 0.03, "exp03 SSE mean")
    for t, w in want["sse_per_type"].items():
        failures += within(got["sse_per_type"][t], w, 0.03,
                           f"exp03 SSE of {t}")
    return failures + check_census(got["identifiability_census"],
                                   want["identifiability_census"], "exp03")


def check_exp04(res) -> list[str]:
    """exp04 against ``symreg_external_fit.npz`` and
    ``results/exp04_metrics.json``: each subject's k and σ within 2 %, the
    MSE mean within 3 %, the same three quantile subjects with k and their
    interval bounds within 2 %, every objective finite; and the figure's
    CI-bound trajectories (``model_fit_external_quantiles.png``): finite on
    the 2-minute grid at k and at each finite bound, none where it is
    open."""
    fit = np.load(ARTIFACTS / "symreg_external_fit.npz")
    want = json.loads((REPO / "results" / "exp04_metrics.json").read_text())
    got = res.metrics
    failures = per_subject(res.fits["ks"], fit["ks"], 0.02, "exp04 k")
    failures += per_subject(res.fits["sigmas"], fit["sigmas"], 0.02,
                            "exp04 sigma")
    failures += within(got["mse_mean"], want["mse_mean"], 0.03,
                       "exp04 MSE mean")
    for q, w in want["profile_ci_quantile_subjects"].items():
        g = got["profile_ci_quantile_subjects"][q]
        log(f"[check] exp04 quantile {q}: subject {g['subject']} (committed "
            f"{w['subject']})")
        if g["subject"] != w["subject"]:
            failures.append(f"exp04 quantile {q} subject {g['subject']}")
            continue
        for key in ("k", "ci_lower", "ci_upper"):
            failures += within(g[key], w[key], 0.02, f"exp04 q{q} {key}")
        panel = res.figure["panels"][q]
        for key, bound in (("fit", g["k"]), ("lower", g["ci_lower"]),
                           ("upper", g["ci_upper"])):
            curve = panel[key]
            if (curve is None) == bool(np.isfinite(bound)) or (
                    curve is not None and not (
                        curve.shape == res.figure["dense_t"].shape
                        and np.isfinite(curve).all())):
                failures.append(f"exp04 q{q} {key} trajectory at {bound}")
    if not got["all_finite"]:
        failures.append("exp04 objectives not all finite")
    return failures


def check_symreg_production(res) -> list[str]:
    """exp_symreg_production against ``discovered_fit.npz`` and its
    committed metrics: each subject's b and σ (Ohashi and Fujita) within
    2 %, the Spearmans within 0.01, the MSE of each type and Fujita's MSE
    mean within 3 %, the census within 1 a class."""
    fit = np.load(ARTIFACTS / "discovered_fit.npz")
    want = json.loads((REPO / "results"
                       / "exp_symreg_production_metrics.json").read_text())
    got = res.metrics
    failures = []
    for key in ("bs", "sigmas", "bs_fujita", "sigmas_fujita"):
        failures += per_subject(res.fits[key], fit[key], 0.02,
                                f"symreg_production {key}")
    failures += check_spearman(got["spearman"], want["spearman"],
                               "symreg_production")
    for t, w in want["mse_per_type"].items():
        failures += within(got["mse_per_type"][t], w, 0.03,
                           f"symreg_production MSE of {t}")
    failures += within(got["fujita_external"]["mse_mean"],
                       want["fujita_external"]["mse_mean"], 0.03,
                       "symreg_production Fujita MSE mean")
    return failures + check_census(got["identifiability_census"],
                                   want["identifiability_census"],
                                   "symreg_production")


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
    widened by 10 %, Spearman -0.813 to -0.824; and exp02's outputs made,
    finite, on the port's own candidates."""
    failures = check_trained(res, 0.30, (0.41, 0.64), -0.77,
                             "JAX per-seed 0.178-0.272")
    values = [v for band in (res.bands or {}).values() for v in band.values()]
    values += list((res.ude_vs_cude or {}).values())
    log(f"[check] exp02 retrain outputs: bands {res.bands}, ude_vs_cude "
        f"{res.ude_vs_cude}")
    if res.dose_response is None or len(res.bands or {}) != 3 \
            or len(values) != 12 or not np.isfinite(values).all() \
            or not np.isfinite(res.dose_response).all():
        failures.append("exp02 retrain outputs missing or not finite")
    return failures


def check_retrain_covariate(res) -> list[str]:
    """exp07's retrain path against limits widened from its one JAX run
    (best Tsit5 objective 0.2328, test SSE mean 0.672, Spearman -0.626); no
    per-seed spread of exp07 exists."""
    return check_trained(res, 0.30, (0.50, 0.85), -0.45, "JAX run 0.2328")


def check_routes_and_objective(tr, refine_path: str, obj_max: float,
                               obj_ref: str, screen_path: str = "cuda_k1"
                               ) -> list[str]:
    """The kernels' routes a training took and its best Tsit5 objective."""
    failures = []
    timings = tr.timings
    if (timings["screen_path"], timings["refine_path"]) != (screen_path,
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
