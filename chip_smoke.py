"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root

1. builds the cohort RK4 kernel K4 from ``conditional_ude_tpu_torch/csrc``
   with ``nvcc`` and holds it against its plain PyTorch version at the
   census shape and at a ragged lane count;
2. times K4 and the plain version at the census shape;
3. runs the frozen-network path (``run_frozen_pipeline``) at full width:
   all 25 candidates, 117 subjects, 10,000 + 1,000 profile steps,
   1000 L-BFGS iterations, and checks it against the committed results;
4. checks that the two profile scans went through K4 (its launch count).

Every failure raises, so the exit code is non-zero.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
ARTIFACTS = REPO / "artifacts"
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Kernel against plain: identical inf positions, finite lanes within
    rtol 1e-5 / atol 1e-6; returns the max absolute error."""
    inf_k, inf_p = torch.isinf(out), torch.isinf(ref)
    if not torch.equal(inf_k, inf_p):
        raise AssertionError(f"{what}: inf lanes differ "
                             f"({int(inf_k.sum())} vs {int(inf_p.sum())})")
    if torch.isnan(out).any():
        raise AssertionError(f"{what}: kernel returned NaN")
    fin = torch.isfinite(ref)
    err = (out[fin] - ref[fin]).abs()
    bad = err > KERNEL_ATOL + KERNEL_RTOL * ref[fin].abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / ref[fin].abs().clamp_min(1e-30)).max())
    log(f"[kernel] {what}: {out.numel()} lanes, {int(inf_p.sum())} inf, "
        f"max abs err {max_abs:.3e}, max rel err {max_rel:.3e}")
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} lanes outside "
                             f"rtol {KERNEL_RTOL} / atol {KERNEL_ATOL}")
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


def huge_weights() -> np.ndarray:
    """ΔG → head weights of 1e20: a rising glucose curve drives the
    trajectory past float32, so the lane's SSE is inf."""
    w1 = np.zeros((4, 2))
    w1[:, 0] = 1e20
    return np.concatenate([w1.ravel(), np.zeros(4), np.eye(4).ravel(),
                           np.zeros(4), np.full(4, 1e20), [0.0]])


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is visible")
    sys.path.insert(0, str(REPO))
    from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
    from conditional_ude_tpu_torch.models.cpeptide import build_cohort
    from conditional_ude_tpu_torch.nn import chain
    from conditional_ude_tpu_torch.ops import rk4_cohort
    from conditional_ude_tpu_torch.ops.interp import linspace
    from conditional_ude_tpu_torch.pipeline import run_frozen_pipeline
    from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{kind}, {torch.cuda.device_count()} visible")

    # -- build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = rk4_cohort.build()
    rk4_cohort.library()
    log(f"[build] K4 {lib_path.name} in {time.perf_counter() - t0:.1f} s")

    # -- kernel vs plain ---------------------------------------------------
    net = chain(4, 2)
    train, test = load_npz(ARTIFACTS / "ohashi.npz")
    both = OhashiSplit.concatenate(train, test)
    cohort = build_cohort(both.glucose, both.timepoints, both.cpeptide,
                          both.ages, both.t2dm, dev)
    tp = cohort.timepoints
    nn_all = np.load(ARTIFACTS / "cude_neural_parameters.npz")["nn_params"]
    fit, meta = load_checkpoint(ARTIFACTS / "cude_fit.npz")
    centre = torch.as_tensor(
        np.concatenate([fit["beta_train"], fit["beta_test"]]), device=dev)

    # census shape: one chunk of 500 Δβ points × 117 subjects, the selected
    # network shared by every lane as a stride-0 view
    n = cohort.n
    s = 500
    grid = torch.as_tensor(linspace(-10.0, 10.0, 1000)[:s], device=dev)
    lanes = s * n

    def expand(x):
        return x.expand(s, *x.shape).reshape(lanes, *x.shape[1:])

    census_args = (
        torch.as_tensor(nn_all[meta["best_model_index"]], device=dev)
        .expand(lanes, -1),
        (grid[:, None] + centre[None, :]).reshape(-1),
        expand(cohort.glucose), expand(cohort.cpeptide),
        expand(cohort.kinetics()))
    out = rk4_cohort.cohort_sse(net, *census_args, tp, 8)
    ref = rk4_cohort.cohort_sse_reference(net, *census_args, tp, 8)
    err_census = compare(out, ref, f"census shape ({s} x {n})")

    # ragged lane count, per-lane random weights, one lane of huge weights
    rng = np.random.default_rng(2705)
    L = 1237
    pick = rng.integers(0, n, L)
    bounds = [np.sqrt(6.0 / (fi + fo)) for fi, fo in net.layer_dims]
    nn_r = np.concatenate(
        [np.concatenate([rng.uniform(-b, b, (L, fo * fi)), np.zeros((L, fo))],
                        axis=1)
         for b, (fi, fo) in zip(bounds, net.layer_dims)], axis=1)
    nn_r[-1] = huge_weights()
    glucose = both.glucose[pick].copy()
    glucose[-1] = [5.0, 6.0, 7.0, 8.0, 9.0]
    f32 = dict(dtype=torch.float32, device=dev)
    ragged_args = (
        torch.as_tensor(nn_r, **f32),
        torch.as_tensor(rng.uniform(-4.0, 1.0, L), **f32),
        torch.as_tensor(glucose, **f32),
        torch.as_tensor(both.cpeptide[pick], **f32),
        cohort.kinetics()[torch.as_tensor(pick, device=dev)].contiguous())
    out = rk4_cohort.cohort_sse(net, *ragged_args, tp, 8)
    ref = rk4_cohort.cohort_sse_reference(net, *ragged_args, tp, 8)
    if not bool(torch.isinf(out[-1])):
        raise AssertionError("the huge-weight lane's SSE is not inf")
    err_ragged = compare(out, ref, f"ragged ({L} lanes, random weights)")

    # -- timing at the census shape ---------------------------------------
    kernel_ms = cuda_ms(lambda: rk4_cohort.cohort_sse(net, *census_args, tp, 8),
                        reps=20)
    plain_ms = cuda_ms(
        lambda: rk4_cohort.cohort_sse_reference(net, *census_args, tp, 8),
        reps=3)
    log(f"[time] K4 census chunk ({lanes} lanes): kernel {kernel_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms  [{card}]")

    # -- the frozen path ---------------------------------------------------
    rk4_cohort.launches = 0
    t0 = time.perf_counter()
    res = run_frozen_pipeline(dev, ARTIFACTS, lbfgs_iters=1000)
    wall = time.perf_counter() - t0
    k4_launches = rk4_cohort.launches
    for name, sec in res.seconds.items():
        log(f"[time] stage {name}: {sec:.2f} s  [{card}]")
    log(f"[time] frozen path total: {wall:.2f} s  [{card}]")
    log(f"[path] K4 launches during the frozen path: {k4_launches}")

    metrics = json.loads((REPO / "results" / "exp02_metrics.json").read_text())
    failures = check_pipeline(res, fit, metrics)
    if k4_launches == 0:
        failures.append("K4 was not launched by the profile scans")
    if failures:
        raise AssertionError("frozen path checks failed:\n  "
                             + "\n  ".join(failures))

    log(json.dumps({"kernels": [{
        "name": "rk4_cohort_sse",
        "route": "cuda",
        "source": "conditional_ude_tpu_torch/csrc/rk4_cohort.cu",
        "replaces": "conditional_ude_tpu/ops/pallas_rk4.py:98",
        "launches": k4_launches,
        "max_abs_err": max(err_census, err_ragged),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def check_pipeline(res, fit: dict, metrics: dict) -> list[str]:
    """The frozen path against the committed artifacts and metrics."""
    failures = []
    log(f"[check] best candidate {res.best} (committed "
        f"{metrics['best_model_index']})")
    if res.best != metrics["best_model_index"]:
        failures.append(f"best candidate {res.best}")
    for split in ("train", "test"):
        b, s = getattr(res, f"b_{split}"), getattr(res, f"s_{split}")
        for arr in (b, s, getattr(res, f"sse_{split}")):
            if not np.isfinite(arr).all():
                failures.append(f"non-finite {split} fit")
        db = float(np.max(np.abs(b - fit[f"beta_{split}"])))
        ds = float(np.max(np.abs(s / fit[f"sigma_{split}"] - 1.0)))
        log(f"[check] {split}: max |dbeta| {db:.2e}, max rel dsigma {ds:.2e}")
        if db > 1e-2 or ds > 2e-2:
            failures.append(f"{split} beta/sigma off the committed fit")
    for name, key in (("test", "identifiability_census_test"),
                      ("all", "identifiability_census_all")):
        got, want = getattr(res, f"census_{name}"), metrics[key]
        log(f"[check] census {name}: {got} (committed {want})")
        if any(abs(got.get(c, 0) - want.get(c, 0)) > 1
               for c in set(got) | set(want)):
            failures.append(f"census {name} {got}")
    rho = res.spearman["first_phase"]
    log(f"[check] spearman first phase {rho:.4f} "
        f"(committed {metrics['spearman']['first_phase']:.4f})")
    if abs(rho - metrics["spearman"]["first_phase"]) > 0.01:
        failures.append(f"spearman {rho}")
    sse_mean = float(np.mean(res.sse_test))
    log(f"[check] test SSE mean {sse_mean:.4f} "
        f"(committed {metrics['test_sse_mean']:.4f})")
    if abs(sse_mean / metrics["test_sse_mean"] - 1.0) > 0.03:
        failures.append(f"test SSE mean {sse_mean}")
    prof, delta = res.profile.values, res.delta_profile.values
    if tuple(prof.shape) != (35, 10_000) or tuple(delta.shape) != (117, 1000):
        failures.append(f"profile shapes {tuple(prof.shape)}, "
                        f"{tuple(delta.shape)}")
    committed = fit["profile_values"]
    rel = np.abs(prof.cpu().numpy() / committed - 1.0)
    log(f"[check] test profile vs committed: median rel {np.median(rel):.2e}, "
        f"max rel {rel.max():.2e}")
    return failures


if __name__ == "__main__":
    main()
