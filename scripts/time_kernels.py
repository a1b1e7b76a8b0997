"""Time the kernels of a tree of the PyTorch port on one NVIDIA card, at the
shapes the paths give them:

    python3 scripts/time_kernels.py                # this repository
    python3 scripts/time_kernels.py --root DIR     # the package in DIR
    python3 scripts/time_kernels.py --sass DIR     # + SASS counts of K1, K3, K4

``--root`` imports ``conditional_ude_tpu_torch`` from DIR (for example an
earlier commit unpacked with ``git archive``), which builds its own
kernels.  To compare two trees, run them one after another on one card,
the first again last.

On Glorot designs with Latin-hypercube β's and the exp02 fit split (57
subjects, real ages), both bodies (2 and 3 inputs) of:

- K2 at ``RESTARTS`` × 57 lanes (1,425 is the refinement of a training with
  25 restarts, 5,472 the enlarged multi-start's default of 96, 131,328 the
  2,304 restarts at which the refinement switches to K5) and K5 at 2,304 ×
  57;
- K1 at ``SCREENS`` × 57 (exp02's and exp02_xl's screens) and K3 at
  ``RERANKS`` × 57 (1,425 lanes, exp02's re-rank; 5,472, the enlarged
  multi-start's default of 96 restarts; 131,328, its re-rank at 2,304);
- K4 at a census chunk (500 Δβ points × 117 subjects on the committed exp02
  network, 58,500 lanes) and a test-profile chunk (500 β points × 35
  subjects, 17,500 lanes), K4c at exp07's test-profile chunk on exp07's
  committed network, each with the weight row expanded with lane stride 0
  as the profile scans pass it.

``call`` is CUDA events around back-to-back calls of the Python wrapper
(the ``ms`` of ``chip_smoke.py``), ``device`` one replay of a CUDA graph of
the same calls (its ``device_ms``), so the host's work is out of it.  The
inputs come from fixed seeds, so two trees time the same work.  ``--sass
DIR`` writes the SASS (``cuobjdump -sass``) of K1's, K3's and K4's
libraries into DIR and counts, for each kernel body, its instructions, its
MUFU (special-function unit) instructions, and the instructions of each
loop that holds a MUFU instruction, innermost first (with a thread a lane,
K1's and K4's innermost is an RK4 step: two network evaluations; K3's are
the save times an accepted step crosses, one division each, then an
attempted step: five evaluations, the stages and the controller).  It
checks nothing: ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold
the kernels to their plain versions.  The last line is a JSON object of the times.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

RESTARTS = (25, 96, 225, 450, 900, 1152, 2304)   # × 57 lanes for K2
K5_RESTARTS = 2304
SCREENS = (25_000, 400_000)      # K1: exp02's and exp02_xl's designs
RERANKS = (25, 96, 2304)         # K3: restarts of the re-ranks
CHUNK = 500                      # K4: grid points of a profile chunk


def call_ms(fn, reps: int) -> float:
    """Mean ms per call by CUDA events around ``reps`` calls."""
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


def device_ms(fn, reps: int) -> float:
    """Mean ms per call of one replay of a CUDA graph of ``reps`` calls."""
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


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)$")


def sass_counts(sass: str) -> dict[str, dict]:
    """Per kernel function of a ``cuobjdump -sass`` listing: instructions,
    MUFU instructions, and the loops (a branch back to a lower address)
    that hold a MUFU instruction, innermost first, as [instructions,
    MUFU]."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        insns = [(int(m.group(1), 16), m.group(2))
                 for m in map(_INSN.search, part.splitlines()) if m]
        loops = []
        for addr, text in insns:
            m = _BRANCH.search(text)
            start = int(m.group(1), 16) if m else addr
            if start < addr:
                body = [t for a, t in insns if start <= a <= addr]
                mufu = sum("MUFU" in t for t in body)
                if mufu:
                    loops.append([len(body), mufu])
        out[name] = dict(instructions=len(insns),
                         mufu=sum("MUFU" in t for _, t in insns),
                         loops=sorted(loops))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[1],
                        help="the tree whose package is timed")
    parser.add_argument("--sass", type=Path, default=None,
                        help="write the SASS of K1's, K3's and K4's "
                             "libraries here and print its instruction "
                             "counts")
    args = parser.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
    from conditional_ude_tpu_torch.models.cpeptide import build_cohort
    from conditional_ude_tpu_torch.nn import chain
    from conditional_ude_tpu_torch.ops import (
        lane_grad,
        population_grad,
        rk4_cohort,
        rk4_population,
        tsit5_cohort,
    )
    from conditional_ude_tpu_torch.ops.interp import linspace
    from conditional_ude_tpu_torch.pipeline import SEED
    from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint
    from conditional_ude_tpu_torch.utils.stats import (
        latin_hypercube,
        stratified_split,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card; none is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{card}; package from {root}", flush=True)
    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)
    art = root / "artifacts"
    train, test = load_npz(art / "ohashi.npz")
    idx_fit, _ = stratified_split(np.random.default_rng(SEED), train.types,
                                  0.7)

    def cohort_of(split):
        return build_cohort(split.glucose, split.timepoints, split.cpeptide,
                            split.ages, split.t2dm, dev)

    fit = cohort_of(train.subset(idx_fit))
    tp = tuple(float(t) for t in fit.timepoints)
    times = {}

    def timed(name, fn, reps):
        ms = (call_ms(fn, reps), device_ms(fn, reps))
        times[name] = ms
        print(f"[time] {name}: call {ms[0]:.4f} ms, device {ms[1]:.4f} ms  "
              f"[{card}]", flush=True)

    def profile_chunk(d, census):
        """K4's inputs at a chunk of a path's scan: the census over all
        subjects (exp02) or the test profile (exp02, exp07 with 3 inputs)."""
        fitted, meta = load_checkpoint(
            art / ("cude_fit.npz" if d == 2 else "cude_covariate_fit.npz"))
        row = np.load(art / ("cude_neural_parameters.npz" if d == 2 else
                             "cude_covariate_neural_parameters.npz"))[
            "nn_params"][meta["best_model_index"]]
        if census:
            c = cohort_of(OhashiSplit.concatenate(train, test))
            centre = torch.as_tensor(np.concatenate(
                [fitted["beta_train"], fitted["beta_test"]]), **f32)
            grid = torch.as_tensor(linspace(-10.0, 10.0, 1000)[:CHUNK], **f32)
        else:
            c = cohort_of(test)
            lb, ub = meta["bounds"]
            centre = torch.zeros(c.n, **f32)
            grid = torch.as_tensor(
                linspace(lb - 1.0, ub + 1.0, 10_000)[:CHUNK], **f32)
        lanes = CHUNK * c.n

        def expand(x):
            return x.expand(CHUNK, *x.shape).reshape(lanes, *x.shape[1:])

        return (torch.as_tensor(row, **f32).expand(lanes, -1),
                (grid[:, None] + centre[None, :]).reshape(-1),
                expand(c.glucose), expand(c.cpeptide),
                expand(c.kinetics(with_age=d == 3)), tp, 8)

    for d in (2, 3):
        net = chain(4, 2, input_dims=d)
        sfx = "c" if d == 3 else ""
        kin = fit.kinetics(with_age=d == 3)

        def designs(g, rng):
            parts = []
            for fi, fo in net.layer_dims:
                b = np.sqrt(6.0 / (fi + fo))
                parts += [rng.uniform(-b, b, (g, fo * fi)), np.zeros((g, fo))]
            lhs = latin_hypercube(rng, g, fit.n, -2.0, 0.0)
            return (torch.as_tensor(np.concatenate(parts, axis=1), **f32),
                    torch.as_tensor(lhs, **f32), fit.glucose, fit.cpeptide,
                    kin, tp)

        rng = np.random.default_rng(2705)
        for r in RESTARTS:
            a = designs(r, rng)
            timed(f"K2{sfx} at {r} x {fit.n} ({r * fit.n} lanes)",
                  lambda: lane_grad.lane_sse_and_grad(net, *a, 8),
                  50 if r < 500 else 20)
        a = designs(K5_RESTARTS, rng)
        timed(f"K5{sfx} at {K5_RESTARTS} x {fit.n}",
              lambda: population_grad.restart_sse_and_grad(net, *a, 8), 10)

        rng = np.random.default_rng(2705 + d)
        for g in SCREENS:
            a = designs(g, rng)
            timed(f"K1{sfx} at {g} x {fit.n}",
                  lambda: rk4_population.population_sse(net, *a, 8),
                  10 if g < 100_000 else 3)
        rng = np.random.default_rng(2709 + d)
        for r in RERANKS:
            a = designs(r, rng)
            timed(f"K3{sfx} at {r} x {fit.n} ({r * fit.n} lanes)",
                  lambda: tsit5_cohort.cohort_sse_tsit5(net, *a),
                  20 if r < 500 else 5)
        for what in ("census chunk", "test profile chunk")[d - 2:]:
            a = profile_chunk(d, what == "census chunk")
            timed(f"K4{sfx} at the {what} ({a[1].shape[0]} lanes)",
                  lambda: rk4_cohort.cohort_sse(net, *a), 50)

    if args.sass is not None:
        from torch.utils.cpp_extension import CUDA_HOME

        args.sass.mkdir(parents=True, exist_ok=True)
        tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
        for kid, mod in (("K1", rk4_population), ("K3", tsit5_cohort),
                         ("K4", rk4_cohort)):
            path = mod.kernel.build()
            sass = subprocess.run([str(tool), "-sass", str(path)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            (args.sass / f"{path.stem}.sass").write_text(sass)
            for fn, c in sass_counts(sass).items():
                body = "3 inputs" if "ILi3E" in fn else "2 inputs"
                print(f"[sass] {kid} of {root.name} {body}: {json.dumps(c)}",
                      flush=True)
    print(json.dumps({"card": card, "root": str(root),
                      "ms (call, device)": times}))


if __name__ == "__main__":
    main()
