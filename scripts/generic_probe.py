"""Where the generic training route's time goes, on the card or the CPU.

    python3 scripts/generic_probe.py [cuda|cpu]

On exp02's 57-subject fit split: one value+grad of 15 restarts by
autograd through Tsit5 (path A of ``chip_smoke.py``'s generic path) and
through RK4 (path B, two conditional parameters), three times each with
host clocks, then once under ``torch.profiler`` (kernel launches and
device time); each screen of 2,500 designs; path A's training cut to 5
Adam and 2 L-BFGS steps with its stage times; the (β, σ) fit of the 35
test subjects at 5 and 10 L-BFGS steps and the selection of 3 candidates
on the 25 validation subjects at 3 steps, all with ``solver="tsit5"``.
"""

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from conditional_ude_tpu_torch.data.ohashi import load_npz  # noqa: E402
from conditional_ude_tpu_torch.fit import train as ptrain  # noqa: E402
from conditional_ude_tpu_torch.fit.losses import population_sse  # noqa: E402
from conditional_ude_tpu_torch.models.cpeptide import (  # noqa: E402
    CPeptideModel,
    build_cohort,
)
from conditional_ude_tpu_torch.nn import chain  # noqa: E402
from conditional_ude_tpu_torch.utils.stats import (  # noqa: E402
    latin_hypercube,
    stratified_split,
)

SEED = 270523


def main(device: str) -> None:
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def log(*args):
        print(*args, flush=True)

    def stage(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        log(f"[probe] {name}: {time.perf_counter() - t0:.2f} s")
        return out

    train, test = load_npz(REPO / "artifacts" / "ohashi.npz")
    idx_fit, idx_val = stratified_split(np.random.default_rng(SEED),
                                        train.types, 0.7)

    def cohort(s):
        return build_cohort(s.glucose, s.timepoints, s.cpeptide, s.ages,
                            s.t2dm, dev)

    fit = cohort(train.subset(idx_fit))
    nets = np.load(REPO / "tests" / "golden" / "generic_designs.npz")
    rng = np.random.default_rng(0)
    for path, model, solver, k in (
            ("A", CPeptideModel(chain(4, 2)), "tsit5", 1),
            ("B", CPeptideModel(chain(4, 2, "gelu", input_dims=3)), "rk4",
             2)):
        def lanes(rows):
            shape = (rows, fit.n, k) if k > 1 else (rows, fit.n)
            return torch.as_tensor(rng.uniform(-2, 0, shape).astype(
                np.float32), device=dev)

        nn, b = torch.as_tensor(nets[f"nn_{path}"][:15], device=dev), lanes(15)

        def value_and_grad():
            with torch.enable_grad():
                x = nn.clone().requires_grad_(True)
                y = b.clone().requires_grad_(True)
                f = population_sse(model, x[:, None, :], y, fit,
                                   solver=solver, substeps=8)
                sync()
                t1 = time.perf_counter()
                torch.autograd.grad(f.sum(), (x, y))
            return t1

        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            t1 = value_and_grad()
            sync()
            log(f"{path} value+grad at 15 x 57: forward "
                f"{1e3 * (t1 - t0):.1f} ms, backward "
                f"{1e3 * (time.perf_counter() - t1):.1f} ms")
        with torch.no_grad():
            nn_all = torch.as_tensor(nets[f"nn_{path}"], device=dev)
            stage(f"{path} screen 2500 x 57", lambda: population_sse(
                model, nn_all[:, None, :], lanes(2500), fit, solver=solver,
                substeps=8))
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            value_and_grad()
            sync()
        events = prof.key_averages()
        kernels = sum(e.count for e in events
                      if str(e.device_type).endswith("CUDA"))
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        log(f"{path} one value+grad: {kernels} device kernels, device time "
            f"{device_ms:.1f} ms")

    cfg = ptrain.TrainConfig(initial_guesses=2500, selected_initials=15,
                             adam_iters=5, lbfgs_iters=2, solver="tsit5")
    lhs = latin_hypercube(np.random.default_rng(SEED), 2500, fit.n, -2.0,
                          0.0).astype(np.float32).reshape(2500, fit.n, 1)
    res = stage("A cut (5 Adam, 2 L-BFGS)", lambda: ptrain.train_conditional(
        CPeptideModel(chain(4, 2)), fit, cfg, designs=(nets["nn_A"], lhs)))
    log("A timings", {k: round(v, 3) if isinstance(v, float) else v
                      for k, v in res.timings.items()})
    with np.load(REPO / "artifacts" / "cude_neural_parameters.npz") as z:
        cand = torch.as_tensor(z["nn_params"], device=dev)
        betas = torch.as_tensor(z["betas"], device=dev)
    test_c, val_c = cohort(test), cohort(train.subset(idx_val))
    model = CPeptideModel(chain(4, 2))
    for iters in (5, 10):
        stage(f"C fit {iters} steps", lambda: ptrain.fit_betas_sigma(
            model, cand[19], test_c, -1.0, (-4.7, 0.1), iters,
            solver="tsit5"))
    stage("C evaluate 3 steps", lambda: ptrain.evaluate_model(
        model, cand[[0, 1, 19]], betas[[0, 1, 19]], val_c, lbfgs_iters=3,
        solver="tsit5"))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda")
