"""On the card: ms of one value+grad of the suppression loss for four
formulations of the network's layers and head, and a torch.profiler
summary of one value+grad at the sweep's shape.

    python3 scripts/suppression_probe.py

The formulations: the layers as ``torch.baddbmm`` (the port's) or as a
broadcast multiply and sum; the head as the port's softplus (JAX's
formula and derivative) or ``torch.nn.functional.softplus``.  Each is
timed at 125 rows x 37 subjects (the sweep), 250 x 30 (the validations)
and 25 x 30, 5 calls after one warm call, by the host clock around
``torch.cuda.synchronize``.  Then, for the two layer formulations, the
profiler's count of CUDA kernels in one value+grad at 125 x 37 and its
table (the self CUDA time total under it is the device time).  Prints
JSON lines and the profiler tables.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from conditional_ude_tpu_torch.models import suppression as sup  # noqa: E402
from conditional_ude_tpu_torch.nn import ACTIVATIONS  # noqa: E402
from conditional_ude_tpu_torch.suppression_pipeline import (  # noqa: E402
    DATA_SEED,
    GROUP_MEANS,
    TIMEPOINTS,
)


def variant(layer: str, head: str):
    """A ``make_ude_rhs`` with the given layer and head formulation."""
    def make(net, nn_params, thetas):
        ws = net.unflatten(nn_params)
        if layer == "bmm":
            layers = [(w.transpose(-1, -2).contiguous(),
                       b.unsqueeze(-2).contiguous()) for w, b in ws]
        else:
            layers = [(w.unsqueeze(-3).contiguous(),
                       b.unsqueeze(-2).contiguous()) for w, b in ws]
        acts = [torch.tanh] * 5 + [ACTIVATIONS["softplus"] if head == "port"
                                   else F.softplus]
        cond = torch.exp(thetas).unsqueeze(-1)
        p1, _, p3 = (float(np.float32(p)) for p in sup.P_TRUE)
        lin = torch.tensor([[-p1, p1, 0.0], [0.0, 0.0, 0.0],
                            [0.0, 0.0, -p3]], device=nn_params.device)
        sign = torch.tensor([0.0, -1.0, 1.0], device=nn_params.device)

        def rhs(t, u):
            h = torch.cat([u, cond], -1)
            for (w, b), act in zip(layers, acts):
                if layer == "bmm":
                    h = act(torch.baddbmm(b, h, w))
                else:
                    h = act((h.unsqueeze(-2) * w).sum(-1) + b)
            return torch.addcmul(u @ lin, h, sign)
        return rhs
    return make


def main() -> None:
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(DATA_SEED)
    data, _ = sup.generate_data(GROUP_MEANS, (15, 3, 3, 3, 3, 10),
                                TIMEPOINTS, 0.1, rng=rng, device=dev)
    valid, _ = sup.generate_data(GROUP_MEANS, (5,) * 6, TIMEPOINTS, 0.1,
                                 rng=rng, device=dev)
    net = sup.suppression_net()
    port = sup.make_ude_rhs

    def value_grad(rows, d):
        gen = torch.Generator().manual_seed(0)
        nn, th = (a.to(dev) for a in sup.initial_designs(
            net, rows, d.shape[0], gen))
        lam = torch.full((rows,), 0.01, device=dev)

        def one():
            a = nn.clone().requires_grad_(True)
            b = th.clone().requires_grad_(True)
            torch.autograd.grad(sup.suppression_loss(
                net, a, b, d, TIMEPOINTS, lam).sum(), [a, b])
        return one

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    out = {}
    for layer in ("bmm", "mulsum"):
        for head in ("port", "F"):
            sup.make_ude_rhs = variant(layer, head)
            for name, rows, d in (("125x37", 125, data),
                                  ("250x30", 250, valid),
                                  ("25x30", 25, valid)):
                out[f"{layer}/{head}/{name}"] = timed(value_grad(rows, d))
            print(json.dumps(out), flush=True)
    from torch.profiler import ProfilerActivity, profile
    for layer in ("bmm", "mulsum"):
        sup.make_ude_rhs = variant(layer, "port")
        f = value_grad(125, data)
        f()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            f()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        kernels = sum(e.count for e in ka
                      if str(getattr(e, "device_type", "")).endswith("CUDA"))
        print(layer, "CUDA kernels", kernels)
        print(ka.table(sort_by="self_cuda_time_total", row_limit=12))
    sup.make_ude_rhs = port


if __name__ == "__main__":
    main()
