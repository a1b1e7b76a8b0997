"""K1: population mean SSE per restart, the screening pass of joint training
(counterpart of ``conditional_ude_tpu/ops/pallas_rk4.py:251-427``,
``population_sse_pallas``).

A restart is one network ``nn[P]`` and one β per individual.  For each
restart the kernel solves every individual's c-peptide ODE with fixed-step
RK4 over the shared observation grid, sums the SSEs over the individuals
and returns their mean, ``inf`` where it is not finite.  Each (restart,
individual) lane is K4's lane (``ops/rk4_cohort.py::rk4_point_sse``: the
network at the 69 points of K2, the baseline ΔG = 0 once), and the sum over
individuals runs first to last, so K1 is exactly the in-order mean of K4's
lanes on the same inputs.

:func:`population_sse` launches ``csrc/rk4_population.cu`` for CUDA
tensors and runs :func:`population_sse_reference` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from conditional_ude_tpu_torch.nn import MLP
from conditional_ude_tpu_torch.ops.cuda_build import (
    F32,
    F32_PTR,
    I32,
    I64,
    VP,
    KernelLibrary,
    count_launch,
    device_table,
    launch_total,
    long_grid,
)
from conditional_ude_tpu_torch.ops.rk4_cohort import (
    PointNetwork,
    _mlp_columns,
    _segments,
    check_restart_inputs,
    require_contiguous,
    rk4_point_sse,
)

# kernel launches since import (or since a caller cleared it), by network
# shape: ``{(input_dims, hidden widths): launches}``; ``launches`` and
# ``launches_age`` are its totals for the 2-input and the 3-input body
shape_launches: dict = {}


def __getattr__(name: str) -> int:
    return launch_total(shape_launches, name, __name__)

_ARGTYPES = [VP, VP, VP, VP, VP, VP, I64, I32, F32_PTR, VP, I32, I32, I32,
             F32, F32, F32, VP]
kernel = KernelLibrary("rk4_population.cu", "rk4_population_sse", _ARGTYPES)
kernel_age = KernelLibrary("rk4_population.cu", "rk4_population_sse_age",
                           _ARGTYPES)


def population_sse_reference(net: MLP, nn_params, betas, glucose, data,
                             kinetics, timepoints, substeps: int = 8
                             ) -> torch.Tensor:
    """Plain PyTorch version of the kernel over ``[G, N]`` lanes; the sum
    over individuals runs in the kernel's order, first to last."""
    n = betas.shape[1]
    extra = [kinetics[:, 4]] if kinetics.shape[1] == 5 else []
    # per-restart weight columns [G, 1], broadcast over the individuals
    mlp = PointNetwork(_mlp_columns(nn_params, net), torch.exp(betas), extra)
    sse = rk4_point_sse(mlp, glucose, data, kinetics, timepoints, substeps)
    total = sse[:, 0]
    for i in range(1, n):
        total = total + sse[:, i]
    mean = total * float(np.float32(1.0 / n))
    return torch.where(torch.isfinite(mean), mean, torch.inf)


def population_sse(net: MLP, nn_params: torch.Tensor, betas: torch.Tensor,
                   glucose: torch.Tensor, data: torch.Tensor,
                   kinetics: torch.Tensor, timepoints, substeps: int = 8
                   ) -> torch.Tensor:
    """Population mean SSE ``[G]`` of restarts ``nn_params[G, P]``,
    ``betas[G, N]`` (β, not e^β) on a cohort ``glucose[N, K]``,
    ``data[N, K]``, ``kinetics[N, 4]`` (k0, k1, k2, c0; a 5th column, the
    age, for a 3-input network) over the shared ``timepoints[K]``.  CPU
    tensors run the plain version; CUDA tensors launch the kernel's body
    for the network's input count."""
    check_restart_inputs(net, nn_params, betas, glucose, data, kinetics,
                         timepoints)
    if betas.shape[1] < 1 or substeps < 1:
        raise ValueError("need at least one individual and one substep")
    if betas.device.type == "cpu":
        return population_sse_reference(net, nn_params, betas, glucose, data,
                                        kinetics, timepoints, substeps)
    if betas.device.type != "cuda":
        raise ValueError(f"no population RK4 kernel for device {betas.device}")
    return _launch(net, nn_params, betas, glucose, data, kinetics,
                   timepoints, substeps)


def _launch(net, nn_params, betas, glucose, data, kinetics, timepoints,
            substeps):
    require_contiguous(nn_params=nn_params, betas=betas, glucose=glucose,
                       data=data, kinetics=kinetics)
    g, n = betas.shape
    out = torch.empty(g, dtype=torch.float32, device=betas.device)
    if g == 0:
        return out
    segs, j0, one_minus_w0, w0 = _segments(timepoints, substeps)
    long = long_grid(timepoints)
    with torch.cuda.device(betas.device):
        stream = torch.cuda.current_stream(betas.device).cuda_stream
        lib = (kernel_age if net.input_dims == 3 else kernel).at(net.widths,
                                                                 long)
        segs_dev = device_table(segs if long else None, betas.device)
        lib(nn_params.data_ptr(), betas.data_ptr(), glucose.data_ptr(),
            data.data_ptr(), kinetics.data_ptr(), out.data_ptr(), g, n,
            segs.ctypes.data_as(F32_PTR), segs_dev, segs.shape[0], substeps,
            j0, one_minus_w0, w0, float(np.float32(1.0 / n)), stream)
    count_launch(shape_launches, net)
    return out
