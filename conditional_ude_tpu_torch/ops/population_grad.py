"""K5: population mean SSE per restart with its exact discrete gradient,
one block per restart, for multi-starts too wide for the packed lanes of
K2 (counterpart of ``conditional_ude_tpu/ops/pallas_grad.py:188-311``,
``_build_population_grad_kernel``, and ``_population_sse_and_grad_impl``).

The mathematics is K2's (``ops/lane_grad.py``): the affine matrix-form RK4,
the adjoint recursion over the residuals and one hand VJP of the network
per evaluation point.  What differs is the layout: a block takes one
restart, its warps compute the restart's lanes (one individual each, as K2
computes a lane) and the block sums them over the individuals and applies
1/N itself, so the outputs are ``(f[R], gnn[R, P], gb[R, N])`` and no
``[R, N, P]`` array exists.

The order of every sum is K2's within a lane (``lane_grad.lane_sum``), then
the individuals 0..N−1 one after another (:func:`sum_in_order`), then 1/N.
So K5 equals K2's lanes summed that way bit for bit, and its plain version,
:func:`restart_sse_and_grad_reference`, is exactly that.  It is not the JAX
kernel's order (one running accumulator over the individuals and their
points), so the port agrees with JAX's K5 to float32 reassociation, as K2
does with JAX's K2.  ``packed_sse_and_grad`` sums K2's lanes with
``Tensor.sum``, another order, so the two routes agree to reassociation.

:func:`restart_sse_and_grad` launches ``csrc/population_grad.cu`` for CUDA
tensors and runs :func:`restart_sse_and_grad_reference` for CPU tensors.
``lane_grad.population_sse_and_grad`` calls it above ``PACK_MAX_LANES``.
"""

from __future__ import annotations

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
from conditional_ude_tpu_torch.ops.lane_grad import (
    grid_constants,
    lane_sse_and_grad_reference,
)
from conditional_ude_tpu_torch.ops.rk4_cohort import (
    _segments,
    check_restart_inputs,
    require_contiguous,
)
from conditional_ude_tpu_torch.ops.tsit5 import f32

# kernel launches since import (or since a caller cleared it), by network
# shape: ``{(input_dims, hidden widths): launches}``; ``launches`` and
# ``launches_age`` are its totals for the 2-input and the 3-input body
shape_launches: dict = {}


def __getattr__(name: str) -> int:
    return launch_total(shape_launches, name, __name__)

_ARGTYPES = [VP, VP, VP, VP, VP, VP, VP, VP, I64, I32, F32_PTR, VP, I32, I32,
             I32, F32, VP, VP]
kernel = KernelLibrary("population_grad.cu", "population_sse_and_grad",
                       _ARGTYPES)
kernel_age = KernelLibrary("population_grad.cu",
                           "population_sse_and_grad_age", _ARGTYPES)


def sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Σ of ``x[R, N, ...]`` over the individuals (axis 1), taken 0..N−1 one
    after another, as K5's block sums them."""
    total = x[:, 0]
    for n in range(1, x.shape[1]):
        total = total + x[:, n]
    return total


def restart_sse_and_grad_reference(net: MLP, nn_params, betas, glucose, data,
                                   kinetics, timepoints, substeps: int = 8):
    """Plain PyTorch version of the kernel: ``(f[R], gnn[R, P], gb[R, N])``,
    K2's plain lanes summed over the individuals in order and times 1/N,
    ``inf`` where the mean is not finite."""
    sse, gnn, gb = lane_sse_and_grad_reference(
        net, nn_params, betas, glucose, data, kinetics, timepoints, substeps)
    inv_n = f32(1.0 / betas.shape[1])
    mean = sum_in_order(sse) * inv_n
    f = torch.where(torch.isfinite(mean), mean, torch.inf)
    return f, sum_in_order(gnn) * inv_n, gb * inv_n


def restart_sse_and_grad(net: MLP, nn_params: torch.Tensor,
                         betas: torch.Tensor, glucose: torch.Tensor,
                         data: torch.Tensor, kinetics: torch.Tensor,
                         timepoints, substeps: int = 8):
    """``(f[R], gnn[R, P], gb[R, N])`` of restarts ``nn_params[R, P]``,
    ``betas[R, N]`` on a cohort ``glucose[N, K]``, ``data[N, K]``,
    ``kinetics[N, 4]`` (``[N, 5]`` with the age for a 3-input network): the
    population mean SSE per restart (``inf`` where it is not finite) and
    its gradient, 1/N applied.  CPU tensors run the plain version; CUDA
    tensors launch the kernel's body for the network's input count at any
    cohort size, grid and substep count (``csrc/population_grad.cu`` takes
    the individuals in tiles where the cohort does not fit a block)."""
    check_restart_inputs(net, nn_params, betas, glucose, data, kinetics,
                         timepoints)
    if betas.shape[1] < 1 or substeps < 1:
        raise ValueError("need at least one individual and one substep")
    if betas.device.type == "cpu":
        return restart_sse_and_grad_reference(net, nn_params, betas, glucose,
                                              data, kinetics, timepoints,
                                              substeps)
    if betas.device.type != "cuda":
        raise ValueError(f"no restart value+grad kernel for device "
                         f"{betas.device}")
    return _launch(net, nn_params, betas, glucose, data, kinetics,
                   timepoints, substeps)


def _launch(net, nn_params, betas, glucose, data, kinetics, timepoints,
            substeps):
    require_contiguous(nn_params=nn_params, betas=betas, glucose=glucose,
                       data=data, kinetics=kinetics)
    r, n = betas.shape
    opts = dict(dtype=torch.float32, device=betas.device)
    f = torch.empty(r, **opts)
    gnn = torch.empty(r, nn_params.shape[1], **opts)
    gb = torch.empty(r, n, **opts)
    if r == 0:
        return f, gnn, gb
    _, j0, _, _ = _segments(timepoints, substeps)
    consts = grid_constants(timepoints, substeps)
    long = long_grid(timepoints)
    n_seg = len(timepoints) - 1
    with torch.cuda.device(betas.device):
        stream = torch.cuda.current_stream(betas.device).cuda_stream
        lib = (kernel_age if net.input_dims == 3 else kernel).at(net.widths,
                                                                 long)
        consts_dev = device_table(consts if long else None, betas.device)
        ws = lib.workspace(betas.device, r, n, n_seg, substeps)
        lib(nn_params.data_ptr(), betas.data_ptr(), glucose.data_ptr(),
            data.data_ptr(), kinetics.data_ptr(), f.data_ptr(),
            gnn.data_ptr(), gb.data_ptr(), r, n,
            consts.ctypes.data_as(F32_PTR), consts_dev, n_seg, substeps, j0,
            f32(1.0 / n), None if ws is None else ws.data_ptr(), stream)
    count_launch(shape_launches, net)
    return f, gnn, gb
