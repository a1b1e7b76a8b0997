"""K4: fused per-lane cohort RK4 solve + SSE (counterpart of
``conditional_ude_tpu/ops/pallas_rk4.py:43-244``, ``cohort_sse_pallas``).

Lanes are (grid point × individual) pairs of a likelihood-profile scan, or
any other set of independent solves: each lane has its own network weights,
β, glucose curve, c-peptide data and kinetic constants; all lanes share the
observation grid.  The network is any ``chain(widths, "tanh")`` with a
softplus scalar head (:func:`check_net_canonical`, the JAX kernels'
domain) on [ΔG, e^β], or on [ΔG, e^β, age] for the covariate model, whose
kinetics rows carry the age as a 5th column.  :func:`cohort_sse` launches
the CUDA kernel in ``csrc/rk4_cohort.cu`` for CUDA tensors (one body per
input count, one library per network shape) and runs
:func:`cohort_sse_reference`, the same arithmetic as plain tensor code, for
CPU tensors.

The production term does not depend on the state, so a lane evaluates its
network only at the 1 + n_seg·(2·substeps + 1) points of
:func:`point_dgs` (69 on the OGTT grid), the points of K2; each RK4 step
takes three of them (:func:`rk4_point_sse`, shared with K1's plain version
and ``csrc/cude_rk4.cuh``).

The kernel is built by ``nvcc`` for ``sm_90a`` at first use into ``build/``
at the repository root and bound with ``ctypes`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from conditional_ude_tpu_torch.nn import MLP, softplus
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

# kernel launches since import (or since a caller cleared it), by network
# shape: ``{(input_dims, hidden widths): launches}``; ``launches`` and
# ``launches_age`` are its totals for the 2-input and the 3-input body
shape_launches: dict = {}


def __getattr__(name: str) -> int:
    return launch_total(shape_launches, name, __name__)

_ARGTYPES = [VP, I64, VP, VP, VP, VP, VP, I64, F32_PTR, VP, I32, I32, I32,
             F32, F32, VP]
kernel = KernelLibrary("rk4_cohort.cu", "rk4_cohort_sse", _ARGTYPES)
kernel_age = KernelLibrary("rk4_cohort.cu", "rk4_cohort_sse_age", _ARGTYPES)


def check_net_canonical(net: MLP) -> None:
    """The kernels compute the networks the JAX kernels take
    (``pallas_rk4.py::check_net_canonical``): any widths and depth of tanh
    hidden layers with a softplus scalar head, on [ΔG, e^β] (2 inputs) or
    [ΔG, e^β, age] (3 inputs, the covariate model)."""
    allowed = (2, 3)
    if (net.input_dims not in allowed
            or any(a != "tanh" for a in net.activations)
            or net.output_dims != 1 or net.output_activation != "softplus"):
        raise ValueError(
            f"the kernels support only {allowed}-input MLPs with tanh "
            "hidden layers and a softplus scalar output head; got "
            f"input_dims={net.input_dims}, activations={net.activations}, "
            f"output_dims={net.output_dims}, "
            f"output_activation={net.output_activation!r}")


def _segments(timepoints, substeps: int) -> tuple[np.ndarray, int, float, float]:
    """Per-segment constants ``[n_seg, 5]`` (t0, dt, dt/2, dt/6, 1/span) and
    the t = 0 blend (j0, 1 − w0, w0) of the glucose interpolant.

    Computed in float64 and rounded once to float32, as the JAX kernel's
    Python-float constants are; kept per grid, so a call of a kernel's
    wrapper does not build them again (the array is read-only).
    """
    return _segments_of(tuple(float(t) for t in timepoints), int(substeps))


@functools.lru_cache(maxsize=32)
def _segments_of(timepoints: tuple[float, ...], substeps: int):
    ts = np.asarray(timepoints, np.float64)
    n_seg = ts.shape[0] - 1
    rows = []
    for s in range(n_seg):
        t0, t1 = float(ts[s]), float(ts[s + 1])
        dt = (t1 - t0) / substeps
        rows.append((t0, dt, 0.5 * dt, dt / 6.0, 1.0 / (t1 - t0)))
    j0 = int(np.clip(np.searchsorted(ts, 0.0, side="right") - 1, 0, n_seg - 1))
    w0 = float(np.clip((0.0 - ts[j0]) / (ts[j0 + 1] - ts[j0]), 0.0, 1.0))
    segs = np.asarray(rows, np.float32)
    segs.flags.writeable = False
    return segs, j0, float(np.float32(1.0 - w0)), w0


def _mlp_rows(nn_params: torch.Tensor, net: MLP):
    """Per-layer ``(W[fo][fi], b[fo])`` lists of per-lane weight columns."""
    layers = []
    i = 0
    for fi, fo in net.layer_dims:
        W = [[nn_params[:, i + o * fi + k] for k in range(fi)]
             for o in range(fo)]
        i += fi * fo
        b = [nn_params[:, i + o] for o in range(fo)]
        i += fo
        layers.append((W, b))
    return layers


def _mlp_columns(nn_params: torch.Tensor, net: MLP):
    """:func:`_mlp_rows` of restarts ``nn_params[R, P]`` as ``[R, 1]``
    columns, which broadcast over an individual axis."""
    return [([[w[:, None] for w in row] for row in W], [b[:, None] for b in B])
            for W, B in _mlp_rows(nn_params, net)]


def _mlp_layers(layers, x):
    """The hidden layers' tanh outputs ``[h_l[...]]`` and the head's
    pre-activation of the network ``layers`` on input rows ``x``:
    ``Σ_k W[o][k]·h[k]`` left to right, then ``+ b[o]``, the kernels'
    order."""
    h, hidden = x, []
    for li, (W, b) in enumerate(layers):
        z = []
        for o in range(len(W)):
            acc = W[o][0] * h[0]
            for k in range(1, len(h)):
                acc = acc + W[o][k] * h[k]
            z.append(acc + b[o])
        if li + 1 == len(layers):
            return hidden, z[0]
        h = [torch.tanh(v) for v in z]
        hidden.append(h)


def _mlp_forward(layers, x):
    """The network's softplus output on input rows ``x``."""
    return softplus(_mlp_layers(layers, x)[1])


class PointNetwork:
    """A network on per-lane weight columns (``_mlp_rows`` or
    ``_mlp_columns`` of any layer list), evaluated point by point at
    [ΔG, e^β(, age)] in the kernels' order of operations
    (``csrc/cude_mlp.cuh``, ``Mlp``), with its hand VJP
    (``csrc/cude_grad.cuh``, ``point_vjp``)."""

    def __init__(self, layers, eb, extra):
        self.layers, self.eb, self.extra = layers, eb, extra

    def forward(self, dg):
        """:func:`_mlp_layers` at [ΔG = ``dg``, e^β(, age)]."""
        return _mlp_layers(self.layers, [dg, self.eb] + self.extra)

    def __call__(self, dg):
        z = self.forward(dg)[1]
        return torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-torch.abs(z)))

    def vjp(self, dg, weight):
        """``weight · ∂out/∂params`` stacked on a last axis ``[..., P]`` in
        the flat layout, and ``weight · ∂out/∂e^β``; the forward is
        recomputed.  Layer by layer from the head down, a hidden layer's
        cotangent is ``(Σ_o dz[o]·W[o][k], left to right)·(1 − h[k]²)``."""
        hidden, z = self.forward(dg)
        inputs = [[dg, self.eb] + self.extra] + hidden
        dz = [weight * (1.0 / (1.0 + torch.exp(-z)))]
        grads = [None] * len(self.layers)
        for li in range(len(self.layers) - 1, -1, -1):
            W = self.layers[li][0]
            a = inputs[li]
            grads[li] = [dz[o] * a[k] for o in range(len(W))
                         for k in range(len(a))] + dz

            def back(k, W=W, dz=dz):
                dh = dz[0] * W[0][k]
                for o in range(1, len(W)):
                    dh = dh + dz[o] * W[o][k]
                return dh

            if li == 0:
                dh_eb = back(1)                 # e^β is layer 0's input 1
            else:
                dz = [back(k) * (1.0 - a[k] * a[k]) for k in range(len(a))]
        return torch.stack([g for layer in grads for g in layer],
                           dim=-1), dh_eb


def point_dgs(glucose, timepoints, substeps: int) -> list[torch.Tensor]:
    """ΔG ``[N]`` of every evaluation point of the lanes on ``glucose[N, K]``,
    in the kernels' order: point 0 is the baseline ΔG = 0, then point j of
    segment s (``1 + s·(2·substeps + 1) + j``) at w = j/(2·substeps) of the
    segment, ``(1 − w)·g[s] + w·g[s + 1] − g(0)``; 1/(2·substeps) and each
    blend weight are rounded once to float32, as the kernels round them."""
    _, j0, one_minus_w0, w0 = _segments(timepoints, substeps)
    inv_2s = np.float32(1.0 / (2.0 * substeps))
    g_at0 = one_minus_w0 * glucose[:, j0] + w0 * glucose[:, j0 + 1]
    dgs = [torch.zeros_like(g_at0)]
    for s in range(len(timepoints) - 1):
        gl, gr = glucose[:, s], glucose[:, s + 1]
        for j in range(2 * substeps + 1):
            w = np.float32(j) * inv_2s
            dgs.append(float(np.float32(1.0) - w) * gl + float(w) * gr - g_at0)
    return dgs


def rk4_point_sse(mlp: PointNetwork, glucose, data, kinetics, timepoints,
                  substeps: int) -> torch.Tensor:
    """SSE per lane of the explicit RK4 solve, not yet mapped to ``inf``:
    the plain version of ``csrc/cude_rk4.cuh``'s ``rk4_sse`` and
    ``lane_sse``, shared by K1's and K4's plain versions.  ``mlp`` is
    called once at each of :func:`point_dgs`, in increasing order as the
    recursion reaches it; step i of a segment takes points 2i, 2i + 1 (its
    stages 2 and 3) and 2i + 2.  The cohort tensors have the lanes'
    individuals on their first axis; ``mlp``'s weights and e^β may add a
    leading restart axis."""
    segs = _segments(timepoints, substeps)[0]
    dgs = point_dgs(glucose, timepoints, substeps)
    q_seg = 2 * substeps + 1
    k0, k1, k2, c0 = (kinetics[:, i] for i in range(4))
    decay = -(k0 + k2)
    inflow = k0 * c0
    neg_k1 = -k1

    def rhs(v1, v2, p):
        return decay * v1 + k1 * v2 + inflow + p, neg_k1 * v2 + k2 * v1

    base = mlp(dgs[0])
    u1 = c0.expand_as(base)
    u2 = (k2 / k1) * u1
    sse = torch.square(u1 - data[:, 0])
    for s, (_, dt, half, sixth, _) in enumerate(segs):
        h, d_t, sx = float(half), float(dt), float(sixth)
        bq = 1 + s * q_seg
        pa = mlp(dgs[bq]) - base
        for i in range(substeps):
            pm = mlp(dgs[bq + 2 * i + 1]) - base
            pe = mlp(dgs[bq + 2 * i + 2]) - base
            a1, a2 = rhs(u1, u2, pa)
            b1, b2 = rhs(u1 + h * a1, u2 + h * a2, pm)
            c1, c2 = rhs(u1 + h * b1, u2 + h * b2, pm)
            e1, e2 = rhs(u1 + d_t * c1, u2 + d_t * c2, pe)
            u1 = u1 + sx * (a1 + 2.0 * b1 + 2.0 * c1 + e1)
            u2 = u2 + sx * (a2 + 2.0 * b2 + 2.0 * c2 + e2)
            pa = pe
        sse = sse + torch.square(u1 - data[:, s + 1])
    return sse


def cohort_sse_reference(net: MLP, nn_params, betas, glucose, data, kinetics,
                         timepoints, substeps: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the kernel, batched over lanes.

    ``kinetics[L, 5]`` with an age column feeds age as the network's third
    input (the covariate model).
    """
    extra = [kinetics[:, 4]] if kinetics.shape[-1] == 5 else []
    mlp = PointNetwork(_mlp_rows(nn_params, net), torch.exp(betas), extra)
    sse = rk4_point_sse(mlp, glucose, data, kinetics, timepoints, substeps)
    return torch.where(torch.isfinite(sse), sse, torch.inf)


def _check_float32(betas: torch.Tensor, **tensors) -> None:
    for name, t in dict(betas=betas, **tensors).items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if t.device != betas.device:
            raise ValueError(f"{name} is on {t.device}, betas on {betas.device}")


def _check_shapes(tensors: dict, shapes: dict, timepoints) -> None:
    for name, shape in shapes.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(tensors[name].shape)}")
    ts = np.asarray(timepoints, np.float64)
    if len(ts) < 2 or np.any(np.diff(ts) <= 0):
        raise ValueError(f"timepoints must be 2 or more increasing times, "
                         f"got {ts}")


def require_contiguous(**tensors) -> None:
    """The kernels index rows directly: every tensor must be contiguous."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def kinetics_columns(net: MLP) -> int:
    """Columns of a kinetics row for ``net``: (k0, k1, k2, c0), and the age
    for a 3-input network."""
    return 4 + int(net.input_dims == 3)


def check_restart_inputs(net: MLP, nn_params, betas, glucose, data, kinetics,
                         timepoints) -> None:
    """Inputs of the kernels that take restarts (K1, K2, K3): a 2- or
    3-input network the kernels take, float32 ``nn_params[R, P]`` and
    ``betas[R, N]`` on one device with the cohort ``glucose[N, K]``,
    ``data[N, K]``,
    ``kinetics[N, 4]`` (``[N, 5]`` with the age for 3 inputs) and two or
    more increasing ``timepoints[K]``."""
    check_net_canonical(net)
    tensors = dict(nn_params=nn_params, glucose=glucose, data=data,
                   kinetics=kinetics)
    _check_float32(betas, **tensors)
    if betas.ndim != 2:
        raise ValueError(f"betas must be [restarts, individuals], got "
                         f"{tuple(betas.shape)}")
    r, n = betas.shape
    k = len(timepoints)
    _check_shapes(tensors, dict(nn_params=(r, net.num_params), glucose=(n, k),
                                data=(n, k),
                                kinetics=(n, kinetics_columns(net))),
                  timepoints)


def _check_inputs(net, nn_params, betas, glucose, data, kinetics, timepoints,
                  substeps):
    check_net_canonical(net)
    tensors = dict(nn_params=nn_params, glucose=glucose, data=data,
                   kinetics=kinetics)
    _check_float32(betas, **tensors)
    n_lanes, k = betas.shape[0], len(timepoints)
    _check_shapes({**tensors, "betas": betas},
                  dict(nn_params=(n_lanes, net.num_params), betas=(n_lanes,),
                       glucose=(n_lanes, k), data=(n_lanes, k),
                       kinetics=(n_lanes, kinetics_columns(net))), timepoints)
    if substeps < 1:
        raise ValueError("substeps must be >= 1")


def cohort_sse(net: MLP, nn_params: torch.Tensor, betas: torch.Tensor,
               glucose: torch.Tensor, data: torch.Tensor,
               kinetics: torch.Tensor, timepoints, substeps: int = 8
               ) -> torch.Tensor:
    """Per-lane SSE ``[L]`` of the conditional c-peptide model; ``inf`` for a
    non-finite trajectory.

    ``nn_params[L, P]`` (an expanded view with lane stride 0 is taken as it
    is), ``betas[L]`` (β, not e^β), ``glucose[L, K]``, ``data[L, K]``,
    ``kinetics[L, 4]`` rows (k0, k1, k2, c0), with the age as a 5th column
    for a 3-input network, ``timepoints[K]`` shared by all lanes.  CPU
    tensors run :func:`cohort_sse_reference`; CUDA tensors launch the
    kernel's body for the network's input count.
    """
    _check_inputs(net, nn_params, betas, glucose, data, kinetics, timepoints,
                  substeps)
    if betas.device.type == "cpu":
        return cohort_sse_reference(net, nn_params, betas, glucose, data,
                                    kinetics, timepoints, substeps)
    if betas.device.type != "cuda":
        raise ValueError(f"no cohort RK4 kernel for device {betas.device}")
    return _launch(net, nn_params, betas, glucose, data, kinetics, timepoints,
                   substeps)


def _launch(net, nn_params, betas, glucose, data, kinetics, timepoints,
            substeps):
    if nn_params.stride(-1) != 1 or (nn_params.shape[0] > 1 and
                                     nn_params.stride(0) not in
                                     (0, nn_params.shape[1])):
        raise ValueError("nn_params must be contiguous rows or one row "
                         "expanded with lane stride 0")
    require_contiguous(betas=betas, glucose=glucose, data=data,
                       kinetics=kinetics)
    n_lanes = betas.shape[0]
    out = torch.empty(n_lanes, dtype=torch.float32, device=betas.device)
    if n_lanes == 0:
        return out
    segs, j0, one_minus_w0, w0 = _segments(timepoints, substeps)
    lane_stride = nn_params.stride(0) if n_lanes > 1 else nn_params.shape[1]
    long = long_grid(timepoints)
    with torch.cuda.device(betas.device):
        stream = torch.cuda.current_stream(betas.device).cuda_stream
        lib = (kernel_age if net.input_dims == 3 else kernel).at(net.widths,
                                                                 long)
        segs_dev = device_table(segs if long else None, betas.device)
        lib(nn_params.data_ptr(), lane_stride, betas.data_ptr(),
            glucose.data_ptr(), data.data_ptr(), kinetics.data_ptr(),
            out.data_ptr(), n_lanes, segs.ctypes.data_as(F32_PTR), segs_dev,
            segs.shape[0], substeps, j0, one_minus_w0, w0, stream)
    count_launch(shape_launches, net)
    return out
