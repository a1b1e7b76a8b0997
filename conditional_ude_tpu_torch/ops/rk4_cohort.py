"""K4: fused per-lane cohort RK4 solve + SSE (counterpart of
``conditional_ude_tpu/ops/pallas_rk4.py:43-244``, ``cohort_sse_pallas``).

Lanes are (grid point × individual) pairs of a likelihood-profile scan, or
any other set of independent solves: each lane has its own network weights,
β, glucose curve, c-peptide data and kinetic constants; all lanes share the
observation grid.  :func:`cohort_sse` launches the CUDA kernel in
``csrc/rk4_cohort.cu`` for CUDA tensors and runs :func:`cohort_sse_reference`,
the same arithmetic as plain tensor code, for CPU tensors.

The kernel is built by ``nvcc`` for ``sm_90a`` at first use into ``build/``
at the repository root and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from conditional_ude_tpu_torch.nn import MLP, softplus

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "rk4_cohort.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# -fmad=false: no contracted multiply-adds, so the kernel performs the plain
# version's operations in the plain version's order; no fast math
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
MAX_TIMEPOINTS = 16
CANONICAL_WIDTHS = (4, 4)

# kernel launches since import (or since a caller reset it to 0)
launches = 0

_lib = None


def check_net_canonical(net: MLP, input_dims: int | tuple = (2, 3)) -> None:
    """K4 computes the canonical cUDE network only: ``chain(4, 2)`` with tanh
    hidden layers and a softplus scalar head, on [ΔG, e^β] (2 inputs) or
    [ΔG, e^β, age] (3 inputs, the covariate model)."""
    allowed = (input_dims,) if isinstance(input_dims, int) else input_dims
    if (net.input_dims not in allowed or net.widths != CANONICAL_WIDTHS
            or any(a != "tanh" for a in net.activations)
            or net.output_dims != 1 or net.output_activation != "softplus"):
        raise ValueError(
            f"the cohort RK4 kernel supports only {allowed}-input chain(4, 2) "
            "MLPs with tanh hidden layers and a softplus output head; got "
            f"input_dims={net.input_dims}, widths={net.widths}, "
            f"activations={net.activations}, "
            f"output_activation={net.output_activation!r}")


def _segments(timepoints, substeps: int) -> tuple[np.ndarray, int, float, float]:
    """Per-segment constants ``[n_seg, 5]`` (t0, dt, dt/2, dt/6, 1/span) and
    the t = 0 blend (j0, 1 − w0, w0) of the glucose interpolant.

    Computed in float64 and rounded once to float32, as the JAX kernel's
    Python-float constants are.
    """
    ts = np.asarray(timepoints, np.float64)
    n_seg = ts.shape[0] - 1
    rows = []
    for s in range(n_seg):
        t0, t1 = float(ts[s]), float(ts[s + 1])
        dt = (t1 - t0) / substeps
        rows.append((t0, dt, 0.5 * dt, dt / 6.0, 1.0 / (t1 - t0)))
    j0 = int(np.clip(np.searchsorted(ts, 0.0, side="right") - 1, 0, n_seg - 1))
    w0 = float(np.clip((0.0 - ts[j0]) / (ts[j0 + 1] - ts[j0]), 0.0, 1.0))
    return np.asarray(rows, np.float32), j0, float(np.float32(1.0 - w0)), w0


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


def _mlp_forward(layers, x):
    """``Σ_k W[o][k]·h[k]`` left to right, then ``+ b[o]``: the kernel's order."""
    h = x
    for li, (W, b) in enumerate(layers):
        out = []
        for o in range(len(W)):
            acc = W[o][0] * h[0]
            for k in range(1, len(h)):
                acc = acc + W[o][k] * h[k]
            acc = acc + b[o]
            out.append(softplus(acc) if li == len(layers) - 1
                       else torch.tanh(acc))
        h = out
    return h[0]


def cohort_sse_reference(net: MLP, nn_params, betas, glucose, data, kinetics,
                         timepoints, substeps: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the kernel, batched over lanes.

    ``kinetics[L, 5]`` with an age column feeds age as the network's third
    input (the covariate model).
    """
    with_age = kinetics.shape[-1] == 5
    segs, j0, one_minus_w0, w0 = _segments(timepoints, substeps)
    layers = _mlp_rows(nn_params, net)
    eb = torch.exp(betas)
    k0, k1, k2, c0 = (kinetics[:, i] for i in range(4))
    extra = [kinetics[:, 4]] if with_age else []

    base = _mlp_forward(layers, [torch.zeros_like(eb), eb] + extra)
    g_at0 = one_minus_w0 * glucose[:, j0] + w0 * glucose[:, j0 + 1]
    decay = -(k0 + k2)
    inflow = k0 * c0
    neg_k1 = -k1

    u1 = c0
    u2 = (k2 / k1) * c0
    sse = torch.square(u1 - data[:, 0])
    for s, (t0, dt, half, sixth, inv_span) in enumerate(segs):
        gl, gr = glucose[:, s], glucose[:, s + 1]

        def rhs(t, v1, v2):
            w = (t - t0) * inv_span
            dg = float(np.float32(1.0) - w) * gl + float(w) * gr - g_at0
            prod = _mlp_forward(layers, [dg, eb] + extra) - base
            return (decay * v1 + k1 * v2 + inflow + prod,
                    neg_k1 * v2 + k2 * v1)

        h, d_t, sx = float(half), float(dt), float(sixth)
        for i in range(substeps):
            t = t0 + np.float32(i) * dt
            a1, a2 = rhs(t, u1, u2)
            b1, b2 = rhs(t + half, u1 + h * a1, u2 + h * a2)
            c1, c2 = rhs(t + half, u1 + h * b1, u2 + h * b2)
            e1, e2 = rhs(t + dt, u1 + d_t * c1, u2 + d_t * c2)
            u1 = u1 + sx * (a1 + 2.0 * b1 + 2.0 * c1 + e1)
            u2 = u2 + sx * (a2 + 2.0 * b2 + 2.0 * c2 + e2)
        sse = sse + torch.square(u1 - data[:, s + 1])
    return torch.where(torch.isfinite(sse), sse, torch.inf)


def _check_inputs(net, nn_params, betas, glucose, data, kinetics, timepoints,
                  substeps):
    check_net_canonical(net)
    tensors = dict(nn_params=nn_params, betas=betas, glucose=glucose,
                   data=data, kinetics=kinetics)
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if t.device != betas.device:
            raise ValueError(f"{name} is on {t.device}, betas on {betas.device}")
    n_lanes, k = betas.shape[0], len(timepoints)
    n_kin = 4 + int(net.input_dims == 3)
    shapes = dict(nn_params=(n_lanes, net.num_params), betas=(n_lanes,),
                  glucose=(n_lanes, k), data=(n_lanes, k),
                  kinetics=(n_lanes, n_kin))
    for name, shape in shapes.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(tensors[name].shape)}")
    ts = np.asarray(timepoints, np.float64)
    if not 2 <= k <= MAX_TIMEPOINTS or np.any(np.diff(ts) <= 0):
        raise ValueError(f"timepoints must be 2..{MAX_TIMEPOINTS} increasing "
                         f"times, got {ts}")
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
    ``kinetics[L, 4]`` rows (k0, k1, k2, c0), ``timepoints[K]`` shared by all
    lanes.  CPU tensors run :func:`cohort_sse_reference`; CUDA tensors launch
    the kernel.
    """
    _check_inputs(net, nn_params, betas, glucose, data, kinetics, timepoints,
                  substeps)
    if betas.device.type == "cpu":
        return cohort_sse_reference(net, nn_params, betas, glucose, data,
                                    kinetics, timepoints, substeps)
    if betas.device.type != "cuda":
        raise ValueError(f"no cohort RK4 kernel for device {betas.device}")
    if net.input_dims != 2:
        raise NotImplementedError(
            "the covariate (3-input) variant of the cohort RK4 kernel is not "
            "ported yet")
    return _launch(nn_params, betas, glucose, data, kinetics, timepoints,
                   substeps)


def _launch(nn_params, betas, glucose, data, kinetics, timepoints, substeps):
    global launches
    if nn_params.stride(-1) != 1 or (nn_params.shape[0] > 1 and
                                     nn_params.stride(0) not in
                                     (0, nn_params.shape[1])):
        raise ValueError("nn_params must be contiguous rows or one row "
                         "expanded with lane stride 0")
    for name, t in (("betas", betas), ("glucose", glucose), ("data", data),
                    ("kinetics", kinetics)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_lanes = betas.shape[0]
    out = torch.empty(n_lanes, dtype=torch.float32, device=betas.device)
    if n_lanes == 0:
        return out
    segs, j0, one_minus_w0, w0 = _segments(timepoints, substeps)
    lane_stride = nn_params.stride(0) if n_lanes > 1 else nn_params.shape[1]
    with torch.cuda.device(betas.device):
        eb = torch.exp(betas)
        stream = torch.cuda.current_stream(betas.device).cuda_stream
        err = library().rk4_cohort_sse(
            nn_params.data_ptr(), lane_stride, eb.data_ptr(),
            glucose.data_ptr(), data.data_ptr(), kinetics.data_ptr(),
            out.data_ptr(), n_lanes,
            segs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            segs.shape[0], substeps, j0, one_minus_w0, w0, stream)
    if err != 0:
        raise RuntimeError(f"rk4_cohort_sse launch failed: CUDA error {err}")
    launches += 1
    return out


# -- build and bind -----------------------------------------------------------

def nvcc_command(output: Path) -> list[str]:
    """The ``nvcc`` command line that builds the kernel library."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = "nvcc" if CUDA_HOME is None else str(Path(CUDA_HOME) / "bin" / "nvcc")
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(SOURCE)]


def build() -> Path:
    """Build the kernel library unless a build of this exact source and these
    flags exists; returns its path."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"rk4_cohort-{key.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.rk4_cohort_sse
        vp, ll, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_float)
        fn.argtypes = [vp, ll, vp, vp, vp, vp, vp, ll,
                       ctypes.POINTER(ctypes.c_float), i32, i32, i32, f32,
                       f32, vp]
        fn.restype = i32
        _lib = lib
    return _lib
