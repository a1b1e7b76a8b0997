// Fused cohort RK4 solve + SSE of the conditional c-peptide model, for Hopper (sm_90a).
//
// Replaces the TPU kernel conditional_ude_tpu/ops/pallas_rk4.py::_build_kernel
// (reached through cohort_sse_pallas), both of its bodies, at every network
// it takes (cude_mlp.cuh).  Every lane is an independent 2-state ODE: van
// Cauter kinetics plus the production term MLP([dG, e^beta]) -
// MLP([0, e^beta]) of a chain(widths, "tanh") network with a softplus head
// (37 weights for the canonical chain(4, 2)), or, for the covariate model,
// MLP([dG, e^beta, age]) - MLP([0, e^beta, age]) (41 for chain(4, 2); the
// age is the 5th column of the lane's kinetics row), driven by the lane's
// glucose curve.  The kernel integrates it with fixed-step RK4 over the
// shared observation grid and returns the SSE against the lane's c-peptide
// data at the save points; a non-finite SSE is stored as +inf.
//
// Design: one thread per lane.  The canonical lane's 37 (41) weights live
// in registers; a wider network's are read from device memory (through L1)
// where they are used, since a thread's copy would spill.  The lane takes
// e^beta of its beta and its SSE from cude_rk4.cuh's lane_sse, with the
// network at the lane's 69 points, each evaluated when the recursion
// reaches it.  The time grid is shared, so the per-segment step sizes and
// the t = 0 blend (j0, w0) are computed on the host and passed by value, or
// for a grid of more than 16 points read from the caller's copy in device
// memory (cude_mlp.cuh, CUDE_LONG_GRID).
//
// Bound: instruction throughput.  A lane reads ~52 floats and writes one,
// and does 69 network evaluations of ~220 instructions each for the
// canonical network (eight accurate tanhf, one expf and one log1pf: 17 SFU
// instructions and the rest on the FMA pipe; a wider network scales them
// with its tanh count and weights).
// The profile chunks hold 17,500 and 58,500 lanes, 4 and 14 warps an SM, so
// the smaller one also waits on the latency of each thread's chain.
//
// Numerics (cude_mlp.cuh): accurate tanhf/expf/log1pf, no contracted
// multiply-adds; the operations and their order are those of the plain
// PyTorch version in
// conditional_ude_tpu_torch/ops/rk4_cohort.py::cohort_sse_reference.
//
// C interface (loaded with ctypes): rk4_cohort_sse (2 inputs) and
// rk4_cohort_sse_age (3 inputs) take beta (not e^beta) and the segment rows
// on the host and, for a long-grid library, in device memory, and return
// cudaGetLastError() after the launch.  They allocate nothing and launch on
// the given stream.

#include "cude_rk4.cuh"

namespace {

using cude::Grid;
using cude::Mlp;

constexpr int kBlock = 128;

template <int In>
__global__ void __launch_bounds__(kBlock)
rk4_cohort_sse_kernel(const float* __restrict__ nn, long long nn_lane_stride,
                      const float* __restrict__ beta,
                      const float* __restrict__ glucose,
                      const float* __restrict__ data,
                      const float* __restrict__ kinetics,
                      float* __restrict__ out, long long lanes, const Grid grid) {
  using Net = Mlp<In>;
  constexpr int kKin = Net::kKin;
  const long long lane = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x;
  if (lane >= lanes) return;
  const int k_pts = grid.n_seg + 1;

  Net mlp;
  mlp.load(nn + lane * nn_lane_stride);
  const float sse = cude::lane_sse<In>(mlp, expf(beta[lane]), glucose + lane * k_pts,
                                       data + lane * k_pts, kinetics + lane * kKin,
                                       grid);
  out[lane] = isfinite(sse) ? sse : INFINITY;
}

template <int In>
int launch(const float* nn, long long nn_lane_stride, const float* beta,
           const float* glucose, const float* data, const float* kinetics,
           float* out, long long lanes,
           const float* segments,      // host [n_seg, 5]
           const float* segments_dev,  // device [n_seg, 5], a long grid's
           int n_seg, int substeps, int j0, float one_minus_w0, float w0,
           void* stream) {
  Grid grid;
  if (!cude::make_grid(segments, segments_dev, n_seg, substeps, j0,
                       one_minus_w0, w0, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes <= 0) return 0;
  const long long blocks = (lanes + kBlock - 1) / kBlock;
  rk4_cohort_sse_kernel<In><<<static_cast<unsigned int>(blocks), kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      nn, nn_lane_stride, beta, glucose, data, kinetics, out, lanes, grid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rk4_cohort_sse(const float* nn, long long nn_lane_stride,
                              const float* beta, const float* glucose,
                              const float* data, const float* kinetics,
                              float* out, long long lanes,
                              const float* segments,
                              const float* segments_dev, int n_seg,
                              int substeps, int j0, float one_minus_w0,
                              float w0, void* stream) {
  return launch<2>(nn, nn_lane_stride, beta, glucose, data, kinetics, out,
                   lanes, segments, segments_dev, n_seg, substeps, j0,
                   one_minus_w0, w0, stream);
}

extern "C" int rk4_cohort_sse_age(const float* nn, long long nn_lane_stride,
                                  const float* beta, const float* glucose,
                                  const float* data, const float* kinetics,
                                  float* out, long long lanes,
                                  const float* segments,
                                  const float* segments_dev, int n_seg,
                                  int substeps, int j0, float one_minus_w0,
                                  float w0, void* stream) {
  return launch<3>(nn, nn_lane_stride, beta, glucose, data, kinetics, out,
                   lanes, segments, segments_dev, n_seg, substeps, j0,
                   one_minus_w0, w0, stream);
}
