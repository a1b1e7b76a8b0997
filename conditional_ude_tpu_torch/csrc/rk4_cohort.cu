// Fused cohort RK4 solve + SSE of the conditional c-peptide model, for Hopper (sm_90a).
//
// Replaces the TPU kernel conditional_ude_tpu/ops/pallas_rk4.py::_build_kernel
// (reached through cohort_sse_pallas), both of its bodies.  Every lane is an
// independent 2-state ODE: van Cauter kinetics plus the production term
// MLP([dG, e^beta]) - MLP([0, e^beta]) of the canonical chain(4, 2) network
// (2 inputs, two tanh layers of width 4, softplus head: 37 weights), or, for
// the covariate model, MLP([dG, e^beta, age]) - MLP([0, e^beta, age]) (3
// inputs, 41 weights; the age is the 5th column of the lane's kinetics row),
// driven by the lane's glucose curve.  The kernel integrates it with
// fixed-step RK4 over the shared observation grid and returns the SSE against
// the lane's c-peptide data at the save points; a non-finite SSE is stored as
// +inf.
//
// Design: one thread per lane.  The lane's 37 (41) weights, its 5 glucose and
// data values and its 4 (5) kinetics values live in registers for the whole
// solve; the baseline network is computed once before the time loop.  The
// time grid is shared, so the per-segment step sizes, the interpolation
// constants and the t = 0 blend (j0, w0) are computed on the host and passed
// by value.  A lane reads ~52 floats and writes one, so on this card the
// kernel is bound by the per-lane arithmetic: 128 right-hand sides of eight
// tanhf, one expf and one log1pf (SFU and FMA pipes) and 33 (37) multiplies
// and adds.  Reading one shared weight vector from shared memory and a
// warp-level layout of the MLP are later work.
//
// Numerics (cude_mlp.cuh): accurate tanhf/expf/log1pf, no contracted
// multiply-adds; the operations and their order are those of the plain
// PyTorch version in
// conditional_ude_tpu_torch/ops/rk4_cohort.py::cohort_sse_reference, which
// follows the JAX kernel: w . [dG, e^beta, age] left to right, then the bias.
//
// C interface (loaded with ctypes): rk4_cohort_sse (2 inputs) and
// rk4_cohort_sse_age (3 inputs) return cudaGetLastError() after the launch.
// They allocate nothing and launch on the given stream.

#include "cude_mlp.cuh"

namespace {

using cude::Grid;
using cude::kMaxTimepoints;
using cude::Mlp;
using cude::Segment;

constexpr int kBlock = 128;

template <int In>
__global__ void __launch_bounds__(kBlock)
rk4_cohort_sse_kernel(const float* __restrict__ nn, long long nn_lane_stride,
                      const float* __restrict__ eb,
                      const float* __restrict__ glucose,
                      const float* __restrict__ data,
                      const float* __restrict__ kinetics,
                      float* __restrict__ out, long long lanes, const Grid grid) {
  const long long lane = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (lane >= lanes) return;
  const int k_pts = grid.n_seg + 1;

  using Net = Mlp<In>;
  constexpr int kKin = Net::kKin;
  Net mlp;
  mlp.load(nn + lane * nn_lane_stride);
  const float e_beta = eb[lane];
  float g[kMaxTimepoints], d[kMaxTimepoints];
  for (int j = 0; j < k_pts; ++j) {
    g[j] = glucose[lane * k_pts + j];
    d[j] = data[lane * k_pts + j];
  }
  const float* kin = kinetics + lane * kKin;
  const float k0 = kin[0];
  const float k1 = kin[1];
  const float k2 = kin[2];
  const float c0 = kin[3];
  const float age = kKin == 5 ? kin[kKin - 1] : 0.0f;  // read by 3 inputs only

  const float base = mlp(0.0f, e_beta, age);
  const float g_at0 = grid.one_minus_w0 * g[grid.j0] + grid.w0 * g[grid.j0 + 1];
  const float decay = -(k0 + k2);
  const float inflow = k0 * c0;
  const float neg_k1 = -k1;

  float u1 = c0;
  float u2 = (k2 / k1) * c0;
  float r0 = u1 - d[0];
  float sse = r0 * r0;

  for (int s = 0; s < grid.n_seg; ++s) {
    const Segment sg = grid.seg[s];
    const float gl = g[s], gr = g[s + 1];
    auto rhs = [&](float t, float v1, float v2, float& d1, float& d2) {
      const float w = (t - sg.t0) * sg.inv_span;
      const float dg = (1.0f - w) * gl + w * gr - g_at0;
      const float prod = mlp(dg, e_beta, age) - base;
      d1 = decay * v1 + k1 * v2 + inflow + prod;
      d2 = neg_k1 * v2 + k2 * v1;
    };
    for (int i = 0; i < grid.substeps; ++i) {
      const float t = sg.t0 + static_cast<float>(i) * sg.dt;
      float a1, a2, b1, b2, c1, c2, e1, e2;
      rhs(t, u1, u2, a1, a2);
      rhs(t + sg.half_dt, u1 + sg.half_dt * a1, u2 + sg.half_dt * a2, b1, b2);
      rhs(t + sg.half_dt, u1 + sg.half_dt * b1, u2 + sg.half_dt * b2, c1, c2);
      rhs(t + sg.dt, u1 + sg.dt * c1, u2 + sg.dt * c2, e1, e2);
      u1 = u1 + sg.sixth_dt * (a1 + 2.0f * b1 + 2.0f * c1 + e1);
      u2 = u2 + sg.sixth_dt * (a2 + 2.0f * b2 + 2.0f * c2 + e2);
    }
    const float r = u1 - d[s + 1];
    sse = sse + r * r;
  }
  out[lane] = isfinite(sse) ? sse : INFINITY;
}

template <int In>
int launch(const float* nn, long long nn_lane_stride, const float* eb,
           const float* glucose, const float* data, const float* kinetics,
           float* out, long long lanes,
           const float* segments,  // host [n_seg, 5]
           int n_seg, int substeps, int j0, float one_minus_w0, float w0,
           void* stream) {
  Grid grid;
  if (!cude::make_grid(segments, n_seg, substeps, j0, one_minus_w0, w0, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes <= 0) return 0;
  const long long blocks = (lanes + kBlock - 1) / kBlock;
  rk4_cohort_sse_kernel<In><<<static_cast<unsigned int>(blocks), kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      nn, nn_lane_stride, eb, glucose, data, kinetics, out, lanes, grid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rk4_cohort_sse(const float* nn, long long nn_lane_stride,
                              const float* eb, const float* glucose,
                              const float* data, const float* kinetics,
                              float* out, long long lanes,
                              const float* segments, int n_seg, int substeps,
                              int j0, float one_minus_w0, float w0,
                              void* stream) {
  return launch<2>(nn, nn_lane_stride, eb, glucose, data, kinetics, out,
                   lanes, segments, n_seg, substeps, j0, one_minus_w0, w0,
                   stream);
}

extern "C" int rk4_cohort_sse_age(const float* nn, long long nn_lane_stride,
                                  const float* eb, const float* glucose,
                                  const float* data, const float* kinetics,
                                  float* out, long long lanes,
                                  const float* segments, int n_seg,
                                  int substeps, int j0, float one_minus_w0,
                                  float w0, void* stream) {
  return launch<3>(nn, nn_lane_stride, eb, glucose, data, kinetics, out,
                   lanes, segments, n_seg, substeps, j0, one_minus_w0, w0,
                   stream);
}
