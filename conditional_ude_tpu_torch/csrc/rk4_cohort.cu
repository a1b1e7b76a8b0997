// Fused cohort RK4 solve + SSE of the conditional c-peptide model, for Hopper (sm_90a).
//
// Replaces the TPU kernel conditional_ude_tpu/ops/pallas_rk4.py::_build_kernel
// (reached through cohort_sse_pallas).  Every lane is an independent 2-state
// ODE: van Cauter kinetics plus the production term
// MLP([dG, e^beta]) - MLP([0, e^beta]) of the canonical chain(4, 2) network
// (2 inputs, two tanh layers of width 4, softplus head: 37 weights), driven
// by the lane's glucose curve.  The kernel integrates it with fixed-step RK4
// over the shared observation grid and returns the SSE against the lane's
// c-peptide data at the save points; a non-finite SSE is stored as +inf.
//
// Design: one thread per lane.  The lane's 37 weights, its 5 glucose and data
// values and its 4 kinetic constants live in registers for the whole solve;
// the baseline MLP([0, e^beta]) is computed once before the time loop.  The
// time grid is shared, so the per-segment step sizes, the interpolation
// constants and the t = 0 blend (j0, w0) are computed on the host and passed
// by value.  A lane reads 37 + 15 floats and writes one, so on this card the
// kernel is bound by the per-lane arithmetic: 128 right-hand sides of eight
// tanhf, one expf and one log1pf (SFU and FMA pipes) and 33 multiply-adds.
// Reading one shared weight vector from shared memory and a warp-level
// layout of the MLP are later work.
//
// Numerics: accurate tanhf/expf/log1pf (no fast math), and the file is built
// with -fmad=false so that no multiply-add is contracted: the operations and
// their order are those of the plain PyTorch version in
// conditional_ude_tpu_torch/ops/rk4_cohort.py::cohort_sse_reference.
//
// C interface (loaded with ctypes): rk4_cohort_sse returns cudaGetLastError()
// after the launch.  It allocates nothing and launches on the given stream.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kIn = 2;
constexpr int kWidth = 4;
constexpr int kParams = kIn * kWidth + kWidth + kWidth * kWidth + kWidth + kWidth + 1;
static_assert(kParams == 37, "canonical chain(4, 2) on 2 inputs has 37 weights");
constexpr int kMaxTimepoints = 16;
constexpr int kBlock = 128;

struct Segment {
  float t0;        // segment start time
  float dt;        // RK4 step
  float half_dt;   // 0.5 * dt
  float sixth_dt;  // dt / 6
  float inv_span;  // 1 / (t1 - t0)
};

struct Grid {
  int n_seg;
  int substeps;
  int j0;               // glucose knot left of t = 0
  float one_minus_w0;   // blend weights of glucose(0)
  float w0;
  Segment seg[kMaxTimepoints - 1];
};

__device__ __forceinline__ float softplus(float x) {
  // max(x, 0) + log1p(exp(-|x|)); a NaN passes through as in torch.clamp_min
  const float pos = x < 0.0f ? 0.0f : x;
  return pos + log1pf(expf(-fabsf(x)));
}

struct Mlp {
  float w1[kWidth][kIn], b1[kWidth];
  float w2[kWidth][kWidth], b2[kWidth];
  float w3[kWidth], b3;

  __device__ __forceinline__ void load(const float* __restrict__ p) {
    int i = 0;
#pragma unroll
    for (int o = 0; o < kWidth; ++o)
#pragma unroll
      for (int k = 0; k < kIn; ++k) w1[o][k] = __ldg(p + i++);
#pragma unroll
    for (int o = 0; o < kWidth; ++o) b1[o] = __ldg(p + i++);
#pragma unroll
    for (int o = 0; o < kWidth; ++o)
#pragma unroll
      for (int k = 0; k < kWidth; ++k) w2[o][k] = __ldg(p + i++);
#pragma unroll
    for (int o = 0; o < kWidth; ++o) b2[o] = __ldg(p + i++);
#pragma unroll
    for (int k = 0; k < kWidth; ++k) w3[k] = __ldg(p + i++);
    b3 = __ldg(p + i);
  }

  // sum_k W[o][k] * h[k], left to right, then + b[o]
  __device__ __forceinline__ float operator()(float x0, float x1) const {
    float h1[kWidth], h2[kWidth];
#pragma unroll
    for (int o = 0; o < kWidth; ++o) {
      float acc = w1[o][0] * x0;
      acc = acc + w1[o][1] * x1;
      h1[o] = tanhf(acc + b1[o]);
    }
#pragma unroll
    for (int o = 0; o < kWidth; ++o) {
      float acc = w2[o][0] * h1[0];
#pragma unroll
      for (int k = 1; k < kWidth; ++k) acc = acc + w2[o][k] * h1[k];
      h2[o] = tanhf(acc + b2[o]);
    }
    float acc = w3[0] * h2[0];
#pragma unroll
    for (int k = 1; k < kWidth; ++k) acc = acc + w3[k] * h2[k];
    return softplus(acc + b3);
  }
};

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

  Mlp mlp;
  mlp.load(nn + lane * nn_lane_stride);
  const float e_beta = eb[lane];
  float g[kMaxTimepoints], d[kMaxTimepoints];
  for (int j = 0; j < k_pts; ++j) {
    g[j] = glucose[lane * k_pts + j];
    d[j] = data[lane * k_pts + j];
  }
  const float k0 = kinetics[lane * 4 + 0];
  const float k1 = kinetics[lane * 4 + 1];
  const float k2 = kinetics[lane * 4 + 2];
  const float c0 = kinetics[lane * 4 + 3];

  const float base = mlp(0.0f, e_beta);
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
      const float prod = mlp(dg, e_beta) - base;
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

}  // namespace

extern "C" int rk4_cohort_sse(const float* nn, long long nn_lane_stride,
                              const float* eb, const float* glucose,
                              const float* data, const float* kinetics,
                              float* out, long long lanes,
                              const float* segments,  // host [n_seg, 5]
                              int n_seg, int substeps, int j0,
                              float one_minus_w0, float w0, void* stream) {
  if (n_seg < 1 || n_seg > kMaxTimepoints - 1 || substeps < 1 || j0 < 0 ||
      j0 >= n_seg)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes <= 0) return 0;
  Grid grid;
  grid.n_seg = n_seg;
  grid.substeps = substeps;
  grid.j0 = j0;
  grid.one_minus_w0 = one_minus_w0;
  grid.w0 = w0;
  for (int s = 0; s < n_seg; ++s) {
    grid.seg[s] = Segment{segments[5 * s + 0], segments[5 * s + 1],
                          segments[5 * s + 2], segments[5 * s + 3],
                          segments[5 * s + 4]};
  }
  const long long blocks = (lanes + kBlock - 1) / kBlock;
  rk4_cohort_sse_kernel<<<static_cast<unsigned int>(blocks), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      nn, nn_lane_stride, eb, glucose, data, kinetics, out, lanes, grid);
  return static_cast<int>(cudaGetLastError());
}
