// Population mean SSE per restart (the screening pass of joint cUDE
// training), for Hopper (sm_90a).
//
// Replaces the TPU kernel
// conditional_ude_tpu/ops/pallas_rk4.py::_build_population_kernel (reached
// through population_sse_pallas), both of its bodies.  A restart is one
// network (37 weights on [dG, e^beta]; 41 on [dG, e^beta, age] for the
// covariate model) and one beta per individual.  For each restart the kernel integrates every
// individual's 2-state c-peptide ODE with fixed-step RK4 over the shared
// observation grid and returns the mean over individuals of the SSE at the
// save points, +inf where the mean is not finite.
//
// Design: one thread per restart.  The restart's weights live in registers;
// the cohort (glucose, data and kinetics, N x (2K + 4|5) floats) is read
// once per block into shared memory, and the thread loops over the
// individuals.  beta (and the age) enter only layer 1 and do not change in
// time, so per individual e^beta (taken here, as the TPU kernel takes it),
// the partial pre-activations (w1[o][1] * e^beta + b1[o]) + w1[o][2] * age
// and the baseline network are computed once, outside the time loop, in the
// order the JAX kernel hoists them (pallas_rk4.py:290-293; the plain version
// with it); the time loop adds w1[o][0] * dG last.
//
// Bound: arithmetic.  The flagship screen is 25,000 restarts x 57
// individuals x 128 right-hand sides, each with 8 tanhf, one expf and one
// log1pf (SFU and FMA pipes) and ~60 multiplies and adds; the bytes moved
// (~41 + 57 floats a restart) are negligible.  25,000 threads are ~780 warps
// spread over 132 SMs, about six an SM, so the kernel is bound by the
// latency of each thread's dependent chain, not by the card's instruction
// throughput.  A (restart x individual) lane layout with an in-block reduction
// over individuals would give 57x more threads and hide that latency; it
// is the next step for this kernel.
//
// Numerics (cude_mlp.cuh): accurate tanhf/expf/log1pf, no contracted
// multiply-adds; the operations and their order are those of
// conditional_ude_tpu_torch/ops/rk4_population.py::population_sse_reference.
//
// C interface (loaded with ctypes): rk4_population_sse (2 inputs) and
// rk4_population_sse_age (3 inputs) return cudaGetLastError() after the
// launch.  They allocate nothing and launch on the given stream.

#include "cude_mlp.cuh"

namespace {

using cude::Grid;
using cude::kWidth;
using cude::Mlp;
using cude::Segment;

constexpr int kBlock = 64;

template <int In>
__global__ void __launch_bounds__(kBlock)
rk4_population_sse_kernel(const float* __restrict__ nn,       // [G, P]
                          const float* __restrict__ beta,     // [G, N]
                          const float* __restrict__ glucose,  // [N, K]
                          const float* __restrict__ data,     // [N, K]
                          const float* __restrict__ kinetics, // [N, 4|5]
                          float* __restrict__ out,            // [G]
                          long long restarts, int n_ind, float inv_n,
                          const Grid grid) {
  using Net = Mlp<In>;
  constexpr int kKin = Net::kKin;
  extern __shared__ float smem[];
  const int k_pts = grid.n_seg + 1;
  float* s_glucose = smem;
  float* s_data = s_glucose + n_ind * k_pts;
  float* s_kin = s_data + n_ind * k_pts;
  for (int i = threadIdx.x; i < n_ind * k_pts; i += blockDim.x) {
    s_glucose[i] = glucose[i];
    s_data[i] = data[i];
  }
  for (int i = threadIdx.x; i < n_ind * kKin; i += blockDim.x) s_kin[i] = kinetics[i];
  __syncthreads();

  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (r >= restarts) return;

  Net mlp;
  mlp.load(nn + r * Net::kParams);

  float total = 0.0f;
  for (int n = 0; n < n_ind; ++n) {
    const float* g = s_glucose + n * k_pts;
    const float* d = s_data + n * k_pts;
    const float* kin = s_kin + kKin * n;
    const float k0 = kin[0];
    const float k1 = kin[1];
    const float k2 = kin[2];
    const float c0 = kin[3];
    const float e_beta = expf(beta[r * n_ind + n]);

    // hoisted: layer-1 beta (and age) partials and the baseline network
    float s1[kWidth], h1[kWidth];
#pragma unroll
    for (int o = 0; o < kWidth; ++o) {
      s1[o] = mlp.w1[o][1] * e_beta + mlp.b1[o];
      if constexpr (In == 3) s1[o] = s1[o] + mlp.w1[o][2] * kin[4];
      h1[o] = tanhf(s1[o]);
    }
    const float base = mlp.rest(h1);
    const float g_at0 = grid.one_minus_w0 * g[grid.j0] + grid.w0 * g[grid.j0 + 1];
    const float decay = -(k0 + k2);
    const float inflow = k0 * c0;
    const float neg_k1 = -k1;

    float u1 = c0;
    float u2 = (k2 / k1) * u1;
    float r0 = u1 - d[0];
    float sse = r0 * r0;

    for (int s = 0; s < grid.n_seg; ++s) {
      const Segment sg = grid.seg[s];
      const float gl = g[s], gr = g[s + 1];
      auto rhs = [&](float t, float v1, float v2, float& d1, float& d2) {
        const float w = (t - sg.t0) * sg.inv_span;
        const float dg = (1.0f - w) * gl + w * gr - g_at0;
        float h[kWidth];
#pragma unroll
        for (int o = 0; o < kWidth; ++o) h[o] = tanhf(mlp.w1[o][0] * dg + s1[o]);
        const float prod = mlp.rest(h) - base;
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
      const float res = u1 - d[s + 1];
      sse = sse + res * res;
    }
    total = n == 0 ? sse : total + sse;
  }
  const float mean = total * inv_n;
  out[r] = isfinite(mean) ? mean : INFINITY;
}

template <int In>
int launch(const float* nn, const float* beta, const float* glucose,
           const float* data, const float* kinetics, float* out,
           long long restarts, int n_ind,
           const float* segments,  // host [n_seg, 5]
           int n_seg, int substeps, int j0, float one_minus_w0, float w0,
           float inv_n, void* stream) {
  Grid grid;
  if (!cude::make_grid(segments, n_seg, substeps, j0, one_minus_w0, w0, &grid) ||
      n_ind < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (restarts <= 0) return 0;
  const size_t shared = sizeof(float) * static_cast<size_t>(n_ind) *
                        (2 * (n_seg + 1) + Mlp<In>::kKin);
  const long long blocks = (restarts + kBlock - 1) / kBlock;
  rk4_population_sse_kernel<In><<<static_cast<unsigned int>(blocks), kBlock,
                                  shared, static_cast<cudaStream_t>(stream)>>>(
      nn, beta, glucose, data, kinetics, out, restarts, n_ind, inv_n, grid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rk4_population_sse(const float* nn, const float* beta,
                                  const float* glucose, const float* data,
                                  const float* kinetics, float* out,
                                  long long restarts, int n_ind,
                                  const float* segments, int n_seg,
                                  int substeps, int j0, float one_minus_w0,
                                  float w0, float inv_n, void* stream) {
  return launch<2>(nn, beta, glucose, data, kinetics, out, restarts, n_ind,
                   segments, n_seg, substeps, j0, one_minus_w0, w0, inv_n,
                   stream);
}

extern "C" int rk4_population_sse_age(const float* nn, const float* beta,
                                      const float* glucose, const float* data,
                                      const float* kinetics, float* out,
                                      long long restarts, int n_ind,
                                      const float* segments, int n_seg,
                                      int substeps, int j0, float one_minus_w0,
                                      float w0, float inv_n, void* stream) {
  return launch<3>(nn, beta, glucose, data, kinetics, out, restarts, n_ind,
                   segments, n_seg, substeps, j0, one_minus_w0, w0, inv_n,
                   stream);
}
