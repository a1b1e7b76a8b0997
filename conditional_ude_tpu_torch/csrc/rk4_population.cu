// Population mean SSE per restart (the screening pass of joint cUDE
// training), for Hopper (sm_90a).
//
// Replaces the TPU kernel
// conditional_ude_tpu/ops/pallas_rk4.py::_build_population_kernel (reached
// through population_sse_pallas).  A restart is one network (37 weights) and
// one beta per individual.  For each restart the kernel integrates every
// individual's 2-state c-peptide ODE with fixed-step RK4 over the shared
// observation grid and returns the mean over individuals of the SSE at the
// save points, +inf where the mean is not finite.
//
// Design: one thread per restart.  The restart's weights live in registers;
// the cohort (glucose, data and kinetics, N x (2K + 4) floats) is read once
// per block into shared memory, and the thread loops over the individuals.
// beta enters only layer 1 and does not change in time, so per individual
// e^beta (taken here, as the TPU kernel takes it), the partial
// pre-activations w1[o][1] * e^beta + b1[o] and the baseline
// MLP([0, e^beta]) are computed once, outside the time loop, as the JAX
// kernel hoists them (and the plain version with it).
//
// Bound: arithmetic.  The flagship screen is 25,000 restarts x 57
// individuals x 128 right-hand sides, each with 8 tanhf, one expf and one
// log1pf (SFU and FMA pipes) and ~60 multiplies and adds; the bytes moved
// (37 + 57 floats a restart) are negligible.  25,000 threads are ~780 warps
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
// C interface (loaded with ctypes): rk4_population_sse returns
// cudaGetLastError() after the launch.  It allocates nothing and launches
// on the given stream.

#include "cude_mlp.cuh"

namespace {

using cude::Grid;
using cude::kMaxTimepoints;
using cude::kWidth;
using cude::Mlp;
using cude::Segment;

constexpr int kBlock = 64;

__global__ void __launch_bounds__(kBlock)
rk4_population_sse_kernel(const float* __restrict__ nn,       // [G, 37]
                          const float* __restrict__ beta,     // [G, N]
                          const float* __restrict__ glucose,  // [N, K]
                          const float* __restrict__ data,     // [N, K]
                          const float* __restrict__ kinetics, // [N, 4]
                          float* __restrict__ out,            // [G]
                          long long restarts, int n_ind, float inv_n,
                          const Grid grid) {
  extern __shared__ float smem[];
  const int k_pts = grid.n_seg + 1;
  float* s_glucose = smem;
  float* s_data = s_glucose + n_ind * k_pts;
  float* s_kin = s_data + n_ind * k_pts;
  for (int i = threadIdx.x; i < n_ind * k_pts; i += blockDim.x) {
    s_glucose[i] = glucose[i];
    s_data[i] = data[i];
  }
  for (int i = threadIdx.x; i < n_ind * 4; i += blockDim.x) s_kin[i] = kinetics[i];
  __syncthreads();

  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (r >= restarts) return;

  Mlp mlp;
  mlp.load(nn + r * cude::kParams);

  float total = 0.0f;
  for (int n = 0; n < n_ind; ++n) {
    const float* g = s_glucose + n * k_pts;
    const float* d = s_data + n * k_pts;
    const float k0 = s_kin[4 * n + 0];
    const float k1 = s_kin[4 * n + 1];
    const float k2 = s_kin[4 * n + 2];
    const float c0 = s_kin[4 * n + 3];
    const float e_beta = expf(beta[r * n_ind + n]);

    // hoisted: layer-1 beta partials and the baseline network
    float s1[kWidth], h1[kWidth];
#pragma unroll
    for (int o = 0; o < kWidth; ++o) {
      s1[o] = mlp.w1[o][1] * e_beta + mlp.b1[o];
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

}  // namespace

extern "C" int rk4_population_sse(const float* nn, const float* beta,
                                  const float* glucose, const float* data,
                                  const float* kinetics, float* out,
                                  long long restarts, int n_ind,
                                  const float* segments,  // host [n_seg, 5]
                                  int n_seg, int substeps, int j0,
                                  float one_minus_w0, float w0, float inv_n,
                                  void* stream) {
  if (n_seg < 1 || n_seg > kMaxTimepoints - 1 || substeps < 1 || j0 < 0 ||
      j0 >= n_seg || n_ind < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (restarts <= 0) return 0;
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
  const size_t shared = sizeof(float) * static_cast<size_t>(n_ind) * (2 * (n_seg + 1) + 4);
  const long long blocks = (restarts + kBlock - 1) / kBlock;
  rk4_population_sse_kernel<<<static_cast<unsigned int>(blocks), kBlock, shared,
                              static_cast<cudaStream_t>(stream)>>>(
      nn, beta, glucose, data, kinetics, out, restarts, n_ind, inv_n, grid);
  return static_cast<int>(cudaGetLastError());
}
