// Population mean SSE per restart with its exact discrete gradient, restarts
// as threads (the value+grad of joint cUDE training when the multi-start is
// too wide for the (restart x individual) lane kernel), for Hopper (sm_90a).
//
// Replaces the TPU kernel
// conditional_ude_tpu/ops/pallas_grad.py::_build_population_grad_kernel
// (reached through _population_sse_and_grad_impl, which
// population_sse_and_grad_pallas takes above PACK_MAX_LANES packed lanes),
// both of its bodies: the network on [dG, e^beta] (37 weights) or, for the
// covariate model, on [dG, e^beta, age] (41 weights; the age is the 5th
// column of the individual's kinetics row).  For each restart it returns
//   f      = (sum_n sse_n) / N, +inf where that is not finite,
//   gnn[P] = (sum_n d sse_n / d nn) / N,
//   gb[n]  = (d sse_n / d beta_n) / N,
// the mathematics of lane_grad.cu (cude_grad.cuh: the affine matrix-form
// RK4, the adjoint recursion over the residuals, one hand VJP of the
// network per evaluation point) with the loop over individuals inside.
//
// Design: one thread per restart, as the TPU kernel has one lane per
// restart.  The restart's weights and its 37 (41) gradient accumulators live
// in registers across the individual loop; the cohort (glucose, data and
// kinetics, N x (2K + 4|5) floats) is read once per block into shared
// memory, as rk4_population.cu keeps it.  No activation is kept: per
// individual the forward pass evaluates the network point by point and keeps
// only the residuals; the backward pass walks the segments last to first,
// writes a segment's 2 substeps + 1 point weights to a small local array,
// and recomputes each point's forward inside its VJP.  beta and gb are
// [G, N] row-major, so a thread strides by N floats: uncoalesced, but N
// floats a thread against ~140 N network evaluations.
//
// Order of every sum (that of the JAX kernel, pallas_grad.py:273-309, and of
// ops/population_grad.py::restart_sse_and_grad_reference): the gradient
// accumulators start at 0 and run over the individuals 0..N-1 without a
// per-individual partial sum; within an individual the segments last to
// first, the points of a segment first to last, and the dG = 0 baseline
// (weight -sum w, the weights summed in that same order) last; the SSE of an
// individual sums its residuals first to last and is added to the running
// total; 1/N multiplies last.
//
// Bound: latency.  One thread runs N x ~140 dependent network evaluations;
// a wide multi-start of 2,304 restarts is 72 warps on 132 SMs, so a launch
// costs one thread's chain, far above the card's arithmetic or memory
// bound.  Blocks are one warp, which spreads the restarts over the most
// SMs; a block per restart with a fixed-order reduction over individuals
// would shorten the chain N-fold and is the next step for this kernel.
//
// Numerics (cude_mlp.cuh): accurate tanhf/expf/log1pf, no contracted
// multiply-adds; the sigmoid is 1 / (1 + expf(-z)).
//
// C interface (loaded with ctypes): population_sse_and_grad (2 inputs) and
// population_sse_and_grad_age (3 inputs) return cudaGetLastError() after the
// launch.  They allocate nothing and launch on the given stream.

#include "cude_grad.cuh"

namespace {

using cude::GradGrid;
using cude::kMaxSubsteps;
using cude::kMaxTimepoints;
using cude::Mlp;
using cude::Stage;
using cude::stage_matrices;

constexpr int kBlock = 32;
constexpr int kMaxSegPoints = 2 * kMaxSubsteps + 1;

template <int In>
__global__ void __launch_bounds__(kBlock)
population_sse_and_grad_kernel(const float* __restrict__ nn,       // [G, P]
                               const float* __restrict__ beta,     // [G, N]
                               const float* __restrict__ glucose,  // [N, K]
                               const float* __restrict__ data,     // [N, K]
                               const float* __restrict__ kinetics, // [N, 4|5]
                               float* __restrict__ f_out,          // [G]
                               float* __restrict__ gnn_out,        // [G, P]
                               float* __restrict__ gb_out,         // [G, N]
                               long long restarts, int n_ind, float inv_n,
                               const GradGrid grid) {
  using Net = Mlp<In>;
  constexpr int kParams = Net::kParams;
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
  const int q_seg = 2 * grid.substeps + 1;

  Net mlp;
  mlp.load(nn + r * kParams);

  float gacc[kParams];
#pragma unroll
  for (int i = 0; i < kParams; ++i) gacc[i] = 0.0f;
  float total = 0.0f;

  for (int n = 0; n < n_ind; ++n) {
    const float* g = s_glucose + n * k_pts;
    const float* d = s_data + n * k_pts;
    const float* kin = s_kin + kKin * n;
    const float k0 = kin[0];
    const float k1 = kin[1];
    const float k2 = kin[2];
    const float c0 = kin[3];
    const float age = kKin == 5 ? kin[kKin - 1] : 0.0f;  // read by 3 inputs only
    const float e_beta = expf(beta[r * n_ind + n]);
    const float g_at0 = grid.one_minus_w0 * g[grid.j0] + grid.w0 * g[grid.j0 + 1];
    const float kc = k0 * c0;

    // dG of point j (0..2 substeps) of segment s
    auto dg_at = [&](int s, int j) -> float {
      const float wq = static_cast<float>(j) * grid.inv_2s;
      return (1.0f - wq) * g[s] + wq * g[s + 1] - g_at0;
    };
    auto net = [&](float dg) -> float { return mlp(dg, e_beta, age); };

    // -- forward: matrix-form RK4, two fresh network points per substep ----
    const float base = net(0.0f);
    float res[kMaxTimepoints];
    float u1 = c0;
    float u2 = (k2 / k1) * u1;
    res[0] = u1 - d[0];
    for (int s = 0; s < grid.n_seg; ++s) {
      const Stage st = stage_matrices(k0, k1, k2, grid.seg[s], grid);
      float pr_a = net(dg_at(s, 0)) - base;
      for (int i = 0; i < grid.substeps; ++i) {
        const float pr_m = net(dg_at(s, 2 * i + 1)) - base;
        const float pr_d = net(dg_at(s, 2 * i + 2)) - base;
        const float ra = kc + pr_a;
        const float rm = kc + pr_m;
        const float rd = kc + pr_d;
        const float n1 = st.r.a * u1 + st.r.b * u2 + st.ma.a * ra + st.mmid.a * rm + st.c * rd;
        const float n2 = st.r.c * u1 + st.r.d * u2 + st.ma.c * ra + st.mmid.c * rm + 0.0f * rd;
        u1 = n1;
        u2 = n2;
        pr_a = pr_d;
      }
      res[s + 1] = u1 - d[s + 1];
    }
    float sse = res[0] * res[0];
    for (int s = 1; s < k_pts; ++s) sse = sse + res[s] * res[s];

    // -- backward: segments last to first; a segment's point weights from
    // the adjoint recursion, then one recomputing VJP per point ------------
    float l1 = 0.0f, l2 = 0.0f;
    float w_tot = 0.0f;
    float deb = 0.0f;
    float contrib[kParams];
    for (int s = grid.n_seg - 1; s >= 0; --s) {
      const Stage st = stage_matrices(k0, k1, k2, grid.seg[s], grid);
      l1 = l1 + 2.0f * res[s + 1];
      float w[kMaxSegPoints];
      for (int i = grid.substeps - 1; i >= 0; --i) {
        w[2 * i] = st.ma.a * l1 + st.ma.c * l2;
        w[2 * i + 1] = st.mmid.a * l1 + st.mmid.c * l2;
        const float end = st.c * l1 + 0.0f * l2;
        w[2 * i + 2] = i == grid.substeps - 1 ? end : w[2 * i + 2] + end;
        const float nl1 = st.r.a * l1 + st.r.c * l2;
        const float nl2 = st.r.b * l1 + st.r.d * l2;
        l1 = nl1;
        l2 = nl2;
      }
      for (int q = 0; q < q_seg; ++q) {
        const float dh_eb = cude::point_vjp<In>(mlp, dg_at(s, q), e_beta, age, w[q], contrib);
#pragma unroll
        for (int i = 0; i < kParams; ++i) gacc[i] = gacc[i] + contrib[i];
        deb = deb + dh_eb;
        w_tot = w_tot + w[q];
      }
    }
    // the hoisted baseline: weight -sum w on the dG = 0 evaluation
    const float dh_eb = cude::point_vjp<In>(mlp, 0.0f, e_beta, age, -w_tot, contrib);
#pragma unroll
    for (int i = 0; i < kParams; ++i) gacc[i] = gacc[i] + contrib[i];
    deb = deb + dh_eb;

    gb_out[r * n_ind + n] = deb * e_beta * inv_n;
    total = total + sse;
  }

  const float mean = total * inv_n;
  f_out[r] = isfinite(mean) ? mean : INFINITY;
#pragma unroll
  for (int i = 0; i < kParams; ++i) gnn_out[r * kParams + i] = gacc[i] * inv_n;
}

template <int In>
int launch(const float* nn, const float* beta, const float* glucose,
           const float* data, const float* kinetics, float* f, float* gnn,
           float* gb, long long restarts, int n_ind,
           const float* consts,  // host, see lane_grad.py::grid_constants
           int n_seg, int substeps, int j0, float inv_n, void* stream) {
  GradGrid grid;
  if (!cude::make_grad_grid(consts, n_seg, substeps, j0, &grid) || n_ind < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (restarts <= 0) return 0;
  const size_t shared = sizeof(float) * static_cast<size_t>(n_ind) *
                        (2 * (n_seg + 1) + Mlp<In>::kKin);
  const long long blocks = (restarts + kBlock - 1) / kBlock;
  population_sse_and_grad_kernel<In><<<static_cast<unsigned int>(blocks), kBlock,
                                       shared, static_cast<cudaStream_t>(stream)>>>(
      nn, beta, glucose, data, kinetics, f, gnn, gb, restarts, n_ind, inv_n, grid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int population_sse_and_grad(const float* nn, const float* beta,
                                       const float* glucose, const float* data,
                                       const float* kinetics, float* f,
                                       float* gnn, float* gb,
                                       long long restarts, int n_ind,
                                       const float* consts, int n_seg,
                                       int substeps, int j0, float inv_n,
                                       void* stream) {
  return launch<2>(nn, beta, glucose, data, kinetics, f, gnn, gb, restarts,
                   n_ind, consts, n_seg, substeps, j0, inv_n, stream);
}

extern "C" int population_sse_and_grad_age(const float* nn, const float* beta,
                                           const float* glucose,
                                           const float* data,
                                           const float* kinetics, float* f,
                                           float* gnn, float* gb,
                                           long long restarts, int n_ind,
                                           const float* consts, int n_seg,
                                           int substeps, int j0, float inv_n,
                                           void* stream) {
  return launch<3>(nn, beta, glucose, data, kinetics, f, gnn, gb, restarts,
                   n_ind, consts, n_seg, substeps, j0, inv_n, stream);
}
