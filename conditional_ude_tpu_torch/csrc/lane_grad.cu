// Per-lane SSE of the conditional c-peptide model with its exact discrete
// gradient (the value+grad of every refinement step of joint cUDE
// training), for Hopper (sm_90a).
//
// Replaces the TPU kernel
// conditional_ude_tpu/ops/pallas_grad.py::_build_lane_grad_kernel (reached
// through population_sse_and_grad_pallas / fused_population_vg), both of its
// bodies: the network on [dG, e^beta] (37 weights) or, for the covariate
// model, on [dG, e^beta, age] (41 weights; the age is the 5th column of the
// individual's kinetics row).  A lane is one (restart, individual) pair.  The production term does not depend on
// the state, so the ODE is affine in it and one RK4 step is
//   v <- R v + M_a r(t) + M_mid r(t + dt/2) + M_d r(t + dt)
// with 2x2 stage matrices of the kinetics.  The forward pass needs the
// network at 1 + n_seg (2 substeps + 1) points (69 on the OGTT grid; point 0
// is the dG = 0 baseline) and gives the residuals at the save times; the
// adjoint recursion over the residuals gives each point's weight (the
// baseline's is minus their sum); one hand VJP per point gives the
// gradient of the 37 (41) weights and of beta.  The age is an input, not a
// parameter: it adds sum dz1[o] * age to w1[o][2]'s gradient and leaves the
// beta cotangent as it is (pallas_grad.py:457-471).
//
// Design: one thread per lane, which takes its own e^beta as the TPU kernel
// does.  The JAX kernel keeps every layer's
// activations at all 69 points in VMEM; one thread cannot hold ~69 x 10
// values in registers, so the kernel keeps none of them.  The forward pass
// evaluates the network point by point inside the matrix-form RK4 and keeps
// only the residuals; the adjoint recursion writes the 69 weights to a small
// local array; the VJP pass recomputes each point's forward (4 + 4 tanhf and
// the head) and accumulates the gradient in 37 (41) registers and the beta
// cotangent in one.  The mean over individuals runs outside the kernel.
//
// Bound: latency.  The flagship refinement runs 25 restarts x 57
// individuals = 1,425 lanes: 23 blocks of 64 threads, one or two warps on
// 23 of the 132 SMs.  Each thread runs ~140 network evaluations in a
// dependent chain, so a launch costs the chain's latency (tens of
// microseconds), far above the card's arithmetic or memory bound; the
// launches sit between host-side optimizer steps.
//
// Numerics (cude_mlp.cuh): accurate tanhf/expf/log1pf, no contracted
// multiply-adds; the sigmoid is 1 / (1 + expf(-z)).  The operations and
// their order are those of
// conditional_ude_tpu_torch/ops/lane_grad.py::lane_sse_and_grad_reference.
//
// C interface (loaded with ctypes): lane_sse_and_grad (2 inputs) and
// lane_sse_and_grad_age (3 inputs) return cudaGetLastError() after the
// launch.  They allocate nothing and launch on the given stream.

#include "cude_mlp.cuh"

namespace {

using cude::kMaxTimepoints;
using cude::kWidth;
using cude::Mlp;

constexpr int kBlock = 64;
constexpr int kMaxSubsteps = 16;
constexpr int kMaxPoints = 1 + (kMaxTimepoints - 1) * (2 * kMaxSubsteps + 1);

struct GradSegment {
  float dt;         // RK4 step
  float c;          // dt / 6
  float half_c;     // c / 2
  float quarter_c;  // c / 4
  float two_c;      // 2 c
  float four_c;     // 4 c
};

struct GradGrid {
  int n_seg;
  int substeps;
  int j0;              // glucose knot left of t = 0
  float one_minus_w0;  // blend weights of glucose(0)
  float w0;
  float inv_2s;        // 1 / (2 substeps): the point spacing in a segment
  float half, sixth, t24;  // 1/2, 1/6, 1/24 of the RK4 polynomial
  GradSegment seg[kMaxTimepoints - 1];
};

// 2x2 matrices as (m11, m12, m21, m22)
struct M2 {
  float a, b, c, d;
};

__device__ __forceinline__ M2 mm(const M2& x, const M2& y) {
  return M2{x.a * y.a + x.b * y.c, x.a * y.b + x.b * y.d,
            x.c * y.a + x.d * y.c, x.c * y.b + x.d * y.d};
}

struct Stage {
  M2 r, ma, mmid;  // M_d is (c, 0, 0, c)
  float c;
};

__device__ __forceinline__ Stage stage_matrices(float k0, float k1, float k2,
                                                const GradSegment& s,
                                                const GradGrid& g) {
  const M2 b{s.dt * -(k0 + k2), s.dt * k1, s.dt * k2, s.dt * -k1};
  const M2 b2 = mm(b, b);
  const M2 b3 = mm(b2, b);
  const M2 b4 = mm(b3, b);
  Stage st;
  st.r = M2{1.0f + b.a + g.half * b2.a + g.sixth * b3.a + g.t24 * b4.a,
            0.0f + b.b + g.half * b2.b + g.sixth * b3.b + g.t24 * b4.b,
            0.0f + b.c + g.half * b2.c + g.sixth * b3.c + g.t24 * b4.c,
            1.0f + b.d + g.half * b2.d + g.sixth * b3.d + g.t24 * b4.d};
  st.ma = M2{s.c + s.c * b.a + s.half_c * b2.a + s.quarter_c * b3.a,
             0.0f + s.c * b.b + s.half_c * b2.b + s.quarter_c * b3.b,
             0.0f + s.c * b.c + s.half_c * b2.c + s.quarter_c * b3.c,
             s.c + s.c * b.d + s.half_c * b2.d + s.quarter_c * b3.d};
  st.mmid = M2{s.four_c + s.two_c * b.a + s.half_c * b2.a,
               0.0f + s.two_c * b.b + s.half_c * b2.b,
               0.0f + s.two_c * b.c + s.half_c * b2.c,
               s.four_c + s.two_c * b.d + s.half_c * b2.d};
  st.c = s.c;
  return st;
}

template <int In>
__global__ void __launch_bounds__(kBlock)
lane_sse_and_grad_kernel(const float* __restrict__ nn,       // [R, P]
                         const float* __restrict__ beta,     // [R * N]
                         const float* __restrict__ glucose,  // [N, K]
                         const float* __restrict__ data,     // [N, K]
                         const float* __restrict__ kinetics, // [N, 4|5]
                         float* __restrict__ sse_out,        // [R * N]
                         float* __restrict__ gnn_out,        // [R * N, P]
                         float* __restrict__ gb_out,         // [R * N]
                         long long lanes, int n_ind, const GradGrid grid) {
  const long long lane = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (lane >= lanes) return;
  const long long r = lane / n_ind;
  const int n = static_cast<int>(lane - r * n_ind);
  const int k_pts = grid.n_seg + 1;
  const int q_seg = 2 * grid.substeps + 1;
  const int n_pts = 1 + grid.n_seg * q_seg;

  using Net = Mlp<In>;
  constexpr int kParams = Net::kParams;
  constexpr int kKin = Net::kKin;
  Net mlp;
  mlp.load(nn + r * kParams);
  const float e_beta = expf(beta[lane]);
  float g[kMaxTimepoints], d[kMaxTimepoints];
  for (int j = 0; j < k_pts; ++j) {
    g[j] = glucose[n * k_pts + j];
    d[j] = data[n * k_pts + j];
  }
  const float* kin = kinetics + kKin * n;
  const float k0 = kin[0];
  const float k1 = kin[1];
  const float k2 = kin[2];
  const float c0 = kin[3];
  const float age = kKin == 5 ? kin[kKin - 1] : 0.0f;  // read by 3 inputs only
  const float g_at0 = grid.one_minus_w0 * g[grid.j0] + grid.w0 * g[grid.j0 + 1];
  const float kc = k0 * c0;

  // dG of evaluation point q (0: the baseline; 1 + s q_seg + j: point j of
  // segment s)
  auto dg_at = [&](int q) -> float {
    if (q == 0) return 0.0f;
    const int s = (q - 1) / q_seg;
    const int j = (q - 1) - s * q_seg;
    const float wq = static_cast<float>(j) * grid.inv_2s;
    return (1.0f - wq) * g[s] + wq * g[s + 1] - g_at0;
  };
  auto net = [&](float dg) -> float { return mlp(dg, e_beta, age); };

  // -- forward: matrix-form RK4 on the productions --------------------------
  const float base = net(0.0f);
  float res[kMaxTimepoints];
  float u1 = c0;
  float u2 = (k2 / k1) * u1;
  res[0] = u1 - d[0];
  for (int s = 0; s < grid.n_seg; ++s) {
    const Stage st = stage_matrices(k0, k1, k2, grid.seg[s], grid);
    const int bq = 1 + s * q_seg;
    float out_a = net(dg_at(bq));
    for (int i = 0; i < grid.substeps; ++i) {
      const float out_m = net(dg_at(bq + 2 * i + 1));
      const float out_d = net(dg_at(bq + 2 * i + 2));
      const float ra = kc + out_a - base;
      const float rm = kc + out_m - base;
      const float rd = kc + out_d - base;
      const float n1 = st.r.a * u1 + st.r.b * u2 + st.ma.a * ra + st.mmid.a * rm + st.c * rd;
      const float n2 = st.r.c * u1 + st.r.d * u2 + st.ma.c * ra + st.mmid.c * rm + 0.0f * rd;
      u1 = n1;
      u2 = n2;
      out_a = out_d;
    }
    res[s + 1] = u1 - d[s + 1];
  }
  float sse = res[0] * res[0];
  for (int s = 1; s < k_pts; ++s) sse = sse + res[s] * res[s];

  // -- adjoint recursion: the head weight of every evaluation point --------
  float w[kMaxPoints];
  float l1 = 0.0f, l2 = 0.0f;
  for (int s = grid.n_seg - 1; s >= 0; --s) {
    const Stage st = stage_matrices(k0, k1, k2, grid.seg[s], grid);
    const int bq = 1 + s * q_seg;
    l1 = l1 + 2.0f * res[s + 1];
    for (int i = grid.substeps - 1; i >= 0; --i) {
      w[bq + 2 * i] = st.ma.a * l1 + st.ma.c * l2;
      w[bq + 2 * i + 1] = st.mmid.a * l1 + st.mmid.c * l2;
      const float end = st.c * l1 + 0.0f * l2;
      w[bq + 2 * i + 2] = i == grid.substeps - 1 ? end : w[bq + 2 * i + 2] + end;
      const float nl1 = st.r.a * l1 + st.r.c * l2;
      const float nl2 = st.r.b * l1 + st.r.d * l2;
      l1 = nl1;
      l2 = nl2;
    }
  }
  float w_tot = w[1];
  for (int q = 2; q < n_pts; ++q) w_tot = w_tot + w[q];
  w[0] = -w_tot;

  // -- one hand VJP per point, accumulated in registers -------------------
  // offsets of the flat layout: W1 [4][In], b1, W2 [4][4], b2, w3, b3
  constexpr int kB1 = kWidth * In, kW2 = kB1 + kWidth;
  constexpr int kB2 = kW2 + kWidth * kWidth, kW3 = kB2 + kWidth;
  constexpr int kB3 = kW3 + kWidth;
  static_assert(kB3 + 1 == kParams, "flat layout");
  float gacc[kParams];
  float deb = 0.0f;
  for (int q = 0; q < n_pts; ++q) {
    const float x = dg_at(q);
    float h1[kWidth], h2[kWidth];
#pragma unroll
    for (int o = 0; o < kWidth; ++o) h1[o] = tanhf(mlp.z1(o, x, e_beta, age));
    mlp.layer2(h1, h2);
    const float z3 = mlp.z3(h2);
    const float dz3 = w[q] * (1.0f / (1.0f + expf(-z3)));
    float contrib[kParams];
    float dz2[kWidth], dz1[kWidth];
#pragma unroll
    for (int k = 0; k < kWidth; ++k) {
      contrib[kW3 + k] = dz3 * h2[k];
      dz2[k] = dz3 * mlp.w3[k] * (1.0f - h2[k] * h2[k]);
    }
    contrib[kB3] = dz3;
#pragma unroll
    for (int o = 0; o < kWidth; ++o) {
#pragma unroll
      for (int k = 0; k < kWidth; ++k) contrib[kW2 + kWidth * o + k] = dz2[o] * h1[k];
      contrib[kB2 + o] = dz2[o];
    }
#pragma unroll
    for (int k = 0; k < kWidth; ++k) {
      float dh = dz2[0] * mlp.w2[0][k];
#pragma unroll
      for (int o = 1; o < kWidth; ++o) dh = dh + dz2[o] * mlp.w2[o][k];
      dz1[k] = dh * (1.0f - h1[k] * h1[k]);
    }
    float dh_eb = dz1[0] * mlp.w1[0][1];
#pragma unroll
    for (int o = 0; o < kWidth; ++o) {
      contrib[In * o] = dz1[o] * x;
      contrib[In * o + 1] = dz1[o] * e_beta;
      if constexpr (In == 3) contrib[In * o + 2] = dz1[o] * age;
      contrib[kB1 + o] = dz1[o];
      if (o > 0) dh_eb = dh_eb + dz1[o] * mlp.w1[o][1];
    }
#pragma unroll
    for (int i = 0; i < kParams; ++i) gacc[i] = q == 0 ? contrib[i] : gacc[i] + contrib[i];
    deb = q == 0 ? dh_eb : deb + dh_eb;
  }

  sse_out[lane] = sse;
#pragma unroll
  for (int i = 0; i < kParams; ++i) gnn_out[lane * kParams + i] = gacc[i];
  gb_out[lane] = deb * e_beta;
}

template <int In>
int launch(const float* nn, const float* beta, const float* glucose,
           const float* data, const float* kinetics, float* sse, float* gnn,
           float* gb, long long lanes, int n_ind,
           const float* consts,  // host, see lane_grad.py
           int n_seg, int substeps, int j0, void* stream) {
  if (n_seg < 1 || n_seg > kMaxTimepoints - 1 || substeps < 1 ||
      substeps > kMaxSubsteps || j0 < 0 || j0 >= n_seg || n_ind < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes <= 0) return 0;
  GradGrid grid;
  grid.n_seg = n_seg;
  grid.substeps = substeps;
  grid.j0 = j0;
  grid.one_minus_w0 = consts[0];
  grid.w0 = consts[1];
  grid.inv_2s = consts[2];
  grid.half = consts[3];
  grid.sixth = consts[4];
  grid.t24 = consts[5];
  for (int s = 0; s < n_seg; ++s) {
    const float* c = consts + 6 + 6 * s;
    grid.seg[s] = GradSegment{c[0], c[1], c[2], c[3], c[4], c[5]};
  }
  const long long blocks = (lanes + kBlock - 1) / kBlock;
  lane_sse_and_grad_kernel<In><<<static_cast<unsigned int>(blocks), kBlock, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      nn, beta, glucose, data, kinetics, sse, gnn, gb, lanes, n_ind, grid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lane_sse_and_grad(const float* nn, const float* beta,
                                 const float* glucose, const float* data,
                                 const float* kinetics, float* sse,
                                 float* gnn, float* gb, long long lanes,
                                 int n_ind, const float* consts, int n_seg,
                                 int substeps, int j0, void* stream) {
  return launch<2>(nn, beta, glucose, data, kinetics, sse, gnn, gb, lanes,
                   n_ind, consts, n_seg, substeps, j0, stream);
}

extern "C" int lane_sse_and_grad_age(const float* nn, const float* beta,
                                     const float* glucose, const float* data,
                                     const float* kinetics, float* sse,
                                     float* gnn, float* gb, long long lanes,
                                     int n_ind, const float* consts, int n_seg,
                                     int substeps, int j0, void* stream) {
  return launch<3>(nn, beta, glucose, data, kinetics, sse, gnn, gb, lanes,
                   n_ind, consts, n_seg, substeps, j0, stream);
}
