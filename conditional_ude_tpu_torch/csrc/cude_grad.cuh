// Device code shared by the two value+gradient kernels (lane_grad.cu, one
// thread per (restart, individual) lane; population_grad.cu, one thread per
// restart): the matrix form of an RK4 step, the grid constants, and the hand
// VJP of the network at one evaluation point.
//
// The production term does not depend on the state, so the c-peptide ODE is
// affine in it and one RK4 step is
//   v <- R v + M_a r(t) + M_mid r(t + dt/2) + M_d r(t + dt)
// with 2x2 stage matrices of the kinetics; r has a first component only, so
// the kernels use column 0 of each M, and M_d is (c, 0, 0, c).

#pragma once

#include "cude_mlp.cuh"

namespace cude {

constexpr int kMaxSubsteps = 16;

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

// the GradGrid of the host constants [1 - w0, w0, 1/(2 substeps), 1/2, 1/6,
// 1/24] then per segment [dt, c, c/2, c/4, 2c, 4c] (ops/lane_grad.py,
// grid_constants); false when the arguments describe no grid the kernels take
inline bool make_grad_grid(const float* consts, int n_seg, int substeps, int j0,
                           GradGrid* grid) {
  if (n_seg < 1 || n_seg > kMaxTimepoints - 1 || substeps < 1 ||
      substeps > kMaxSubsteps || j0 < 0 || j0 >= n_seg)
    return false;
  grid->n_seg = n_seg;
  grid->substeps = substeps;
  grid->j0 = j0;
  grid->one_minus_w0 = consts[0];
  grid->w0 = consts[1];
  grid->inv_2s = consts[2];
  grid->half = consts[3];
  grid->sixth = consts[4];
  grid->t24 = consts[5];
  for (int s = 0; s < n_seg; ++s) {
    const float* c = consts + 6 + 6 * s;
    grid->seg[s] = GradSegment{c[0], c[1], c[2], c[3], c[4], c[5]};
  }
  return true;
}

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

// Hand VJP of the network at one evaluation point: recomputes the forward at
// [x, e_beta(, age)] and writes weight * d(softplus head)/d(each parameter)
// to contrib[kParams] in the flat layout (W1 [4][In], b1, W2 [4][4], b2, w3,
// b3).  Returns the cotangent of the e^beta input.  The age is an input, not
// a parameter: it adds dz1[o] * age to w1[o][2]'s entry and nothing else.
template <int In>
__device__ __forceinline__ float point_vjp(const Mlp<In>& mlp, float x,
                                           float e_beta, float age,
                                           float weight,
                                           float contrib[Mlp<In>::kParams]) {
  constexpr int kB1 = kWidth * In, kW2 = kB1 + kWidth;
  constexpr int kB2 = kW2 + kWidth * kWidth, kW3 = kB2 + kWidth;
  constexpr int kB3 = kW3 + kWidth;
  static_assert(kB3 + 1 == Mlp<In>::kParams, "flat layout");
  float h1[kWidth], h2[kWidth];
#pragma unroll
  for (int o = 0; o < kWidth; ++o) h1[o] = tanhf(mlp.z1(o, x, e_beta, age));
  mlp.layer2(h1, h2);
  const float z3 = mlp.z3(h2);
  const float dz3 = weight * (1.0f / (1.0f + expf(-z3)));
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
  return dh_eb;
}

}  // namespace cude
