// Device code shared by the two RK4 SSE kernels, rk4_cohort.cu (K4) and
// rk4_population.cu (K1), each a lane on one thread: where a lane evaluates
// its network, and the explicit RK4 recursion that takes those values.
//
// The production term MLP([dG(t), e^beta(, age)]) - MLP([0, e^beta(, age)])
// does not depend on the state (cude_grad.cuh), so a lane needs the network
// only at the 1 + n_seg (2 substeps + 1) points that K2 and K5 evaluate:
// point 0 is the baseline dG = 0, and point j of segment s lies at
// w = j / (2 substeps) of the segment, dG = (1 - w) g[s] + w g[s + 1] - g(0).
// RK4 step i of a segment takes points 2i, 2i + 1 and 2i + 2: stages 2 and 3
// share the middle one, and the last is the next step's first.  That is 69
// network evaluations a lane on the OGTT grid at 8 substeps, the baseline
// included, where evaluating the right-hand side at each of the four stages
// took 128 + 1.  The network is Mlp's operator(), the one K2's forward calls,
// so every kernel of the port evaluates it at the same points in the same
// order; at dG = 0 its layer 1 is (w1[o][1] e^beta) + b1[o] for 2 inputs,
// the sum the JAX screen kernel hoists (pallas_rk4.py:290-293).
//
// The stage arithmetic is that of the JAX kernels (pallas_rk4.py:145-161):
// d1 = -(k0 + k2) v1 + k1 v2 + k0 c0 + p, d2 = -k1 v2 + k2 v1 at the stage
// points u + dt/2 a, u + dt/2 b, u + dt c, then u + dt/6 (a + 2b + 2c + e),
// each sum left to right.  The plain versions
// (ops/rk4_cohort.py::rk4_point_sse) follow it operation for operation.

#pragma once

#include "cude_mlp.cuh"

namespace cude {

// glucose at t = 0, the origin of dG
__device__ __forceinline__ float glucose_at0(const float* g, const Grid& grid) {
  return grid.one_minus_w0 * g[grid.j0] + grid.w0 * g[grid.j0 + 1];
}

// dG at point j of segment s, in the arithmetic of K2's points
__device__ __forceinline__ float point_dg(const float* g, float g_at0,
                                          const Grid& grid, int s, int j) {
  const float w = static_cast<float>(j) * grid.inv_2s;
  return (1.0f - w) * g[s] + w * g[s + 1] - g_at0;
}

// The lane's SSE against its data d at the save points: explicit RK4 of
// u1' = -(k0 + k2) u1 + k1 u2 + k0 c0 + p(t), u2' = -k1 u2 + k2 u1 from
// u = (c0, k2/k1 c0).  prod(s, j) is the production at point j of segment s;
// it is called once for each point, in increasing order.
template <class Prod>
__device__ __forceinline__ float rk4_sse(const float* d, const float* kin,
                                         const Grid& grid, Prod prod) {
  const float k0 = kin[0];
  const float k1 = kin[1];
  const float k2 = kin[2];
  const float c0 = kin[3];
  const float decay = -(k0 + k2);
  const float inflow = k0 * c0;
  const float neg_k1 = -k1;
  auto rhs1 = [&](float v1, float v2, float p) {
    return decay * v1 + k1 * v2 + inflow + p;
  };
  auto rhs2 = [&](float v1, float v2) { return neg_k1 * v2 + k2 * v1; };

  float u1 = c0;
  float u2 = (k2 / k1) * u1;
  const float r0 = u1 - d[0];
  float sse = r0 * r0;
  for (int s = 0; s < grid.n_seg; ++s) {
    const Segment sg = grid.seg[s];
    float pa = prod(s, 0);
    for (int i = 0; i < grid.substeps; ++i) {
      const float pm = prod(s, 2 * i + 1);
      const float pe = prod(s, 2 * i + 2);
      const float a1 = rhs1(u1, u2, pa);
      const float a2 = rhs2(u1, u2);
      float v1 = u1 + sg.half_dt * a1;
      float v2 = u2 + sg.half_dt * a2;
      const float b1 = rhs1(v1, v2, pm);
      const float b2 = rhs2(v1, v2);
      v1 = u1 + sg.half_dt * b1;
      v2 = u2 + sg.half_dt * b2;
      const float c1 = rhs1(v1, v2, pm);
      const float c2 = rhs2(v1, v2);
      v1 = u1 + sg.dt * c1;
      v2 = u2 + sg.dt * c2;
      const float e1 = rhs1(v1, v2, pe);
      const float e2 = rhs2(v1, v2);
      u1 = u1 + sg.sixth_dt * (a1 + 2.0f * b1 + 2.0f * c1 + e1);
      u2 = u2 + sg.sixth_dt * (a2 + 2.0f * b2 + 2.0f * c2 + e2);
      pa = pe;
    }
    const float res = u1 - d[s + 1];
    sse = sse + res * res;
  }
  return sse;
}

// One lane on one thread: the network at each point when the recursion
// reaches it.  g and d are the lane's glucose and data rows, kin its
// kinetics row (k0, k1, k2, c0[, age]).
template <int In>
__device__ __forceinline__ float lane_sse(const Mlp<In>& mlp, float e_beta,
                                          const float* g, const float* d,
                                          const float* kin, const Grid& grid) {
  constexpr int kKin = Mlp<In>::kKin;
  const float age = kKin == 5 ? kin[kKin - 1] : 0.0f;  // read by 3 inputs only
  const float base = mlp(0.0f, e_beta, age);
  const float g_at0 = glucose_at0(g, grid);
  return rk4_sse(d, kin, grid, [&](int s, int j) {
    return mlp(point_dg(g, g_at0, grid, s, j), e_beta, age) - base;
  });
}

}  // namespace cude
