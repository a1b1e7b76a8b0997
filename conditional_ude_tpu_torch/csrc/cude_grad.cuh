// Device code shared by the two value+gradient kernels (lane_grad.cu, one
// warp per (restart, individual) lane; population_grad.cu, one block per
// restart and a warp per individual): the matrix form of an RK4 step, the
// grid constants, the hand VJP of the network at one evaluation point, and
// warp_lane, which computes one lane with one warp.
//
// The production term does not depend on the state, so the c-peptide ODE is
// affine in it and one RK4 step is
//   v <- R v + M_a r(t) + M_mid r(t + dt/2) + M_d r(t + dt)
// with 2x2 stage matrices of the kinetics; r has a first component only, so
// the kernels use column 0 of each M, and M_d is (c, 0, 0, c).

#pragma once

#include "cude_mlp.cuh"

namespace cude {

constexpr int kWarp = 32;

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
  GridTable<GradSegment, kMaxTimepoints - 1> seg;
};
static_assert(sizeof(GradSegment) == 6 * sizeof(float), "a segment row");

// the GradGrid of the host constants [1 - w0, w0, 1/(2 substeps), 1/2, 1/6,
// 1/24] then per segment [dt, c, c/2, c/4, 2c, 4c] (ops/lane_grad.py,
// grid_constants), and for a long grid the same array in device memory
// (consts_dev); false when the arguments describe no grid the kernels take
inline bool make_grad_grid(const float* consts, const float* consts_dev,
                           int n_seg, int substeps, int j0, GradGrid* grid) {
  if (n_seg < 1 || (!kLongGrid && n_seg > kMaxTimepoints - 1) ||
      (kLongGrid && consts_dev == nullptr) || substeps < 1 || j0 < 0 ||
      j0 >= n_seg)
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
  fill_table(grid->seg, consts + 6, consts_dev == nullptr ? nullptr : consts_dev + 6,
             n_seg);
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
// [x, e_beta(, age)] and calls add(i, v) once for each parameter i of the
// flat layout with v = weight * d(softplus head)/d(parameter i), layer by
// layer from the head down.  Returns the cotangent of the e^beta input.  The
// age is an input, not a parameter: it adds dz1[o] * age to W1[o][2]'s
// entry and nothing else.  A hidden layer's cotangent is
// dz[k] = (sum_o dz_next[o] W_next[o][k], left to right) * (1 - h[k]^2).
template <int L, int In, class Add>
__device__ __forceinline__ float vjp_from(const Mlp<In>& mlp, const float* x,
                                          const float* h, const float* dz,
                                          Add& add) {
  using Net = typename Mlp<In>::Net;
  constexpr int fi = Net::fan_in(L), fo = Net::fan_out(L);
  constexpr int off = Net::offset(L);
  constexpr int kOuterO = outer_unroll<fi, fo>(fo);
  constexpr int kOuterK = outer_unroll<fi, fo>(fi);
  const float* a;  // the layer's inputs
  if constexpr (L == 0)
    a = x;
  else
    a = h + Net::unit(L - 1);
#pragma unroll (kOuterO)
  for (int o = 0; o < fo; ++o) {
#pragma unroll
    for (int k = 0; k < fi; ++k) add(off + fi * o + k, dz[o] * a[k]);
    add(off + fi * fo + o, dz[o]);
  }
  if constexpr (L == 0) {
    float dh_eb = dz[0] * mlp.w(off + 1);
#pragma unroll
    for (int o = 1; o < fo; ++o) dh_eb = dh_eb + dz[o] * mlp.w(off + fi * o + 1);
    return dh_eb;
  } else {
    float dprev[fi];
#pragma unroll (kOuterK)
    for (int k = 0; k < fi; ++k) {
      float dh = dz[0] * mlp.w(off + k);
#pragma unroll
      for (int o = 1; o < fo; ++o) dh = dh + dz[o] * mlp.w(off + fi * o + k);
      dprev[k] = dh * (1.0f - a[k] * a[k]);
    }
    return vjp_from<L - 1>(mlp, x, h, dprev, add);
  }
}

template <int In, class Add>
__device__ __forceinline__ float point_vjp(const Mlp<In>& mlp, float x,
                                           float e_beta, float age,
                                           float weight, Add add) {
  float in[In];
  in[0] = x;
  in[1] = e_beta;
  if constexpr (In == 3) in[2] = age;
  float h[Mlp<In>::kUnits];
  const float z = mlp.hidden(x, e_beta, age, h);
  const float dz = weight * (1.0f / (1.0f + expf(-z)));
  return vjp_from<Mlp<In>::kLayers - 1>(mlp, in, h, &dz, add);
}

// -- one lane per warp -----------------------------------------------------
//
// warp_lane computes the SSE of one (restart, individual) lane, the gradient
// of its P weights and the cotangent of its e^beta with the 32 threads
// of a warp.  The lane's 1 + n_seg (2 substeps + 1) evaluation points (69 on
// the OGTT grid) do not depend on the state, so they are spread across the
// threads; only the two 2x2 affine recursions are sequential.
//   1. Thread t computes the stage matrices of segments t, t + 32, ...; thread t
//      evaluates the network at points q = t, t + 32, t + 64, ... (point 0
//      is the dG = 0 baseline, point 1 + s q_seg + j point j of segment s).
//   2. Every thread runs the forward recursion from shared memory, in the
//      arithmetic and order of the one-thread kernel (ra = kc + out_a - base;
//      the SSE summed over the residuals first to last).
//   3. Every thread runs the adjoint recursion; the point weights overwrite
//      the network outputs in shared memory, w_tot sums them first to last,
//      and the baseline's weight is -w_tot.
//   4. Thread t runs the recomputing hand VJP at its own points, summing its
//      contributions in increasing q into a partial row that starts at 0:
//      in registers where the weights are (P <= kRegisterParams), else in
//      the thread's own row of shared memory, since P partial sums, P
//      weights and the activations would not fit a thread's registers.
//   5. The warp sums the 32 partial rows of the P weights and the e^beta
//      cotangent in one fixed order: each thread writes its row to shared
//      memory (where it is not there already), and thread c sums column c
//      over the rows 0..31 one after another (ops/lane_grad.py::lane_sum
//      follows this order).  On the H100 this beat a butterfly of
//      __shfl_xor_sync on every shape timed.
// The P + 1 columns of steps 4 and 5 are taken in passes of at most
// kPassColumns (every column at once up to 127 weights), each pass running
// the VJPs again and keeping only its own columns, so a warp's partial rows
// take at most 32 (kPassColumns + 1) floats of shared memory whatever the
// network's width.  A column's sum is the same in any pass, so the order is
// lane_sum's for every width.  Every thread takes part in every step, so a
// caller never lets a part of a warp leave early.

constexpr int kStageFloats = 13;  // r, ma, mmid (4 each) and c
constexpr int kPassColumns = 128;

// columns of the gradient (the P weights, then the e^beta cotangent) one
// pass of steps 4 and 5 sums: all P + 1 of them in registers or up to
// kPassColumns, else kPassColumns
template <int In>
__host__ __device__ constexpr int pass_columns() {
  constexpr int cols = Mlp<In>::kParams + 1;
  return Mlp<In>::kInRegisters || cols <= kPassColumns ? cols : kPassColumns;
}

template <int In>
__host__ __device__ constexpr int passes() {
  return (Mlp<In>::kParams + pass_columns<In>()) / pass_columns<In>();
}

// floats from one partial row to the next: an odd number, so 32 threads
// writing one column each hit 32 banks
template <int In>
__host__ __device__ constexpr int sum_stride() {
  return pass_columns<In>() | 1;
}

// floats of a lane's row of save-time values (the residuals; lane_grad.cu's
// glucose and data rows): kMaxTimepoints for a short grid, as many as the
// grid has points for a long one
__host__ __device__ inline int time_row_floats(int n_seg) {
  return kLongGrid ? n_seg + 1 : kMaxTimepoints;
}

// floats of shared memory one warp_lane call needs: the residuals, the stage
// matrices, and a row that holds the network outputs, then the point
// weights, then (with the partial sums in registers) the 32 partial rows of
// the sum; with the partial sums in shared memory the 32 rows follow the
// point weights, since they fill while the weights are read.  The row grows
// with the grid's points and substeps, n_pts = 1 + n_seg (2 substeps + 1);
// the kernels take fewer warps a block where their scratch would not fit
// (long long: no count of points or substeps overflows it)
template <int In>
inline long long warp_scratch_floats(int n_seg, int substeps) {
  const long long n_pts = 1 + static_cast<long long>(n_seg) * (2LL * substeps + 1);
  const long long rows = kWarp * sum_stride<In>();
  const long long row = Mlp<In>::kInRegisters ? (n_pts > rows ? n_pts : rows)
                                              : n_pts + rows;
  return time_row_floats(n_seg) + kStageFloats * static_cast<long long>(n_seg) + row;
}

__device__ __forceinline__ void store_stage(float* p, const Stage& st) {
  p[0] = st.r.a, p[1] = st.r.b, p[2] = st.r.c, p[3] = st.r.d;
  p[4] = st.ma.a, p[5] = st.ma.b, p[6] = st.ma.c, p[7] = st.ma.d;
  p[8] = st.mmid.a, p[9] = st.mmid.b, p[10] = st.mmid.c, p[11] = st.mmid.d;
  p[12] = st.c;
}

__device__ __forceinline__ Stage load_stage(const float* p) {
  Stage st;
  st.r = M2{p[0], p[1], p[2], p[3]};
  st.ma = M2{p[4], p[5], p[6], p[7]};
  st.mmid = M2{p[8], p[9], p[10], p[11]};
  st.c = p[12];
  return st;
}

// One lane with one warp (see above).  g and d are the individual's glucose
// and data rows in shared memory, kin its kinetics row (k0, k1, k2, c0[,
// age]), scratch the warp's warp_scratch_floats<In> floats of shared memory.
// Runs the passes first_pass..end_pass - 1 of steps 4 and 5 (all of them
// are 0..passes<In>() - 1).  Returns the lane's SSE in every thread;
// emit(c, v) is called once for each column c of those passes, by one
// thread: v is the gradient of weight c, or for c = P the e^beta cotangent
// (the beta gradient is v e^beta).
template <int In, class Emit>
__device__ __forceinline__ float warp_lane(const Mlp<In>& mlp, float e_beta,
                                           const float* g, const float* d,
                                           const float* kin,
                                           const GradGrid& grid,
                                           float* scratch, int first_pass,
                                           int end_pass, Emit emit) {
  constexpr int kParams = Mlp<In>::kParams;
  constexpr int kKin = Mlp<In>::kKin;
  const int t = threadIdx.x & (kWarp - 1);
  const int q_seg = 2 * grid.substeps + 1;
  const int n_pts = 1 + grid.n_seg * q_seg;
  float* res = scratch;                                // [time_row_floats]
  float* stages = res + time_row_floats(grid.n_seg);  // [n_seg][kStageFloats]
  float* row = stages + kStageFloats * grid.n_seg;
  const float k0 = kin[0];
  const float k1 = kin[1];
  const float k2 = kin[2];
  const float c0 = kin[3];
  const float age = kKin == 5 ? kin[kKin - 1] : 0.0f;  // read by 3 inputs only
  const float g_at0 = grid.one_minus_w0 * g[grid.j0] + grid.w0 * g[grid.j0 + 1];
  const float kc = k0 * c0;

  // dG of evaluation point q
  auto dg_at = [&](int q) -> float {
    if (q == 0) return 0.0f;
    const int s = (q - 1) / q_seg;
    const int j = (q - 1) - s * q_seg;
    const float wq = static_cast<float>(j) * grid.inv_2s;
    return (1.0f - wq) * g[s] + wq * g[s + 1] - g_at0;
  };

  // -- 1. stage matrices and the network at every point, across the warp --
  for (int sg = t; sg < grid.n_seg; sg += kWarp)
    store_stage(stages + kStageFloats * sg, stage_matrices(k0, k1, k2, grid.seg[sg], grid));
  for (int q = t; q < n_pts; q += kWarp) row[q] = mlp(dg_at(q), e_beta, age);
  __syncwarp();

  // -- 2. forward: matrix-form RK4 on the productions ----------------------
  const float base = row[0];
  float u1 = c0;
  float u2 = (k2 / k1) * u1;
  const float r0 = u1 - d[0];
  float sse = r0 * r0;
  for (int s = 0; s < grid.n_seg; ++s) {
    const Stage st = load_stage(stages + kStageFloats * s);
    const int bq = 1 + s * q_seg;
    float out_a = row[bq];
    for (int i = 0; i < grid.substeps; ++i) {
      const float out_m = row[bq + 2 * i + 1];
      const float out_d = row[bq + 2 * i + 2];
      const float ra = kc + out_a - base;
      const float rm = kc + out_m - base;
      const float rd = kc + out_d - base;
      const float n1 = st.r.a * u1 + st.r.b * u2 + st.ma.a * ra + st.mmid.a * rm + st.c * rd;
      const float n2 = st.r.c * u1 + st.r.d * u2 + st.ma.c * ra + st.mmid.c * rm + 0.0f * rd;
      u1 = n1;
      u2 = n2;
      out_a = out_d;
    }
    const float rs = u1 - d[s + 1];
    res[s + 1] = rs;
    sse = sse + rs * rs;
  }
  __syncwarp();

  // -- 3. adjoint recursion: the head weight of every point ----------------
  float l1 = 0.0f, l2 = 0.0f;
  for (int s = grid.n_seg - 1; s >= 0; --s) {
    const Stage st = load_stage(stages + kStageFloats * s);
    const int bq = 1 + s * q_seg;
    l1 = l1 + 2.0f * res[s + 1];
    float w_a = 0.0f;  // the start weight of substep i + 1, the same point
    for (int i = grid.substeps - 1; i >= 0; --i) {
      const float end = st.c * l1 + 0.0f * l2;
      row[bq + 2 * i + 2] = i == grid.substeps - 1 ? end : w_a + end;
      row[bq + 2 * i + 1] = st.mmid.a * l1 + st.mmid.c * l2;
      w_a = st.ma.a * l1 + st.ma.c * l2;
      const float nl1 = st.r.a * l1 + st.r.c * l2;
      const float nl2 = st.r.b * l1 + st.r.d * l2;
      l1 = nl1;
      l2 = nl2;
    }
    row[bq] = w_a;
  }
  __syncwarp();
  float w_tot = row[1];
  for (int q = 2; q < n_pts; ++q) w_tot = w_tot + row[q];

  // -- 4. one hand VJP per point, each thread its own points ---------------
  constexpr bool kRegSums = Mlp<In>::kInRegisters;
  constexpr int kCols = pass_columns<In>();
  constexpr int kStride = sum_stride<In>();
  float* rows = kRegSums ? row : row + n_pts;  // the 32 partial rows
  float* mine = rows + t * kStride;
  for (int pass = first_pass; pass < end_pass; ++pass) {
    const int lo = pass * kCols;  // the pass's columns are lo..hi - 1
    const int hi = lo + kCols < kParams + 1 ? lo + kCols : kParams + 1;
    float acc[kRegSums ? kParams : 1];
    if constexpr (kRegSums) {
#pragma unroll
      for (int i = 0; i < kParams; ++i) acc[i] = 0.0f;
    } else {
      for (int i = 0; i < hi - lo; ++i) mine[i] = 0.0f;
    }
    float deb = 0.0f;
    for (int q = t; q < n_pts; q += kWarp) {
      const float wq = q == 0 ? -w_tot : row[q];
      const float dh_eb = point_vjp<In>(
          mlp, dg_at(q), e_beta, age, wq, [&](int i, float v) {
            if constexpr (kRegSums)
              acc[i] = acc[i] + v;
            else if constexpr (kCols == kParams + 1)
              mine[i] = mine[i] + v;
            else if (i >= lo && i < hi)
              mine[i - lo] = mine[i - lo] + v;
          });
      deb = deb + dh_eb;
    }
    __syncwarp();  // every weight is read before the rows overwrite them

    // -- 5. the sum across the warp, in one fixed order --------------------
    if constexpr (kRegSums) {
#pragma unroll
      for (int i = 0; i < kParams; ++i) mine[i] = acc[i];
    }
    if (hi == kParams + 1) mine[kParams - lo] = deb;
    __syncwarp();
    for (int c = t; c < hi - lo; c += kWarp) {
      float sum = rows[c];
      for (int k = 1; k < kWarp; ++k) sum = sum + rows[k * kStride + c];
      emit(lo + c, sum);
    }
    __syncwarp();  // the scratch is free for the next pass or lane
  }
  return sse;
}

}  // namespace cude
