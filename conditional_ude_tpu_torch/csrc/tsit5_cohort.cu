// Adaptive Tsit5 solve + SSE per (restart, individual) lane (the final
// re-rank of joint cUDE training), for Hopper (sm_90a).
//
// Replaces the TPU kernel conditional_ude_tpu/ops/pallas_tsit5.py::_build_kernel
// (reached through cohort_sse_tsit5_pallas / screen_population_tsit5_pallas),
// both of its bodies, at every network it takes (cude_mlp.cuh): P weights on
// [dG, e^beta] or, for the covariate model, on [dG, e^beta, age] (the age is
// the 5th column of the individual's kinetics row, an input at every stage;
// 37 and 41 weights for the canonical chain(4, 2)).  The canonical
// network's weights live in a thread's registers, a wider network's are
// read from device memory (through L1) where they are used.
// Every lane integrates its 2-state c-peptide ODE with the Tsitouras 5(4)
// pair: FSAL, a PI step-size controller, Hairer's initial step, rtol/atol
// scaled error norm, at most max_steps steps.  Each accepted step that
// crosses a save time adds that residual to the lane's SSE through the free
// interpolant.  A non-finite state or a step below 1e-10 of the span fails
// the lane: ok = false and SSE = +inf.
//
// Design: one thread per lane; each lane has its own step sequence, which
// suits SIMT threads better than the TPU's lockstep vector rows, and a lane
// leaves its loop once it is done or failed (a masked step changes
// nothing).  The network's input does not depend on the ODE state, so an
// attempted step first evaluates the production at its five stage times
// t + c_s * dtc, s = 2..6, as five independent chains (stage 7's time
// t + dtc is stage 6's, c6 = c7 = 1, so it takes that production), then
// runs the stages' 2-state recurrence on them.  The glucose at a time comes
// from its one segment, the last knot at or before it; the knots, spans and
// the lane's glucose and data rows live in shared memory (no local-memory
// stack).  e^beta is taken in the kernel.  The controller takes one powf
// per attempted step (the accepted or the rejected exponent) and one per
// accepted step (the next step's err_prev term), and an accepted step looks
// at the save times from the lane's next one on.
//
// Bound: latency at the re-rank's 1,425 lanes (12 blocks of 128 threads,
// each warp alone on its scheduler): the time is the longest lane's ~40
// steps, each a chain of basic blocks that cannot overlap (the lookups'
// five correctly rounded divisions, each with its slow-path branch; the
// five evaluations, ~1,000 instructions with 85 MUFU; the stages; the
// error norm's two divisions and sqrtf; the controller's powf).  At 131,328
// lanes instruction issue: ~1,950 instructions a step on 16 warps an SM.
// The bytes (a few dozen a lane) and the arithmetic bound are far below
// either.  __launch_bounds__(kBlock, 4) lets ptxas take up to 128
// registers: without a minimum of blocks it held the kernel at 96 and
// issued the five evaluations nearly one after another.
//
// Numerics (cude_mlp.cuh): accurate tanhf/expf/log1pf/powf/sqrtf, no
// contracted multiply-adds; maximum/minimum/clip propagate NaN as
// jnp.maximum and torch.maximum do.  The operations and their order are
// those of conditional_ude_tpu_torch/ops/tsit5_cohort.py::cohort_sse_tsit5_reference;
// evaluating the productions first changes when a value is computed, not
// how.  Accept/reject decisions sit on err <= 1, so one ulp can change a
// lane's step sequence: each body equals its plain version bit for bit.
//
// A grid of more than 16 points (the long-grid library, cude_mlp.cuh)
// reads its knots and spans and each lane's glucose and data rows from
// device memory where they are used; the arithmetic is the same.
//
// C interface (loaded with ctypes): tsit5_cohort_sse (2 inputs) and
// tsit5_cohort_sse_age (3 inputs) take beta (not e^beta) and the constants
// on the host and, for a long-grid library, in device memory, and return
// cudaGetLastError() after the launch.  They allocate nothing and launch on
// the given stream.

#include <string.h>

#include "cude_mlp.cuh"

namespace {

using cude::kMaxTimepoints;
using cude::Mlp;

constexpr int kBlock = 128;
constexpr int kStages = 5;                 // productions an attempted step
constexpr int kRow = kMaxTimepoints + 1;   // odd row stride: no bank conflicts

// the host array of tsit5_cohort.py::constants, field by field: for a
// short grid the knots and spans padded to kMaxTimepoints are copied here;
// a long grid's are read from the caller's copy of the array in device
// memory (cude_mlp.cuh, CUDE_LONG_GRID)
constexpr int kHeadFloats = 7 + 7 * 6 + 7 + 22;
constexpr int kScalarFloats = 20;
struct Tsit5Consts {
  float c[7];
  float a[7][6];
  float btilde[7];
  float interp[22];
  cude::GridTable<float, kMaxTimepoints> knot;
  cude::GridTable<float, kMaxTimepoints> span;
  float one_minus_w0, w0, t0, t1, t_span, rtol, atol, tenth_span,
      dt_fallback, dt_min, dt_floor, end_tol, save_slack, safety, neg_beta1,
      beta2, neg_inv_order, h1_exp, fmin, fmax;
};
static_assert(cude::kLongGrid ||
                  sizeof(Tsit5Consts) == 130 * sizeof(float),
              "layout of constants()");

// NaN-propagating maximum / minimum / clip, as jnp.maximum and torch.maximum
__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}

__device__ __forceinline__ void interp_coeffs(const float* c, float t, float b[7]) {
  const float t2 = t * t;
  b[0] = c[0] * t * (t - c[1]) * (t2 - c[2] * t + c[3]);
  b[1] = c[4] * t2 * (t2 - c[5] * t + c[6]);
  b[2] = c[7] * t2 * (t2 - c[8] * t + c[9]);
  b[3] = c[10] * (t - c[11]) * (t - c[12]) * t2;
  b[4] = c[13] * (t - c[14]) * (t - c[15]) * t2;
  b[5] = c[16] * (t - c[17]) * (t - c[18]) * t2;
  b[6] = c[19] * (t - c[20]) * (t - c[21]) * t2;
}

__device__ __forceinline__ float rms2(float a1, float a2, float s1, float s2) {
  const float x1 = a1 / s1, x2 = a2 / s2;
  return sqrtf(0.5f * (x1 * x1 + x2 * x2) + 1e-30f);
}

// The productions MLP(dG, e^beta(, age)) - base at the times ts[]: glucose
// from each time's one segment, the last j with t >= knot[j] (g[0] below
// the first knot), by ops/tsit5_cohort.py::glucose_at's operations; one
// pass over the knots serves all N times, and the N networks are
// independent chains.
template <int In, int N>
__device__ __forceinline__ void productions(
    const Mlp<In>& mlp, const float (&ts)[N], float (&out)[N],
    const float* knot, const float* span, const float* g, int n_seg,
    float g_at0, float e_beta, float age, float base) {
  int seg[N];
#pragma unroll
  for (int q = 0; q < N; ++q) seg[q] = 0;
  for (int i = 1; i < n_seg; ++i) {
    const float kv = knot[i];
#pragma unroll
    for (int q = 0; q < N; ++q) seg[q] = ts[q] >= kv ? i : seg[q];
  }
  float dg[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const int j = seg[q];
    const float w = jclip((ts[q] - knot[j]) / span[j], 0.0f, 1.0f);
    const float blend = (1.0f - w) * g[j] + w * g[j + 1];
    dg[q] = (ts[q] >= knot[0] ? blend : g[0]) - g_at0;
  }
#pragma unroll
  for (int q = 0; q < N; ++q) out[q] = mlp(dg[q], e_beta, age) - base;
}

template <int In>
__global__ void __launch_bounds__(kBlock, 4)
tsit5_cohort_sse_kernel(const float* __restrict__ nn,       // [R, P]
                        const float* __restrict__ beta,     // [R * N]
                        const float* __restrict__ glucose,  // [N, K]
                        const float* __restrict__ data,     // [N, K]
                        const float* __restrict__ kinetics, // [N, 4|5]
                        float* __restrict__ sse_out,        // [R * N]
                        bool* __restrict__ ok_out,          // [R * N]
                        long long lanes, int n_ind, int n_save, int j0,
                        int max_steps, const Tsit5Consts k) {
  // a short grid's knots, spans and each lane's glucose and data rows in
  // shared memory; a long grid's read from device memory where used
  constexpr int kRows = cude::kLongGrid ? 1 : kBlock;
  __shared__ float s_knot[kMaxTimepoints], s_span[kMaxTimepoints];
  __shared__ float s_g[kRows][kRow], s_d[kRows][kRow];
  const long long lane = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x;
  const long long r = lane / n_ind;
  const int n = static_cast<int>(lane - r * n_ind);
  const float* knot = s_knot;
  const float* span = s_span;
  const float* g = glucose + static_cast<long long>(n) * n_save;
  const float* d = data + static_cast<long long>(n) * n_save;
  if constexpr (cude::kLongGrid) {
    knot = k.knot;
    span = k.span;
    if (lane >= lanes) return;
  } else {
    if (threadIdx.x < kMaxTimepoints) {
      s_knot[threadIdx.x] = k.knot[threadIdx.x];
      s_span[threadIdx.x] = k.span[threadIdx.x];
    }
    float* sg = s_g[threadIdx.x];
    float* sd = s_d[threadIdx.x];
    if (lane < lanes) {
      for (int j = 0; j < n_save; ++j) {
        sg[j] = glucose[static_cast<long long>(n) * n_save + j];
        sd[j] = data[static_cast<long long>(n) * n_save + j];
      }
    }
    __syncthreads();
    if (lane >= lanes) return;
    g = sg;
    d = sd;
  }

  using Net = Mlp<In>;
  constexpr int kKin = Net::kKin;
  Net mlp;
  mlp.load(nn + r * Net::kParams);
  const float e_beta = expf(beta[lane]);
  const float* kin = kinetics + kKin * n;
  const float k0 = kin[0];
  const float k1 = kin[1];
  const float k2 = kin[2];
  const float c0 = kin[3];
  const float age = kKin == 5 ? kin[kKin - 1] : 0.0f;  // read by 3 inputs only
  const float base = mlp(0.0f, e_beta, age);
  const float g_at0 = k.one_minus_w0 * g[j0] + k.w0 * g[j0 + 1];
  const int n_seg = n_save - 1;

  auto production = [&](float t) -> float {
    const float ts[1] = {t};
    float out[1];
    productions(mlp, ts, out, knot, span, g, n_seg, g_at0, e_beta, age,
                base);
    return out[0];
  };
  // the kinetics at a stage, in the plain version's order
  auto rhs_a = [&](float v1, float v2, float prod) {
    return -(k0 + k2) * v1 + k1 * v2 + k0 * c0 + prod;
  };
  auto rhs_b = [&](float v1, float v2) { return -k1 * v2 + k2 * v1; };

  // Hairer's initial step
  float u1 = c0;
  float u2 = (k2 / k1) * c0;
  float t = k.t0;
  float ka[7], kb[7];
  ka[0] = rhs_a(u1, u2, production(t));
  kb[0] = rhs_b(u1, u2);
  const float s1 = k.atol + k.rtol * fabsf(u1);
  const float s2 = k.atol + k.rtol * fabsf(u2);
  const float d0 = rms2(u1, u2, s1, s2);
  const float dn1 = rms2(ka[0], kb[0], s1, s2);
  const bool small = (d0 < 1e-5f) || (dn1 < 1e-5f);
  float h0 = small ? 1e-6f : 0.01f * d0 / (dn1 == 0.0f ? 1.0f : dn1);
  h0 = jmin(h0, k.tenth_span);
  const float y2a = u1 + h0 * ka[0], y2b = u2 + h0 * kb[0];
  const float f2a = rhs_a(y2a, y2b, production(t + h0));
  const float f2b = rhs_b(y2a, y2b);
  const float dn2 = rms2(f2a - ka[0], f2b - kb[0], s1, s2) / h0;
  const float dmax = jmax(dn1, dn2);
  const float h1 = dmax <= 1e-15f ? jmax(1e-6f, h0 * 1e-3f)
                                  : powf(0.01f / dmax, k.h1_exp);
  float dt = jmin(100.0f * h0, jmin(h1, k.t_span));
  dt = (isfinite(dt) && dt > 0.0f) ? dt : k.dt_fallback;

  const float r0 = u1 - d[0];
  float sse = r0 * r0;
  float err_prev = 1.0f;
  float pw_prev = powf(err_prev, k.beta2);   // the accepted factor's memory
  int next_save = 1;      // the first save time after t (the knots increase)
  bool done = false, failed = false;

  for (int step = 0; step < max_steps; ++step) {
    const float dtc = jmax(jmin(dt, k.t1 - t), k.dt_floor);
    // the productions of stages 2..6, independent of the state; stage 7's
    // time t + dtc is stage 6's (c[5] = 1)
    float ts[kStages], prod[kStages];
#pragma unroll
    for (int s = 0; s < kStages; ++s) ts[s] = t + k.c[s + 1] * dtc;
    productions(mlp, ts, prod, knot, span, g, n_seg, g_at0, e_beta, age,
                base);

#pragma unroll
    for (int s = 1; s < 6; ++s) {
      float va = u1, vb = u2;
#pragma unroll
      for (int j = 0; j < s; ++j) {
        va = va + dtc * k.a[s][j] * ka[j];
        vb = vb + dtc * k.a[s][j] * kb[j];
      }
      ka[s] = rhs_a(va, vb, prod[s - 1]);
      kb[s] = rhs_b(va, vb);
    }
    float ya = u1, yb = u2;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      ya = ya + dtc * k.a[6][j] * ka[j];
      yb = yb + dtc * k.a[6][j] * kb[j];
    }
    ka[6] = rhs_a(ya, yb, prod[4]);
    kb[6] = rhs_b(ya, yb);

    float ea = k.btilde[0] * ka[0];
    float ebb = k.btilde[0] * kb[0];
#pragma unroll
    for (int j = 1; j < 7; ++j) {
      ea = ea + k.btilde[j] * ka[j];
      ebb = ebb + k.btilde[j] * kb[j];
    }
    ea = dtc * ea;
    ebb = dtc * ebb;
    const float sc1 = k.atol + k.rtol * jmax(fabsf(u1), fabsf(ya));
    const float sc2 = k.atol + k.rtol * jmax(fabsf(u2), fabsf(yb));
    const float err = rms2(ea, ebb, sc1, sc2);

    const bool finite = isfinite(ya) && isfinite(yb) && isfinite(err);
    const bool accept = finite && err <= 1.0f;
    const float err_c = jmax(err, 1e-10f);
    // one powf: the accepted step's exponent or the rejected one's
    const float pw = powf(err_c, accept ? k.neg_beta1 : k.neg_inv_order);
    const float fac_acc = jclip(k.safety * pw * pw_prev, k.fmin, k.fmax);
    const float fac_rej = jclip(k.safety * pw, k.fmin, 1.0f);
    const float factor = accept ? fac_acc : (finite ? fac_rej : 0.5f);
    const float dt_next = dtc * factor;

    const float t_new = t + dtc;
    const bool reached_end = t_new >= k.end_tol;
    if (accept) {
      // the save times an accepted step crosses follow one another from
      // next_save: a later one is crossed only if an earlier one is
      for (; next_save < n_save; ++next_save) {
        const float t_s = knot[next_save];
        const bool hit = t_s > t && (t_s <= t_new || (reached_end && t_s <= t_new + k.save_slack));
        if (!hit) break;
        const float theta = jclip((t_s - t) / dtc, 0.0f, 1.0f);
        float b[7];
        interp_coeffs(k.interp, theta, b);
        float yi = u1;
#pragma unroll
        for (int j = 0; j < 7; ++j) yi = yi + dtc * b[j] * ka[j];
        const float res = yi - d[next_save];
        sse = sse + res * res;
      }
      t = t_new;
      u1 = ya;
      u2 = yb;
      ka[0] = ka[6];
      kb[0] = kb[6];
      err_prev = err_c;
      pw_prev = powf(err_prev, k.beta2);
      done = reached_end;
    } else {
      failed = dt_next < k.dt_min;
    }
    dt = dt_next;
    if (done || failed) break;
  }

  const bool ok = done && !failed;
  sse_out[lane] = (ok && isfinite(sse)) ? sse : INFINITY;
  ok_out[lane] = ok;
}

template <int In>
int launch(const float* nn, const float* beta, const float* glucose,
           const float* data, const float* kinetics, float* sse, bool* ok,
           long long lanes, int n_ind,
           const float* consts,      // host, see tsit5_cohort.py::constants
           const float* consts_dev,  // the same in device memory, a long grid's
           int n_save, int j0, int max_steps, void* stream) {
  if (n_save < 2 || (!cude::kLongGrid && n_save > kMaxTimepoints) ||
      (cude::kLongGrid && consts_dev == nullptr) || j0 < 0 ||
      j0 > n_save - 2 || n_ind < 1 || max_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes <= 0) return 0;
  // [head][knots][spans][scalars], the knots and spans padded to
  // kMaxTimepoints for a short grid, n_save each for a long one
  const int row = cude::kLongGrid ? n_save : kMaxTimepoints;
  const float* dev = consts_dev == nullptr ? consts : consts_dev;
  Tsit5Consts k;
  memcpy(&k, consts, sizeof(float) * kHeadFloats);
  cude::fill_table(k.knot, consts + kHeadFloats, dev + kHeadFloats, row);
  cude::fill_table(k.span, consts + kHeadFloats + row,
                   dev + kHeadFloats + row, row);
  memcpy(&k.one_minus_w0, consts + kHeadFloats + 2 * row,
         sizeof(float) * kScalarFloats);
  const long long blocks = (lanes + kBlock - 1) / kBlock;
  tsit5_cohort_sse_kernel<In><<<static_cast<unsigned int>(blocks), kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      nn, beta, glucose, data, kinetics, sse, ok, lanes, n_ind, n_save, j0,
      max_steps, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tsit5_cohort_sse(const float* nn, const float* beta,
                                const float* glucose, const float* data,
                                const float* kinetics, float* sse, bool* ok,
                                long long lanes, int n_ind,
                                const float* consts, const float* consts_dev,
                                int n_save, int j0, int max_steps,
                                void* stream) {
  return launch<2>(nn, beta, glucose, data, kinetics, sse, ok, lanes, n_ind,
                   consts, consts_dev, n_save, j0, max_steps, stream);
}

extern "C" int tsit5_cohort_sse_age(const float* nn, const float* beta,
                                    const float* glucose, const float* data,
                                    const float* kinetics, float* sse,
                                    bool* ok, long long lanes, int n_ind,
                                    const float* consts,
                                    const float* consts_dev, int n_save,
                                    int j0, int max_steps, void* stream) {
  return launch<3>(nn, beta, glucose, data, kinetics, sse, ok, lanes, n_ind,
                   consts, consts_dev, n_save, j0, max_steps, stream);
}
