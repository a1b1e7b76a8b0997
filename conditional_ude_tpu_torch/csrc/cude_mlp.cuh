// Device code shared by the port's kernels: the canonical cUDE network and
// the fixed-step time grid.
//
// The network is chain(4, 2) on [dG, e^beta] (kIn = 2, 37 weights) or, for
// the covariate model, on [dG, e^beta, age] (kIn = 3, 41 weights): two tanh
// layers of width 4 and a softplus head, in the JAX package's flat layout
// (per layer W row-major [fan_out][fan_in], then the bias).  Every dot
// product runs left to right and adds the bias last, the order of the plain
// PyTorch versions; the files are built with -fmad=false and without fast
// math, so tanhf/expf/log1pf are the accurate ones and no multiply-add is
// contracted.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace cude {

constexpr int kWidth = 4;
constexpr int kMaxTimepoints = 16;

// weights of chain(4, 2) on `in` inputs
constexpr int params_of(int in) {
  return in * kWidth + kWidth + kWidth * kWidth + kWidth + kWidth + 1;
}
static_assert(params_of(2) == 37 && params_of(3) == 41,
              "chain(4, 2) has 37 weights on 2 inputs, 41 on 3");

// One observation segment of the fixed-step grid; every constant is rounded
// once from float64 on the host, as the JAX kernels' Python floats are.
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
  float inv_2s;         // 1 / (2 substeps): the spacing of cude_rk4.cuh's points
  Segment seg[kMaxTimepoints - 1];
};

// the Grid of host segment rows [n_seg][t0, dt, dt/2, dt/6, 1/span]; false
// when the arguments do not describe a grid the kernels take
inline bool make_grid(const float* segments, int n_seg, int substeps, int j0,
                      float one_minus_w0, float w0, Grid* grid) {
  if (n_seg < 1 || n_seg > kMaxTimepoints - 1 || substeps < 1 || j0 < 0 ||
      j0 >= n_seg)
    return false;
  grid->n_seg = n_seg;
  grid->substeps = substeps;
  grid->j0 = j0;
  grid->one_minus_w0 = one_minus_w0;
  grid->w0 = w0;
  // rounded once from double, as ops/lane_grad.py::grid_constants rounds it
  grid->inv_2s = static_cast<float>(1.0 / (2.0 * substeps));
  for (int s = 0; s < n_seg; ++s) {
    const float* r = segments + 5 * s;
    grid->seg[s] = Segment{r[0], r[1], r[2], r[3], r[4]};
  }
  return true;
}

__device__ __forceinline__ float softplus(float x) {
  // max(x, 0) + log1p(exp(-|x|)); a NaN passes through as in torch.clamp_min
  const float pos = x < 0.0f ? 0.0f : x;
  return pos + log1pf(expf(-fabsf(x)));
}

template <int In>
struct Mlp {
  static_assert(In == 2 || In == 3, "the network takes 2 or 3 inputs");
  static constexpr int kIn = In;
  static constexpr int kParams = params_of(In);
  // columns of a kinetics row: k0, k1, k2, c0, then the age for 3 inputs
  static constexpr int kKin = 4 + (In == 3);

  float w1[kWidth][kIn], b1[kWidth];
  float w2[kWidth][kWidth], b2[kWidth];
  float w3[kWidth], b3;

  // the weights from device memory, read-only
  __device__ __forceinline__ void load(const float* __restrict__ p) {
    load_with([p](int i) { return __ldg(p + i); });
  }

  // the weights from shared memory
  __device__ __forceinline__ void load_shared(const float* p) {
    load_with([p](int i) { return p[i]; });
  }

  // the weights in the flat layout, entry i read by ld(i)
  template <class Ld>
  __device__ __forceinline__ void load_with(Ld ld) {
    int i = 0;
#pragma unroll
    for (int o = 0; o < kWidth; ++o)
#pragma unroll
      for (int k = 0; k < kIn; ++k) w1[o][k] = ld(i++);
#pragma unroll
    for (int o = 0; o < kWidth; ++o) b1[o] = ld(i++);
#pragma unroll
    for (int o = 0; o < kWidth; ++o)
#pragma unroll
      for (int k = 0; k < kWidth; ++k) w2[o][k] = ld(i++);
#pragma unroll
    for (int o = 0; o < kWidth; ++o) b2[o] = ld(i++);
#pragma unroll
    for (int k = 0; k < kWidth; ++k) w3[k] = ld(i++);
    b3 = ld(i);
  }

  // layer 1 pre-activation w1[o][0]*x0 + w1[o][1]*x1 (+ w1[o][2]*x2) + b1[o];
  // x2, the age, is read by the 3-input network only
  __device__ __forceinline__ float z1(int o, float x0, float x1, float x2) const {
    float acc = w1[o][0] * x0;
    acc = acc + w1[o][1] * x1;
    if constexpr (In == 3) acc = acc + w1[o][2] * x2;
    return acc + b1[o];
  }

  // layer 2 tanh outputs from the layer-1 outputs
  __device__ __forceinline__ void layer2(const float h1[kWidth], float h2[kWidth]) const {
#pragma unroll
    for (int o = 0; o < kWidth; ++o) {
      float acc = w2[o][0] * h1[0];
#pragma unroll
      for (int k = 1; k < kWidth; ++k) acc = acc + w2[o][k] * h1[k];
      h2[o] = tanhf(acc + b2[o]);
    }
  }

  // head pre-activation from the layer-2 outputs
  __device__ __forceinline__ float z3(const float h2[kWidth]) const {
    float acc = w3[0] * h2[0];
#pragma unroll
    for (int k = 1; k < kWidth; ++k) acc = acc + w3[k] * h2[k];
    return acc + b3;
  }

  // layers 2 and 3 on given layer-1 outputs
  __device__ __forceinline__ float rest(const float h1[kWidth]) const {
    float h2[kWidth];
    layer2(h1, h2);
    return softplus(z3(h2));
  }

  __device__ __forceinline__ float operator()(float x0, float x1, float x2) const {
    float h1[kWidth];
#pragma unroll
    for (int o = 0; o < kWidth; ++o) h1[o] = tanhf(z1(o, x0, x1, x2));
    return rest(h1);
  }
};

}  // namespace cude
