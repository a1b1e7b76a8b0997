// Device code shared by the port's kernels: the canonical cUDE network and
// the fixed-step time grid.
//
// The network is chain(4, 2) on [dG, e^beta]: two tanh layers of width 4
// and a softplus head, 37 weights in the JAX package's flat layout (per
// layer W row-major [fan_out][fan_in], then the bias).  Every dot product
// runs left to right and adds the bias last, the order of the plain PyTorch
// versions; the files are built with -fmad=false and without fast math, so
// tanhf/expf/log1pf are the accurate ones and no multiply-add is contracted.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace cude {

constexpr int kIn = 2;
constexpr int kWidth = 4;
constexpr int kParams = kIn * kWidth + kWidth + kWidth * kWidth + kWidth + kWidth + 1;
static_assert(kParams == 37, "canonical chain(4, 2) on 2 inputs has 37 weights");
constexpr int kMaxTimepoints = 16;

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

  // layer 1 pre-activation w1[o][0]*x0 + w1[o][1]*x1 + b1[o]
  __device__ __forceinline__ float z1(int o, float x0, float x1) const {
    float acc = w1[o][0] * x0;
    acc = acc + w1[o][1] * x1;
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

  __device__ __forceinline__ float operator()(float x0, float x1) const {
    float h1[kWidth];
#pragma unroll
    for (int o = 0; o < kWidth; ++o) h1[o] = tanhf(z1(o, x0, x1));
    return rest(h1);
  }
};

}  // namespace cude
