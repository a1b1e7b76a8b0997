// Device code shared by the port's kernels: the cUDE network and the
// fixed-step time grid.
//
// The network is chain(widths, "tanh") with a softplus scalar head on
// [dG, e^beta] (In = 2) or, for the covariate model, on [dG, e^beta, age]
// (In = 3): any number of tanh layers of any widths, the JAX kernels' domain
// (pallas_rk4.py:70-96 build theirs from net.layer_dims).  A library is
// built for one list of hidden widths, CUDE_WIDTHS, a compile-time constant
// (ops/cuda_build.py passes another list than the canonical 4, 4 in a
// generated header), so every loop over a layer unrolls.  The weights are in
// the JAX package's flat layout (per layer W row-major [fan_out][fan_in],
// then the bias).  Every dot product runs left to right and adds the bias
// last, the order of the plain PyTorch versions; the files are built with
// -fmad=false and without fast math, so tanhf/expf/log1pf are the accurate
// ones and no multiply-add is contracted.
//
// The time grid: a library built for grids of up to kMaxTimepoints (16)
// points, the default, passes each segment's constants to a kernel by value
// as its parameters; a library built with CUDE_LONG_GRID (ops/cuda_build.py
// adds it in the generated header for a longer grid) takes any number of
// points and reads those constants from device memory where they are used,
// from a table the caller keeps there (GridTable).  The two builds of a
// source differ in that and in where a lane keeps its rows of save-time
// values: sized to 16 in shared memory for a short grid, to the grid for a
// long one (cude_grad.cuh, time_row_floats), or read from device memory
// (tsit5_cohort.cu).
//
// Where the weights live: up to kRegisterParams (41, the canonical chain(4,
// 2)'s 37 and 41) every thread copies them into registers, as the canonical
// bodies always have; above, a thread reads each weight where it is used,
// from device memory through L1, which the lanes of a network share, or
// from the copy in shared memory that K5's block makes of its restart's
// weights (population_grad.cu).  A wider network in registers would spill
// them to local memory, one copy a thread.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include <atomic>
#include <type_traits>

#ifndef CUDE_WIDTHS
#define CUDE_WIDTHS 4, 4
#endif

#ifndef CUDE_LONG_GRID
#define CUDE_LONG_GRID 0
#endif

namespace cude {

constexpr bool kLongGrid = CUDE_LONG_GRID != 0;
constexpr int kMaxTimepoints = 16;  // points of a grid, without CUDE_LONG_GRID

// N rows of T of a short grid by value, or a long grid's in device memory
template <class T, int N>
using GridTable = std::conditional_t<kLongGrid, const T*, T[N]>;

// a GridTable of `rows` rows: a short grid's copied from the host array, a
// long grid's pointing at the same rows in device memory
template <class T, int N>
inline void fill_table(T (&table)[N], const float* host, const float*, int rows) {
  memcpy(table, host, sizeof(T) * rows);
}
template <class T>
inline void fill_table(const T*& table, const float*, const float* dev, int) {
  table = reinterpret_cast<const T*>(dev);
}
constexpr int kRegisterParams = 41;

// The layers of chain(W..., "tanh") on In inputs with a scalar head: layer
// l maps fan_in(l) to fan_out(l) values, its weights start at offset(l) of
// the flat vector, and hidden layer l's outputs at unit(l) of the
// concatenated hidden outputs.
template <int In, int... W>
struct Shape {
  static_assert(sizeof...(W) >= 1, "at least one hidden layer");
  static constexpr int kHidden = sizeof...(W);
  static constexpr int kLayers = kHidden + 1;
  __host__ __device__ static constexpr int fan_in(int l) {
    const int dims[] = {In, W...};
    return dims[l];
  }
  __host__ __device__ static constexpr int fan_out(int l) {
    const int dims[] = {W..., 1};
    return dims[l];
  }
  __host__ __device__ static constexpr int offset(int l) {
    int off = 0;
    for (int j = 0; j < l; ++j) off += fan_in(j) * fan_out(j) + fan_out(j);
    return off;
  }
  __host__ __device__ static constexpr int unit(int l) {
    int u = 0;
    for (int j = 0; j < l; ++j) u += fan_out(j);
    return u;
  }
  __host__ __device__ static constexpr int max_width() {
    int m = 1;
    for (int j = 0; j < kHidden; ++j) m = fan_out(j) > m ? fan_out(j) : m;
    return m;
  }
  static constexpr int kParams = offset(kLayers);
  static constexpr int kUnits = unit(kHidden);
  static constexpr int kMaxWidth = max_width();
};

static_assert(Shape<2, 4, 4>::kParams == 37 && Shape<3, 4, 4>::kParams == 41,
              "chain(4, 2) has 37 weights on 2 inputs, 41 on 3");

// A layer of up to kUnrolledProducts weights unrolls every product; a wider
// one unrolls only its inner loop, so nvcc's time does not grow with the
// square of the width (a fully unrolled chain(90, 2), 8,551 weights, did
// not build in 25 minutes); up to chain(32, 2) every product unrolls.
constexpr int kUnrolledProducts = 1024;

// the unroll count of a layer's outer loop of n
template <int Fi, int Fo>
__host__ __device__ constexpr int outer_unroll(int n) {
  return Fi * Fo <= kUnrolledProducts ? n : 1;
}

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
  GridTable<Segment, kMaxTimepoints - 1> seg;
};
static_assert(sizeof(Segment) == 5 * sizeof(float), "a segment row");

// the Grid of segment rows [n_seg][t0, dt, dt/2, dt/6, 1/span], on the host
// (segments) and, for a long grid, the same rows in device memory
// (segments_dev); false when the arguments do not describe a grid the
// kernels take
inline bool make_grid(const float* segments, const float* segments_dev,
                      int n_seg, int substeps, int j0, float one_minus_w0,
                      float w0, Grid* grid) {
  if (n_seg < 1 || (!kLongGrid && n_seg > kMaxTimepoints - 1) ||
      (kLongGrid && segments_dev == nullptr) || substeps < 1 || j0 < 0 ||
      j0 >= n_seg)
    return false;
  grid->n_seg = n_seg;
  grid->substeps = substeps;
  grid->j0 = j0;
  grid->one_minus_w0 = one_minus_w0;
  grid->w0 = w0;
  // rounded once from double, as ops/lane_grad.py::grid_constants rounds it
  grid->inv_2s = static_cast<float>(1.0 / (2.0 * substeps));
  fill_table(grid->seg, segments, segments_dev, n_seg);
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
  using Net = Shape<In, CUDE_WIDTHS>;
  static constexpr int kIn = In;
  static constexpr int kParams = Net::kParams;
  static constexpr int kLayers = Net::kLayers;
  static constexpr int kUnits = Net::kUnits;
  static constexpr bool kInRegisters = kParams <= kRegisterParams;
  // columns of a kinetics row: k0, k1, k2, c0, then the age for 3 inputs
  static constexpr int kKin = 4 + (In == 3);

  float reg_[kInRegisters ? kParams : 1];
  const float* ptr_;

  // weight i of the flat layout
  __device__ __forceinline__ float w(int i) const {
    if constexpr (kInRegisters)
      return reg_[i];
    else
      return ptr_[i];
  }

  // the weights from device memory, read-only
  __device__ __forceinline__ void load(const float* __restrict__ p) {
    if constexpr (kInRegisters) {
#pragma unroll
      for (int i = 0; i < kParams; ++i) reg_[i] = __ldg(p + i);
    } else {
      ptr_ = p;
    }
  }

  // the weights from shared memory
  __device__ __forceinline__ void load_shared(const float* p) {
    if constexpr (kInRegisters) {
#pragma unroll
      for (int i = 0; i < kParams; ++i) reg_[i] = p[i];
    } else {
      ptr_ = p;
    }
  }

  // y[o] = act(sum_k W[o][k] x[k] + b[o]) of layer L, each sum left to
  // right and the bias last; tanh for a hidden layer, none for the head
  template <int L>
  __device__ __forceinline__ void dense(const float* x, float* y) const {
    constexpr int fi = Net::fan_in(L), fo = Net::fan_out(L);
    constexpr int off = Net::offset(L);
    constexpr int kOuter = outer_unroll<fi, fo>(fo);
#pragma unroll (kOuter)
    for (int o = 0; o < fo; ++o) {
      float acc = w(off + o * fi) * x[0];
#pragma unroll
      for (int k = 1; k < fi; ++k) acc = acc + w(off + o * fi + k) * x[k];
      acc = acc + w(off + fi * fo + o);
      y[o] = L + 1 < kLayers ? tanhf(acc) : acc;
    }
  }

  // the layers from L on: hidden outputs into h (layer l at Net::unit(l)),
  // returns the head's pre-activation
  template <int L>
  __device__ __forceinline__ float from(const float* x, float* h) const {
    if constexpr (L + 1 == kLayers) {
      float z;
      dense<L>(x, &z);
      return z;
    } else {
      float* y = h + Net::unit(L);
      dense<L>(x, y);
      return from<L + 1>(y, h);
    }
  }

  // every hidden output into h[kUnits]; returns the head's pre-activation
  // at [x0, x1(, x2)]: x2, the age, is read by the 3-input network only
  __device__ __forceinline__ float hidden(float x0, float x1, float x2,
                                          float* h) const {
    float x[In];
    x[0] = x0;
    x[1] = x1;
    if constexpr (In == 3) x[2] = x2;
    return from<0>(x, h);
  }

  __device__ __forceinline__ float operator()(float x0, float x1, float x2) const {
    float h[kUnits];
    return softplus(hidden(x0, x1, x2, h));
  }
};

// Lets `kernel` take `bytes` of dynamic shared memory a block.  Above the
// 48 KB a launch gets without asking it opts in, up to the card's maximum a
// block, once for each device and larger size: allowed[device] is the most it
// has asked for `kernel` (the caller's static table, zero at first).  Returns
// 0, a CUDA error, or minus `bytes` where the card has fewer (the C entry
// points return that as their refusal of the inputs).
constexpr int kMaxDevices = 64;

template <class Kernel>
int allow_shared(Kernel kernel, size_t bytes,
                 std::atomic<size_t> (&allowed)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && bytes <= allowed[dev].load()) return 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > static_cast<size_t>(most)) return -static_cast<int>(bytes);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices) allowed[dev].store(bytes);
  return 0;
}

}  // namespace cude

// The hidden widths this library was built for: writes at most `most` of
// them to `out` and returns how many there are (ops/cuda_build.py checks
// them against the network it loads the library for).  Each library is one
// translation unit, so the header defines it once.
extern "C" int cude_hidden_widths(int* out, int most) {
  const int widths[] = {CUDE_WIDTHS};
  const int n = static_cast<int>(sizeof(widths) / sizeof(widths[0]));
  for (int i = 0; i < n && i < most; ++i) out[i] = widths[i];
  return n;
}

// 1 for a library built with CUDE_LONG_GRID, else 0 (checked as the widths)
extern "C" int cude_long_grid() { return cude::kLongGrid ? 1 : 0; }
