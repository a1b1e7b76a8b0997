// Population mean SSE per restart with its exact discrete gradient, one
// block per restart (the value+grad of joint cUDE training when the
// multi-start is too wide for the (restart x individual) lane kernel), for
// Hopper (sm_90a).
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
// network per evaluation point).
//
// Design: one block of kRestartWarps warps per restart.  The block reads
// the restart's weights and the cohort (glucose, data and kinetics, N x (2K
// + 4|5) floats) into shared memory once; every thread loads the weights
// into registers.  Warp w computes the lanes of individuals n = w, w + W,
// ... with cude_grad.cuh's warp_lane, exactly as lane_grad.cu computes a
// lane, writes the individual's SSE and weight gradient into a shared
// [N][P + 1] table and its beta gradient, times 1/N, to gb[r, n].  After a
// barrier, thread c sums column c of the table over the individuals
// 0..N-1 one after another and multiplies by 1/N.  So K5 is K2's lanes
// summed over the individuals in order: the two routes agree bit for bit
// when K2's lanes are summed that way (ops/population_grad.py,
// restart_sse_and_grad_reference, is exactly that).  The order of the sums
// is not the JAX kernel's (one running accumulator over individuals and
// points), so the port agrees with JAX's K5 up to reassociation, as K2
// does with JAX's K2.
//
// Shared memory: the weights, the cohort, the [N][P + 1] table and each
// warp's scratch (block_floats); 54,116 bytes (59,368 with the age) at N =
// 57 on the OGTT grid, so the launch opts in above the 48 KB default, once
// for each device and larger size, and refuses a cohort beyond the card's
// 227 KB a block.
//
// Bound: latency and issue.  2,304 restarts are 2,304 blocks; each warp
// runs ~N / W lanes of warp_lane one after another, a few microseconds
// each.
//
// Numerics (cude_mlp.cuh): accurate tanhf/expf/log1pf, no contracted
// multiply-adds; the sigmoid is 1 / (1 + expf(-z)).
//
// C interface (loaded with ctypes): population_sse_and_grad (2 inputs) and
// population_sse_and_grad_age (3 inputs) return cudaGetLastError() after the
// launch, or minus the bytes of shared memory a block would need where the
// card has fewer (ops/cuda_build.py raises ValueError for that).  They
// allocate nothing and launch on the given stream.

#include <atomic>

#include "cude_grad.cuh"

namespace {

using cude::GradGrid;
using cude::Mlp;

// warps a block (a restart): 8 beat 4 on the H100 at 2,304 x 57
constexpr int kRestartWarps = 8;
constexpr int kThreads = kRestartWarps * cude::kWarp;

// shared floats of a block: the weights, glucose, data and kinetics of N
// individuals, the [N][P + 1] table, and each warp's scratch; the layout of
// the kernel below
template <int In>
size_t block_floats(int n_ind, int n_seg, int substeps) {
  using Net = Mlp<In>;
  const size_t per_ind = 2 * (n_seg + 1) + Net::kKin + Net::kParams + 1;
  return Net::kParams + static_cast<size_t>(n_ind) * per_ind +
         static_cast<size_t>(kRestartWarps) *
             cude::warp_scratch_floats<In>(n_seg, substeps);
}

template <int In>
__global__ void __launch_bounds__(kThreads, 1)
population_sse_and_grad_kernel(const float* __restrict__ nn,       // [G, P]
                               const float* __restrict__ beta,     // [G, N]
                               const float* __restrict__ glucose,  // [N, K]
                               const float* __restrict__ data,     // [N, K]
                               const float* __restrict__ kinetics, // [N, 4|5]
                               float* __restrict__ f_out,          // [G]
                               float* __restrict__ gnn_out,        // [G, P]
                               float* __restrict__ gb_out,         // [G, N]
                               int n_ind, float inv_n,
                               const __grid_constant__ GradGrid grid,
                               int warp_stride) {
  using Net = Mlp<In>;
  constexpr int kParams = Net::kParams;
  constexpr int kKin = Net::kKin;
  constexpr int kCols = kParams + 1;  // the weight gradient, then the SSE
  extern __shared__ float smem[];
  const long long r = blockIdx.x;
  const int k_pts = grid.n_seg + 1;
  float* s_nn = smem;
  float* s_glucose = s_nn + kParams;
  float* s_data = s_glucose + n_ind * k_pts;
  float* s_kin = s_data + n_ind * k_pts;
  float* s_table = s_kin + n_ind * kKin;
  float* s_scratch = s_table + n_ind * kCols;
  for (int i = threadIdx.x; i < kParams; i += blockDim.x) s_nn[i] = nn[r * kParams + i];
  for (int i = threadIdx.x; i < n_ind * k_pts; i += blockDim.x) {
    s_glucose[i] = glucose[i];
    s_data[i] = data[i];
  }
  for (int i = threadIdx.x; i < n_ind * kKin; i += blockDim.x) s_kin[i] = kinetics[i];
  __syncthreads();

  const int warp = threadIdx.x / cude::kWarp;
  Net mlp;
  mlp.load_shared(s_nn);
  float* scratch = s_scratch + warp * warp_stride;
  for (int n = warp; n < n_ind; n += kRestartWarps) {
    const float e_beta = expf(beta[r * n_ind + n]);
    float* row = s_table + n * kCols;
    const float sse = cude::warp_lane<In>(
        mlp, e_beta, s_glucose + n * k_pts, s_data + n * k_pts,
        s_kin + kKin * n, grid, scratch, [&](int c, float v) {
          if (c < kParams)
            row[c] = v;
          else
            gb_out[r * n_ind + n] = v * e_beta * inv_n;
        });
    if (threadIdx.x % cude::kWarp == 0) row[kParams] = sse;
  }
  __syncthreads();

  // the sums over the individuals, 0..N-1 in order, one column a thread
  for (int c = threadIdx.x; c < kCols; c += blockDim.x) {
    float sum = s_table[c];
    for (int n = 1; n < n_ind; ++n) sum = sum + s_table[n * kCols + c];
    const float mean = sum * inv_n;
    if (c < kParams)
      gnn_out[r * kParams + c] = mean;
    else
      f_out[r] = isfinite(mean) ? mean : INFINITY;
  }
}

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

template <int In>
int launch(const float* nn, const float* beta, const float* glucose,
           const float* data, const float* kinetics, float* f, float* gnn,
           float* gb, long long restarts, int n_ind,
           const float* consts,  // host, see lane_grad.py::grid_constants
           int n_seg, int substeps, int j0, float inv_n, void* stream) {
  GradGrid grid;
  if (!cude::make_grad_grid(consts, n_seg, substeps, j0, &grid) || n_ind < 1 ||
      restarts > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (restarts <= 0) return 0;
  const size_t shared = sizeof(float) * block_floats<In>(n_ind, n_seg, substeps);
  static std::atomic<size_t> allowed[kMaxDevices];
  const int err = allow_shared(population_sse_and_grad_kernel<In>, shared, allowed);
  if (err != 0) return err;
  population_sse_and_grad_kernel<In><<<static_cast<unsigned int>(restarts), kThreads,
                                       shared, static_cast<cudaStream_t>(stream)>>>(
      nn, beta, glucose, data, kinetics, f, gnn, gb, n_ind, inv_n, grid,
      cude::warp_scratch_floats<In>(n_seg, substeps));
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
