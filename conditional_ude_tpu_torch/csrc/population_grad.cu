// Population mean SSE per restart with its exact discrete gradient, one
// block per restart (the value+grad of joint cUDE training when the
// multi-start is too wide for the (restart x individual) lane kernel), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
// conditional_ude_tpu/ops/pallas_grad.py::_build_population_grad_kernel
// (reached through _population_sse_and_grad_impl, which
// population_sse_and_grad_pallas takes above PACK_MAX_LANES packed lanes),
// both of its bodies, at every network it takes (cude_mlp.cuh): P weights
// on [dG, e^beta] or, for the covariate model, on [dG, e^beta, age] (the
// age is the 5th column of the individual's kinetics row; 37 and 41 weights
// for the canonical chain(4, 2)).  For each restart it returns
//   f      = (sum_n sse_n) / N, +inf where that is not finite,
//   gnn[P] = (sum_n d sse_n / d nn) / N,
//   gb[n]  = (d sse_n / d beta_n) / N,
// the mathematics of lane_grad.cu (cude_grad.cuh: the affine matrix-form
// RK4, the adjoint recursion over the residuals, one hand VJP of the
// network per evaluation point).
//
// Design: one block of kRestartWarps warps per restart.  The block reads
// the restart's weights and the cohort (glucose, data and kinetics, N x
// (2K + 4|5) floats) into shared memory once; every thread of the
// canonical network loads the weights into registers, a wider network's
// threads read them in shared memory where they are used, and a network
// of more than kSharedParams weights is read from device memory instead,
// as in lane_grad.cu (on the H100 the shared copy made K5 ~25 % faster at
// 49 and 57 weights, 8 % at 105).  Warp w
// computes the lanes of individuals n = w, w + W, ... with cude_grad.cuh's
// warp_lane, exactly as lane_grad.cu computes a lane, writes the
// individual's SSE and weight gradient into a shared table of N rows and
// its beta gradient, times 1/N, to gb[r, n].  After a barrier, thread c
// sums column c of the table over the individuals 0..N-1 one after
// another and multiplies by 1/N.  Past 127 weights the table holds the
// columns of one of warp_lane's passes of 128 (cude_grad.cuh) and the
// block runs the lanes once a pass, so neither the table nor the warps'
// partial rows grow with the network.  So K5 is K2's lanes summed over the
// individuals in order: the two routes agree bit for bit when K2's lanes
// are summed that way (ops/population_grad.py,
// restart_sse_and_grad_reference, is exactly that).  The order of the sums
// is not the JAX kernel's (one running accumulator over individuals and
// points), so the port agrees with JAX's K5 up to reassociation, as K2
// does with JAX's K2.
//
// Shared memory: the weights (up to kSharedParams), the cohort, the table
// and each warp's scratch (block_floats; a wider network's warp also keeps
// its 32 partial rows of at most 129 sums there, cude_grad.cuh); 54,116
// bytes (59,368 with the age) at N = 57 on the OGTT grid for the canonical
// network and at most 169,084 (169,312) plus the weights for any other, so
// the launch opts in above the 48 KB default, once for each device and
// larger size, and refuses a cohort beyond the card's 227 KB a block (on
// the OGTT grid 909 individuals for the canonical network, 166 (165 with
// the age) at 128 weights, 110 (109) at kSharedParams).
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

#include "cude_grad.cuh"

namespace {

using cude::GradGrid;
using cude::Mlp;

// warps a block (a restart): 8 beat 4 on the H100 at 2,304 x 57
constexpr int kRestartWarps = 8;
constexpr int kThreads = kRestartWarps * cude::kWarp;
// weights a block copies into shared memory (32 KB); more are read from
// device memory
constexpr int kSharedParams = 8192;

template <int In>
__host__ __device__ constexpr bool shared_net() {
  return Mlp<In>::kParams <= kSharedParams;
}

// columns of the table: the weight gradients of a pass, then the SSE
template <int In>
__host__ __device__ constexpr int table_columns() {
  constexpr int params = Mlp<In>::kParams;
  constexpr int cols = cude::pass_columns<In>();
  return (cols < params ? cols : params) + 1;
}

// shared floats of a block: the weights (shared_net), glucose, data and
// kinetics of N individuals, the table, and each warp's scratch; the
// layout of the kernel below
template <int In>
size_t block_floats(int n_ind, int n_seg, int substeps) {
  using Net = Mlp<In>;
  const size_t per_ind = 2 * (n_seg + 1) + Net::kKin + table_columns<In>();
  return (shared_net<In>() ? Net::kParams : 0) +
         static_cast<size_t>(n_ind) * per_ind +
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
  constexpr int kCols = table_columns<In>();
  constexpr int kSlots = kCols - 1;  // the SSE's column
  constexpr int kPassCols = cude::pass_columns<In>();
  constexpr int kPasses = cude::passes<In>();
  extern __shared__ float smem[];
  const long long r = blockIdx.x;
  const int k_pts = grid.n_seg + 1;
  float* s_nn = smem;
  float* s_glucose = s_nn + (shared_net<In>() ? kParams : 0);
  float* s_data = s_glucose + n_ind * k_pts;
  float* s_kin = s_data + n_ind * k_pts;
  float* s_table = s_kin + n_ind * kKin;
  float* s_scratch = s_table + n_ind * kCols;
  if constexpr (shared_net<In>()) {
    for (int i = threadIdx.x; i < kParams; i += blockDim.x) s_nn[i] = nn[r * kParams + i];
  }
  for (int i = threadIdx.x; i < n_ind * k_pts; i += blockDim.x) {
    s_glucose[i] = glucose[i];
    s_data[i] = data[i];
  }
  for (int i = threadIdx.x; i < n_ind * kKin; i += blockDim.x) s_kin[i] = kinetics[i];
  __syncthreads();

  const int warp = threadIdx.x / cude::kWarp;
  Net mlp;
  if constexpr (shared_net<In>())
    mlp.load_shared(s_nn);
  else
    mlp.load(nn + r * kParams);
  float* scratch = s_scratch + warp * warp_stride;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int lo = pass * kPassCols;  // the pass's first weight
    for (int n = warp; n < n_ind; n += kRestartWarps) {
      const float e_beta = expf(beta[r * n_ind + n]);
      float* row = s_table + n * kCols;
      const float sse = cude::warp_lane<In>(
          mlp, e_beta, s_glucose + n * k_pts, s_data + n * k_pts,
          s_kin + kKin * n, grid, scratch, pass, pass + 1, [&](int c, float v) {
            if (c < kParams)
              row[c - lo] = v;
            else
              gb_out[r * n_ind + n] = v * e_beta * inv_n;
          });
      if (threadIdx.x % cude::kWarp == 0) row[kSlots] = sse;
    }
    __syncthreads();

    // the sums over the individuals, 0..N-1 in order, one column a thread;
    // the SSE's in the last pass
    const int weights = (lo + kSlots < kParams ? lo + kSlots : kParams) - lo;
    const int cols = weights + (pass + 1 == kPasses);
    for (int j = threadIdx.x; j < cols; j += blockDim.x) {
      const int c = j < weights ? j : kSlots;
      float sum = s_table[c];
      for (int n = 1; n < n_ind; ++n) sum = sum + s_table[n * kCols + c];
      const float mean = sum * inv_n;
      if (j < weights)
        gnn_out[r * kParams + lo + j] = mean;
      else
        f_out[r] = isfinite(mean) ? mean : INFINITY;
    }
    __syncthreads();  // the table is free for the next pass
  }
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
  static std::atomic<size_t> allowed[cude::kMaxDevices];
  const int err = cude::allow_shared(population_sse_and_grad_kernel<In>, shared, allowed);
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
