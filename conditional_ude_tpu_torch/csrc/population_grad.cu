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
// another into s_acc[c] and, at the end, multiplies by 1/N.  Past 127
// weights the table holds the columns of one of warp_lane's passes of 128
// (cude_grad.cuh) and the block runs the lanes once a pass, so neither the
// table nor the warps' partial rows grow with the network.  So K5 is K2's
// lanes summed over the individuals in order: the two routes agree bit for
// bit when K2's lanes are summed that way (ops/population_grad.py,
// restart_sse_and_grad_reference, is exactly that).  The order of the sums
// is not the JAX kernel's (one running accumulator over individuals and
// points), so the port agrees with JAX's K5 up to reassociation, as K2
// does with JAX's K2.
//
// Any cohort, grid and substep count (the JAX kernel's domain): where the
// cohort and its table do not fit a block's shared memory, the block takes
// the individuals in tiles of as many as fit, each tile's rows copied in
// and its table summed into the same running sums s_acc, so every column
// is still summed over 0..N-1 one after another and the result is the one
// tile's bit for bit.  Where the warps' scratch (which grows with the
// grid's points and substeps) leaves no room for one individual, the block
// takes fewer warps, and where one warp's alone would not fit, every
// warp's scratch is in device memory (a workspace of restarts x warps x
// warp_scratch_floats floats that the caller allocates;
// population_sse_and_grad[_age]_workspace say how many).
//
// Shared memory: the weights (up to kSharedParams), the running sums, the
// tile's cohort rows and table, and each warp's scratch (block_floats,
// individual_floats; a wider network's warp also keeps its 32 partial rows
// of at most 129 sums there, cude_grad.cuh); 54,268 bytes (59,520 with the
// age) at N = 57 on the OGTT grid for the canonical network, so the launch
// opts in above the 48 KB default, once for each device and larger size.
// On the OGTT grid a tile holds the whole cohort up to ~900 individuals of
// the canonical network (~166 at 128 weights).
//
// Bound: latency and issue.  2,304 restarts are 2,304 blocks; each warp
// runs ~N / W lanes of warp_lane one after another, a few microseconds
// each.
//
// Numerics (cude_mlp.cuh): accurate tanhf/expf/log1pf, no contracted
// multiply-adds; the sigmoid is 1 / (1 + expf(-z)).
//
// C interface (loaded with ctypes): population_sse_and_grad (2 inputs) and
// population_sse_and_grad_age (3 inputs) take the grid constants on the
// host and, for a long-grid library (cude_mlp.cuh), in device memory, and a
// workspace (null unless population_sse_and_grad[_age]_workspace asks for
// one); they return cudaGetLastError() after the launch.  They allocate
// nothing and launch on the given stream.

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

// shared floats of one individual of a tile: its glucose, data and kinetics
// rows and its row of the table
template <int In>
long long individual_floats(int n_seg) {
  return 2LL * (n_seg + 1) + Mlp<In>::kKin + table_columns<In>();
}

// shared floats of a block besides its tile: the weights (shared_net), the
// running sums of the table's columns, and each warp's scratch where it is
// in shared memory
template <int In>
long long block_floats(int warps, long long warp_stride) {
  return (shared_net<In>() ? Mlp<In>::kParams : 0) + table_columns<In>() +
         warps * warp_stride;
}

// blocks an SM of the body: 2 for a network in registers, which caps a
// thread at 128 registers (the tile loop's few live values would otherwise
// take the 3-input body to 142 and one block an SM, 37 % slower at 2,304 x
// 57 on the H100), 1 for a wider network
template <int In>
constexpr int min_blocks() {
  return Mlp<In>::kInRegisters ? 2 : 1;
}

// kGlobalScratch: each warp's scratch is in device memory (workspace,
// warp_stride floats a warp of a block), where one warp's would not fit
template <int In, bool kGlobalScratch>
__global__ void __launch_bounds__(kThreads, min_blocks<In>())
population_sse_and_grad_kernel(const float* __restrict__ nn,       // [G, P]
                               const float* __restrict__ beta,     // [G, N]
                               const float* __restrict__ glucose,  // [N, K]
                               const float* __restrict__ data,     // [N, K]
                               const float* __restrict__ kinetics, // [N, 4|5]
                               float* __restrict__ f_out,          // [G]
                               float* __restrict__ gnn_out,        // [G, P]
                               float* __restrict__ gb_out,         // [G, N]
                               int n_ind, int tile, float inv_n,
                               const __grid_constant__ GradGrid grid,
                               long long warp_stride,
                               float* __restrict__ workspace) {
  using Net = Mlp<In>;
  constexpr int kParams = Net::kParams;
  constexpr int kKin = Net::kKin;
  constexpr int kCols = table_columns<In>();
  constexpr int kSlots = kCols - 1;  // the SSE's column
  constexpr int kPassCols = cude::pass_columns<In>();
  constexpr int kPasses = cude::passes<In>();
  extern __shared__ float smem[];
  const long long r = blockIdx.x;
  const int warps = blockDim.x / cude::kWarp;
  const int k_pts = grid.n_seg + 1;
  float* s_nn = smem;
  float* s_acc = s_nn + (shared_net<In>() ? kParams : 0);  // [kCols]
  float* s_glucose = s_acc + kCols;                       // [tile][K]
  float* s_data = s_glucose + tile * k_pts;
  float* s_kin = s_data + tile * k_pts;
  float* s_table = s_kin + tile * kKin;                    // [tile][kCols]
  float* s_scratch = s_table + tile * kCols;
  if constexpr (shared_net<In>()) {
    for (int i = threadIdx.x; i < kParams; i += blockDim.x) s_nn[i] = nn[r * kParams + i];
  }

  const int warp = threadIdx.x / cude::kWarp;
  Net mlp;
  if constexpr (shared_net<In>()) {
    __syncthreads();
    mlp.load_shared(s_nn);
  } else {
    mlp.load(nn + r * kParams);
  }
  float* scratch = kGlobalScratch
                       ? workspace + (r * warps + warp) * warp_stride
                       : s_scratch + warp * warp_stride;
  const bool one_tile = tile >= n_ind;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int lo = pass * kPassCols;  // the pass's first weight
    const int weights = (lo + kSlots < kParams ? lo + kSlots : kParams) - lo;
    const int cols = weights + (pass + 1 == kPasses);
    // the individuals in tiles of `tile`, each tile's cohort rows copied
    // into shared memory (once, when one tile holds the cohort)
    for (int n0 = 0; n0 < n_ind; n0 += tile) {
      const int here = n_ind - n0 < tile ? n_ind - n0 : tile;
      if (!one_tile || pass == 0) {
        for (int i = threadIdx.x; i < here * k_pts; i += blockDim.x) {
          s_glucose[i] = glucose[n0 * k_pts + i];
          s_data[i] = data[n0 * k_pts + i];
        }
        for (int i = threadIdx.x; i < here * kKin; i += blockDim.x)
          s_kin[i] = kinetics[n0 * kKin + i];
        __syncthreads();
      }
      for (int m = warp; m < here; m += warps) {
        const int n = n0 + m;
        const float e_beta = expf(beta[r * n_ind + n]);
        float* row = s_table + m * kCols;
        const float sse = cude::warp_lane<In>(
            mlp, e_beta, s_glucose + m * k_pts, s_data + m * k_pts,
            s_kin + kKin * m, grid, scratch, pass, pass + 1, [&](int c, float v) {
              if (c < kParams)
                row[c - lo] = v;
              else
                gb_out[r * n_ind + n] = v * e_beta * inv_n;
            });
        if (threadIdx.x % cude::kWarp == 0) row[kSlots] = sse;
      }
      __syncthreads();

      // the sums over the individuals, 0..N-1 in order, one column a
      // thread, carried from tile to tile in s_acc; the SSE's in the last
      // pass
      for (int j = threadIdx.x; j < cols; j += blockDim.x) {
        const int c = j < weights ? j : kSlots;
        float sum = n0 == 0 ? s_table[c] : s_acc[j] + s_table[c];
        for (int m = 1; m < here; ++m) sum = sum + s_table[m * kCols + c];
        s_acc[j] = sum;
      }
      __syncthreads();  // the tile's rows are free for the next tile
    }
    for (int j = threadIdx.x; j < cols; j += blockDim.x) {
      const float mean = s_acc[j] * inv_n;
      if (j < weights)
        gnn_out[r * kParams + lo + j] = mean;
      else
        f_out[r] = isfinite(mean) ? mean : INFINITY;
    }
    __syncthreads();  // s_acc is free for the next pass
  }
}

// The launch's layout: warps a block (kRestartWarps, halved while the
// block's scratch and one individual would not fit the card's shared
// memory), whether the scratch is in device memory (one warp's does not
// fit), the individuals of a tile (the whole cohort where it fits) and the
// floats of workspace.  Returns 0 or a CUDA error.
template <int In>
int layout(long long restarts, int n_ind, int n_seg, int substeps, int* warps,
           bool* global, int* tile, long long* workspace_floats) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long stride = cude::warp_scratch_floats<In>(n_seg, substeps);
  const long long per_ind = individual_floats<In>(n_seg);
  const long long fits = most / static_cast<long long>(sizeof(float));
  *global = block_floats<In>(1, stride) + per_ind > fits;
  *warps = kRestartWarps;
  while (!*global && *warps > 1 &&
         block_floats<In>(*warps, stride) + per_ind > fits)
    *warps /= 2;
  const long long room = fits - block_floats<In>(*global ? 0 : *warps, stride);
  const long long most_ind = room / per_ind;
  *tile = most_ind < n_ind ? static_cast<int>(most_ind) : n_ind;
  *workspace_floats = *global ? restarts * *warps * stride : 0;
  return 0;
}

template <int In>
int launch(const float* nn, const float* beta, const float* glucose,
           const float* data, const float* kinetics, float* f, float* gnn,
           float* gb, long long restarts, int n_ind,
           const float* consts,      // host, see lane_grad.py::grid_constants
           const float* consts_dev,  // the same in device memory, a long grid's
           int n_seg, int substeps, int j0, float inv_n, float* workspace,
           void* stream) {
  GradGrid grid;
  if (!cude::make_grad_grid(consts, consts_dev, n_seg, substeps, j0, &grid) ||
      n_ind < 1 || restarts > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (restarts <= 0) return 0;
  int warps = 0, tile = 0;
  bool global = false;
  long long need = 0;
  int err = layout<In>(restarts, n_ind, n_seg, substeps, &warps, &global,
                       &tile, &need);
  if (err != 0) return err;
  if (global && workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long stride = cude::warp_scratch_floats<In>(n_seg, substeps);
  const size_t shared =
      sizeof(float) * (block_floats<In>(global ? 0 : warps, stride) +
                       tile * individual_floats<In>(n_seg));
  const unsigned int blocks = static_cast<unsigned int>(restarts);
  if (global) {
    static std::atomic<size_t> allowed[cude::kMaxDevices];
    err = cude::allow_shared(population_sse_and_grad_kernel<In, true>, shared, allowed);
    if (err != 0) return err;
    population_sse_and_grad_kernel<In, true><<<blocks, warps * cude::kWarp, shared,
                                               static_cast<cudaStream_t>(stream)>>>(
        nn, beta, glucose, data, kinetics, f, gnn, gb, n_ind, tile, inv_n, grid,
        stride, workspace);
  } else {
    static std::atomic<size_t> allowed[cude::kMaxDevices];
    err = cude::allow_shared(population_sse_and_grad_kernel<In, false>, shared, allowed);
    if (err != 0) return err;
    population_sse_and_grad_kernel<In, false><<<blocks, warps * cude::kWarp, shared,
                                                static_cast<cudaStream_t>(stream)>>>(
        nn, beta, glucose, data, kinetics, f, gnn, gb, n_ind, tile, inv_n, grid,
        stride, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int In>
long long scratch_need(long long restarts, int n_ind, int n_seg, int substeps) {
  int warps = 0, tile = 0;
  bool global = false;
  long long need = 0;
  if (n_ind < 1 || n_seg < 1 || substeps < 1 ||
      layout<In>(restarts, n_ind, n_seg, substeps, &warps, &global, &tile,
                 &need) != 0)
    return -1;
  return need;
}

}  // namespace

extern "C" int population_sse_and_grad(const float* nn, const float* beta,
                                       const float* glucose, const float* data,
                                       const float* kinetics, float* f,
                                       float* gnn, float* gb,
                                       long long restarts, int n_ind,
                                       const float* consts,
                                       const float* consts_dev, int n_seg,
                                       int substeps, int j0, float inv_n,
                                       float* workspace, void* stream) {
  return launch<2>(nn, beta, glucose, data, kinetics, f, gnn, gb, restarts,
                   n_ind, consts, consts_dev, n_seg, substeps, j0, inv_n,
                   workspace, stream);
}

extern "C" long long population_sse_and_grad_workspace(long long restarts,
                                                       int n_ind, int n_seg,
                                                       int substeps) {
  return scratch_need<2>(restarts, n_ind, n_seg, substeps);
}

extern "C" int population_sse_and_grad_age(const float* nn, const float* beta,
                                           const float* glucose,
                                           const float* data,
                                           const float* kinetics, float* f,
                                           float* gnn, float* gb,
                                           long long restarts, int n_ind,
                                           const float* consts,
                                           const float* consts_dev, int n_seg,
                                           int substeps, int j0, float inv_n,
                                           float* workspace, void* stream) {
  return launch<3>(nn, beta, glucose, data, kinetics, f, gnn, gb, restarts,
                   n_ind, consts, consts_dev, n_seg, substeps, j0, inv_n,
                   workspace, stream);
}

extern "C" long long population_sse_and_grad_age_workspace(long long restarts,
                                                           int n_ind,
                                                           int n_seg,
                                                           int substeps) {
  return scratch_need<3>(restarts, n_ind, n_seg, substeps);
}
