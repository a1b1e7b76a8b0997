// Population mean SSE per restart (the screening pass of joint cUDE
// training), for Hopper (sm_90a).
//
// Replaces the TPU kernel
// conditional_ude_tpu/ops/pallas_rk4.py::_build_population_kernel (reached
// through population_sse_pallas), both of its bodies, at every network it
// takes (cude_mlp.cuh): a restart is one network of P weights on
// [dG, e^beta], or on [dG, e^beta, age] for the covariate model, and one
// beta per individual (37 and 41 weights for the canonical chain(4, 2)).
// For each restart the kernel integrates every individual's 2-state
// c-peptide ODE with fixed-step RK4 over the shared observation grid and
// returns the mean over individuals of the SSE at the save points, +inf
// where the mean is not finite.
//
// Design: one thread per (restart, individual) lane, and a block holds whole
// restarts: max(1, kRounds kBlock / N) of them, which its kBlock threads
// take in kRounds rounds (13 restarts of 57 individuals fill 741 of 768
// thread slots, where 4 restarts in one round of 256 fill 228).  The cohort
// (glucose, data and kinetics, N x (2K + 4|5) floats) is read once per
// block into shared memory where it and the block's SSEs fit the 48 KB a
// launch gets without opting in (819 individuals on the OGTT grid);
// otherwise (more individuals, or a long grid) each lane reads its own rows
// from device memory, through L1, and the block takes its lanes in chunks
// of at most kChunk, a restart of more individuals summed chunk after chunk
// into one running total: the same sums in the same order, so any cohort
// and grid give the one-chunk result.  Each lane takes its e^beta
// (as the TPU kernel takes it) and its SSE from cude_rk4.cuh's lane_sse,
// with the network at the lane's 69 points, and writes the SSE to shared
// memory; then one thread per restart adds the N SSEs from individual 0 to
// N - 1 and multiplies by 1/N, the order of the TPU kernel's loop and of
// the plain version, so K1 is also exactly the in-order mean of K4's lanes.
// A thread of the canonical network reads its restart's weights into
// registers by read-only loads that the lanes of a restart share; a wider
// network's weights (more than cude::kRegisterParams) are read from device
// memory where they are used, through L1, which the restart's lanes share
// as they share the canonical loads, so no width changes the block's
// shared memory.  These choices are the fastest of the layouts timed at
// 25,000 and 400,000 restarts x 57 (PERF.md) for the canonical network.
//
// Bound: instruction throughput.  The flagship screen is 25,000 restarts x 57
// individuals, 1,425,000 lanes of 69 network evaluations; the bytes moved
// (~P + 57 floats a restart) are negligible.  An accurate tanhf is one
// exp2 and one reciprocal on the SFU and ~20 instructions on the FMA pipe,
// so an evaluation of the canonical network is ~220 instructions (an RK4
// step, two evaluations and the stage arithmetic, is ~506 in SASS), and a
// lane ~17,000: ~0.77 ms of warp instructions at 4 a clock on 132 SMs,
// where the 10 transcendentals an evaluation alone would take 0.24 ms.  A
// wider network scales both with its tanh count and its weights.
//
// Numerics (cude_mlp.cuh): accurate tanhf/expf/log1pf, no contracted
// multiply-adds; the operations and their order are those of
// conditional_ude_tpu_torch/ops/rk4_population.py::population_sse_reference.
//
// C interface (loaded with ctypes): rk4_population_sse (2 inputs) and
// rk4_population_sse_age (3 inputs) take the segment rows on the host and,
// for a long-grid library (cude_mlp.cuh), in device memory, and return
// cudaGetLastError() after the launch.  They allocate nothing and launch on
// the given stream.

#include "cude_rk4.cuh"

namespace {

using cude::Grid;
using cude::Mlp;

constexpr int kBlock = 256;  // threads a block, at most
constexpr int kRounds = 3;   // lanes a block: kRounds kBlock
constexpr int kChunk = kRounds * kBlock;
constexpr size_t kStaticShared = 48 * 1024;

// kSharedCohort: the cohort is in shared memory and the SSE table holds
// every lane of the block (one chunk); else each lane reads its own rows from
// device memory and the block's lanes are taken in chunks of at most kChunk
template <int In, bool kSharedCohort>
__global__ void __launch_bounds__(kBlock)
rk4_population_sse_kernel(const float* __restrict__ nn,       // [G, P]
                          const float* __restrict__ beta,     // [G, N]
                          const float* __restrict__ glucose,  // [N, K]
                          const float* __restrict__ data,     // [N, K]
                          const float* __restrict__ kinetics, // [N, 4|5]
                          float* __restrict__ out,            // [G]
                          long long restarts, int n_ind, int per_block,
                          int chunk, float inv_n, const Grid grid) {
  using Net = Mlp<In>;
  constexpr int kKin = Net::kKin;
  constexpr int kParams = Net::kParams;
  extern __shared__ float smem[];
  const int k_pts = grid.n_seg + 1;
  const float* c_glucose = glucose;
  const float* c_data = data;
  const float* c_kin = kinetics;
  float* s_sse = smem;  // [chunk]
  const long long first = blockIdx.x * static_cast<long long>(per_block);
  const long long left = restarts - first;
  const int here = left < per_block ? static_cast<int>(left) : per_block;

  if constexpr (kSharedCohort) {
    float* s_glucose = smem;
    float* s_data = s_glucose + n_ind * k_pts;
    float* s_kin = s_data + n_ind * k_pts;
    s_sse = s_kin + n_ind * kKin;  // [per_block][N]
    for (int i = threadIdx.x; i < n_ind * k_pts; i += blockDim.x) {
      s_glucose[i] = glucose[i];
      s_data[i] = data[i];
    }
    for (int i = threadIdx.x; i < n_ind * kKin; i += blockDim.x) s_kin[i] = kinetics[i];
    __syncthreads();
    c_glucose = s_glucose;
    c_data = s_data;
    c_kin = s_kin;
  }

  // a restart of more than kChunk individuals (per_block 1) is summed over
  // its chunks by thread 0 into one running total
  const int lanes_here = here * n_ind;
  float total = 0.0f;
  for (int base = 0; base < lanes_here; base += chunk) {
    const int end = base + chunk < lanes_here ? base + chunk : lanes_here;
    for (int l = base + threadIdx.x; l < end; l += blockDim.x) {
      const int lr = l / n_ind;
      const int n = l - lr * n_ind;
      const long long r = first + lr;
      Net mlp;
      mlp.load(nn + r * kParams);
      const float e_beta = expf(beta[r * n_ind + n]);
      s_sse[l - base] = cude::lane_sse<In>(mlp, e_beta, c_glucose + n * k_pts,
                                           c_data + n * k_pts, c_kin + n * kKin,
                                           grid);
    }
    __syncthreads();

    if (chunk >= lanes_here) {
      // the mean of each restart, its individuals added first to last
      for (int lr = threadIdx.x; lr < here; lr += blockDim.x) {
        const float* sse = s_sse + lr * n_ind;
        float sum = sse[0];
        for (int n = 1; n < n_ind; ++n) sum = sum + sse[n];
        const float mean = sum * inv_n;
        out[first + lr] = isfinite(mean) ? mean : INFINITY;
      }
    } else if (threadIdx.x == 0) {
      // the chunk's individuals added to the total in order
      for (int i = 0; i < end - base; ++i)
        total = base + i == 0 ? s_sse[0] : total + s_sse[i];
    }
    __syncthreads();  // the table is free for the next chunk
  }
  if (chunk < lanes_here && threadIdx.x == 0) {
    const float mean = total * inv_n;
    out[first] = isfinite(mean) ? mean : INFINITY;
  }
}

template <int In>
int launch(const float* nn, const float* beta, const float* glucose,
           const float* data, const float* kinetics, float* out,
           long long restarts, int n_ind,
           const float* segments,      // host [n_seg, 5]
           const float* segments_dev,  // device [n_seg, 5], a long grid's
           int n_seg, int substeps, int j0, float one_minus_w0, float w0,
           float inv_n, void* stream) {
  Grid grid;
  if (!cude::make_grid(segments, segments_dev, n_seg, substeps, j0,
                       one_minus_w0, w0, &grid) ||
      n_ind < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = n_ind < kChunk ? kChunk / n_ind : 1;
  const int lanes = per_block * n_ind;
  // the cohort and every lane's SSE in shared memory where they fit the
  // 48 KB a launch gets without opting in, else the SSEs of a chunk only
  const size_t cohort_shared =
      sizeof(float) * (static_cast<size_t>(n_ind) * (2 * (n_seg + 1) + Mlp<In>::kKin) +
                       static_cast<size_t>(lanes));
  const bool shared_cohort = cohort_shared <= kStaticShared;
  const int chunk = shared_cohort || lanes < kChunk ? lanes : kChunk;
  const size_t shared = shared_cohort ? cohort_shared : sizeof(float) * chunk;
  if (restarts <= 0) return 0;
  const int threads = lanes < kBlock ? (lanes + 31) / 32 * 32 : kBlock;
  const long long blocks = (restarts + per_block - 1) / per_block;
  const auto kernel = shared_cohort ? rk4_population_sse_kernel<In, true>
                                    : rk4_population_sse_kernel<In, false>;
  kernel<<<static_cast<unsigned int>(blocks), threads, shared,
           static_cast<cudaStream_t>(stream)>>>(
      nn, beta, glucose, data, kinetics, out, restarts, n_ind, per_block,
      chunk, inv_n, grid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rk4_population_sse(const float* nn, const float* beta,
                                  const float* glucose, const float* data,
                                  const float* kinetics, float* out,
                                  long long restarts, int n_ind,
                                  const float* segments,
                                  const float* segments_dev, int n_seg,
                                  int substeps, int j0, float one_minus_w0,
                                  float w0, float inv_n, void* stream) {
  return launch<2>(nn, beta, glucose, data, kinetics, out, restarts, n_ind,
                   segments, segments_dev, n_seg, substeps, j0, one_minus_w0,
                   w0, inv_n, stream);
}

extern "C" int rk4_population_sse_age(const float* nn, const float* beta,
                                      const float* glucose, const float* data,
                                      const float* kinetics, float* out,
                                      long long restarts, int n_ind,
                                      const float* segments,
                                      const float* segments_dev, int n_seg,
                                      int substeps, int j0, float one_minus_w0,
                                      float w0, float inv_n, void* stream) {
  return launch<3>(nn, beta, glucose, data, kinetics, out, restarts, n_ind,
                   segments, segments_dev, n_seg, substeps, j0, one_minus_w0,
                   w0, inv_n, stream);
}
