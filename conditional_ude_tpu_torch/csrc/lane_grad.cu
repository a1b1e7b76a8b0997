// Per-lane SSE of the conditional c-peptide model with its exact discrete
// gradient (the value+grad of every refinement step of joint cUDE
// training), for Hopper (sm_90a).
//
// Replaces the TPU kernel
// conditional_ude_tpu/ops/pallas_grad.py::_build_lane_grad_kernel (reached
// through population_sse_and_grad_pallas / fused_population_vg), both of its
// bodies, at every network it takes (cude_mlp.cuh): P weights on
// [dG, e^beta] or, for the covariate model, on [dG, e^beta, age] (the age is
// the 5th column of the individual's kinetics row; 37 and 41 weights for the
// canonical chain(4, 2)).  A lane is one (restart, individual) pair.  The
// production term does not depend on the state, so the ODE is affine in it
// and one RK4 step is
//   v <- R v + M_a r(t) + M_mid r(t + dt/2) + M_d r(t + dt)
// with 2x2 stage matrices of the kinetics.  The forward pass needs the
// network at 1 + n_seg (2 substeps + 1) points (69 on the OGTT grid; point 0
// is the dG = 0 baseline) and gives the residuals at the save times; the
// adjoint recursion over the residuals gives each point's weight (the
// baseline's is minus their sum); one hand VJP per point gives the
// gradient of the P weights and of beta.  The age is an input, not a
// parameter: it adds sum dz1[o] * age to w1[o][2]'s gradient and leaves the
// beta cotangent as it is (pallas_grad.py:457-471).
//
// Design: one warp per lane (cude_grad.cuh, warp_lane), kLaneWarps (4)
// warps a block, each warp with its own slice of shared memory: its individual's
// glucose and data rows, the residuals, the stage matrices and one row that
// holds the 69 network outputs, then the 69 point weights, then the 32
// threads' partial sums of the gradient.  The 69 forward evaluations and
// the 69 recomputing VJPs (a tanhf a hidden unit and the head each) are
// spread over the warp's threads, three rounds of each, where one thread
// used to run all 138 in a chain; the two 32-step 2x2 recursions run in
// every thread of the warp from shared memory.  The canonical network's
// weights are read by every thread of its warp into registers, and each
// thread sums its points' gradients in registers; a wider network's
// weights are read where they are used (the warp's threads read one
// address at a time), and each thread sums into its own row of shared
// memory beside the point weights, 32 rows of at most 129 floats a warp:
// past 127 weights the columns are summed in passes of 128 (cude_grad.cuh),
// so on a short grid at up to 16 substeps a block needs at most ~78 KB of
// shared memory at any width and opts in above 48 KB.  The warp sums the
// partial gradients in a fixed order (cude_grad.cuh) and writes gnn[lane]
// in one coalesced row.  The mean over individuals runs outside the kernel.
//
// Any grid and substep count: a warp's scratch grows with the grid's points
// and substeps (1 + n_seg (2 substeps + 1) points; 2,041 at 121 points and 8
// substeps), so the launch halves the warps of a block until the block fits
// the card's shared memory, and where one warp's scratch alone would not
// fit, keeps every warp's scratch in device memory (a workspace of
// lanes x warp_floats floats that the caller allocates; the *_workspace
// entry points say how many).  The arithmetic and its order are the same
// in every layout.
//
// Bound: latency and issue.  The flagship refinement runs 25 restarts x 57
// individuals = 1,425 lanes: 1,425 warps, ~11 on each of the 132 SMs, each
// a chain of ~6 network evaluations and two 32-step recursions; the
// launches sit between host-side optimizer steps.  The function's least
// work (one forward and one VJP per point) is far below what the card
// could do in that time.
//
// Numerics (cude_mlp.cuh): accurate tanhf/expf/log1pf, no contracted
// multiply-adds; the sigmoid is 1 / (1 + expf(-z)).  The operations and
// their order are those of
// conditional_ude_tpu_torch/ops/lane_grad.py::lane_sse_and_grad_reference.
//
// C interface (loaded with ctypes): lane_sse_and_grad (2 inputs) and
// lane_sse_and_grad_age (3 inputs) take the grid constants on the host and,
// for a long-grid library (cude_mlp.cuh), in device memory, and a workspace
// (null unless lane_sse_and_grad[_age]_workspace asks for one); they return
// cudaGetLastError() after the launch.  They allocate nothing and launch on
// the given stream.

#include "cude_grad.cuh"

namespace {

using cude::GradGrid;
using cude::Mlp;

// lanes (warps) a block: 4 beat 8 on the H100 at 1,425 and 131,328 lanes
constexpr int kLaneWarps = 4;
constexpr int kThreads = kLaneWarps * cude::kWarp;

// shared floats of one warp: glucose and data rows, then warp_lane's scratch
template <int In>
long long warp_floats(int n_seg, int substeps) {
  return 2 * cude::time_row_floats(n_seg) + cude::warp_scratch_floats<In>(n_seg, substeps);
}

// kGlobalScratch: each warp's rows and scratch are in device memory
// (workspace, warp_stride floats a lane), where one warp's would not fit a
// block's shared memory
template <int In, bool kGlobalScratch>
__global__ void __launch_bounds__(kThreads, 1)
lane_sse_and_grad_kernel(const float* __restrict__ nn,       // [R, P]
                         const float* __restrict__ beta,     // [R * N]
                         const float* __restrict__ glucose,  // [N, K]
                         const float* __restrict__ data,     // [N, K]
                         const float* __restrict__ kinetics, // [N, 4|5]
                         float* __restrict__ sse_out,        // [R * N]
                         float* __restrict__ gnn_out,        // [R * N, P]
                         float* __restrict__ gb_out,         // [R * N]
                         long long lanes, int n_ind,
                         const __grid_constant__ GradGrid grid,
                         long long warp_stride, float* __restrict__ workspace) {
  using Net = Mlp<In>;
  constexpr int kParams = Net::kParams;
  extern __shared__ float smem[];
  const int warps = blockDim.x / cude::kWarp;
  const int warp = threadIdx.x / cude::kWarp;
  const int t = threadIdx.x % cude::kWarp;
  const long long lane = blockIdx.x * static_cast<long long>(warps) + warp;
  if (lane >= lanes) return;  // the whole warp
  const long long r = lane / n_ind;
  const int n = static_cast<int>(lane - r * n_ind);
  const int k_pts = grid.n_seg + 1;
  const int row = cude::time_row_floats(grid.n_seg);
  float* g = kGlobalScratch ? workspace + lane * warp_stride : smem + warp * warp_stride;
  float* d = g + row;
  for (int i = t; i < k_pts; i += cude::kWarp) {
    g[i] = glucose[n * k_pts + i];
    d[i] = data[n * k_pts + i];
  }
  Net mlp;
  mlp.load(nn + r * kParams);
  const float e_beta = expf(beta[lane]);
  __syncwarp();
  const float sse = cude::warp_lane<In>(
      mlp, e_beta, g, d, kinetics + Net::kKin * n, grid, d + row,
      0, cude::passes<In>(), [&](int c, float v) {
        if (c < kParams)
          gnn_out[lane * kParams + c] = v;
        else
          gb_out[lane] = v * e_beta;
      });
  if (t == 0) sse_out[lane] = sse;
}

// The launch's layout: warps a block (kLaneWarps, halved while a block's
// scratch would not fit the card's shared memory) and whether the scratch is
// in device memory (one warp's does not fit), then the floats of workspace
// that needs.  Returns 0 or a CUDA error.
template <int In>
int layout(long long lanes, int n_seg, int substeps, int* warps,
           bool* global, long long* workspace_floats) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long stride = warp_floats<In>(n_seg, substeps);
  const long long fits = most / static_cast<long long>(sizeof(float));
  *global = stride > fits;
  *warps = kLaneWarps;
  while (!*global && *warps > 1 && *warps * stride > fits) *warps /= 2;
  *workspace_floats = *global ? lanes * stride : 0;
  return 0;
}

template <int In>
int launch(const float* nn, const float* beta, const float* glucose,
           const float* data, const float* kinetics, float* sse, float* gnn,
           float* gb, long long lanes, int n_ind,
           const float* consts,      // host, see lane_grad.py
           const float* consts_dev,  // the same in device memory, a long grid's
           int n_seg, int substeps, int j0, float* workspace, void* stream) {
  GradGrid grid;
  if (!cude::make_grad_grid(consts, consts_dev, n_seg, substeps, j0, &grid) ||
      n_ind < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes <= 0) return 0;
  int warps = 0;
  bool global = false;
  long long need = 0;
  int err = layout<In>(lanes, n_seg, substeps, &warps, &global, &need);
  if (err != 0) return err;
  if (global && workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long stride = warp_floats<In>(n_seg, substeps);
  // the canonical network's is at most ~24 KB on a short grid at 16
  // substeps, a wider one's at most ~78 KB (its partial rows opt in)
  const size_t shared = global ? 0 : sizeof(float) * warps * stride;
  const long long blocks = (lanes + warps - 1) / warps;
  if (global) {
    static std::atomic<size_t> allowed[cude::kMaxDevices];
    err = cude::allow_shared(lane_sse_and_grad_kernel<In, true>, shared, allowed);
    if (err != 0) return err;
    lane_sse_and_grad_kernel<In, true><<<static_cast<unsigned int>(blocks),
                                         warps * cude::kWarp, shared,
                                         static_cast<cudaStream_t>(stream)>>>(
        nn, beta, glucose, data, kinetics, sse, gnn, gb, lanes, n_ind, grid,
        stride, workspace);
  } else {
    static std::atomic<size_t> allowed[cude::kMaxDevices];
    err = cude::allow_shared(lane_sse_and_grad_kernel<In, false>, shared, allowed);
    if (err != 0) return err;
    lane_sse_and_grad_kernel<In, false><<<static_cast<unsigned int>(blocks),
                                          warps * cude::kWarp, shared,
                                          static_cast<cudaStream_t>(stream)>>>(
        nn, beta, glucose, data, kinetics, sse, gnn, gb, lanes, n_ind, grid,
        stride, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int In>
long long scratch_need(long long lanes, int n_seg, int substeps) {
  int warps = 0;
  bool global = false;
  long long need = 0;
  if (n_seg < 1 || substeps < 1 ||
      layout<In>(lanes, n_seg, substeps, &warps, &global, &need) != 0)
    return -1;
  return need;
}

}  // namespace

extern "C" int lane_sse_and_grad(const float* nn, const float* beta,
                                 const float* glucose, const float* data,
                                 const float* kinetics, float* sse,
                                 float* gnn, float* gb, long long lanes,
                                 int n_ind, const float* consts,
                                 const float* consts_dev, int n_seg,
                                 int substeps, int j0, float* workspace,
                                 void* stream) {
  return launch<2>(nn, beta, glucose, data, kinetics, sse, gnn, gb, lanes,
                   n_ind, consts, consts_dev, n_seg, substeps, j0, workspace,
                   stream);
}

extern "C" long long lane_sse_and_grad_workspace(long long lanes, int n_seg,
                                                 int substeps) {
  return scratch_need<2>(lanes, n_seg, substeps);
}

extern "C" int lane_sse_and_grad_age(const float* nn, const float* beta,
                                     const float* glucose, const float* data,
                                     const float* kinetics, float* sse,
                                     float* gnn, float* gb, long long lanes,
                                     int n_ind, const float* consts,
                                     const float* consts_dev, int n_seg,
                                     int substeps, int j0, float* workspace,
                                     void* stream) {
  return launch<3>(nn, beta, glucose, data, kinetics, sse, gnn, gb, lanes,
                   n_ind, consts, consts_dev, n_seg, substeps, j0, workspace,
                   stream);
}

extern "C" long long lane_sse_and_grad_age_workspace(long long lanes,
                                                     int n_seg, int substeps) {
  return scratch_need<3>(lanes, n_seg, substeps);
}
