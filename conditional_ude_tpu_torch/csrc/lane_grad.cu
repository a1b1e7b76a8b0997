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
// so a block needs at most ~78 KB of shared memory at any width and opts
// in above 48 KB.  The warp sums the partial gradients in a fixed order
// (cude_grad.cuh) and writes gnn[lane] in one coalesced row.  The mean over
// individuals runs outside the kernel.
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
// lane_sse_and_grad_age (3 inputs) return cudaGetLastError() after the
// launch, or minus the bytes of shared memory a block would need where the
// card has fewer (ops/cuda_build.py raises ValueError for that).  They
// allocate nothing and launch on the given stream.

#include "cude_grad.cuh"

namespace {

using cude::GradGrid;
using cude::kMaxTimepoints;
using cude::Mlp;

// lanes (warps) a block: 4 beat 8 on the H100 at 1,425 and 131,328 lanes
constexpr int kLaneWarps = 4;
constexpr int kThreads = kLaneWarps * cude::kWarp;

// shared floats of one warp: glucose and data rows, then warp_lane's scratch
template <int In>
int warp_floats(int n_seg, int substeps) {
  return 2 * kMaxTimepoints + cude::warp_scratch_floats<In>(n_seg, substeps);
}

template <int In>
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
                         int warp_stride) {
  using Net = Mlp<In>;
  constexpr int kParams = Net::kParams;
  extern __shared__ float smem[];
  const int warp = threadIdx.x / cude::kWarp;
  const int t = threadIdx.x % cude::kWarp;
  const long long lane = blockIdx.x * static_cast<long long>(kLaneWarps) + warp;
  if (lane >= lanes) return;  // the whole warp
  const long long r = lane / n_ind;
  const int n = static_cast<int>(lane - r * n_ind);
  const int k_pts = grid.n_seg + 1;
  float* g = smem + warp * warp_stride;
  float* d = g + kMaxTimepoints;
  if (t < k_pts) {
    g[t] = glucose[n * k_pts + t];
    d[t] = data[n * k_pts + t];
  }
  Net mlp;
  mlp.load(nn + r * kParams);
  const float e_beta = expf(beta[lane]);
  __syncwarp();
  const float sse = cude::warp_lane<In>(
      mlp, e_beta, g, d, kinetics + Net::kKin * n, grid, d + kMaxTimepoints,
      0, cude::passes<In>(), [&](int c, float v) {
        if (c < kParams)
          gnn_out[lane * kParams + c] = v;
        else
          gb_out[lane] = v * e_beta;
      });
  if (t == 0) sse_out[lane] = sse;
}

template <int In>
int launch(const float* nn, const float* beta, const float* glucose,
           const float* data, const float* kinetics, float* sse, float* gnn,
           float* gb, long long lanes, int n_ind,
           const float* consts,  // host, see lane_grad.py
           int n_seg, int substeps, int j0, void* stream) {
  GradGrid grid;
  if (!cude::make_grad_grid(consts, n_seg, substeps, j0, &grid) || n_ind < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes <= 0) return 0;
  const int warp_stride = warp_floats<In>(n_seg, substeps);
  // the canonical network's is at most ~24 KB at the limits of
  // make_grad_grid, a wider one's at most ~78 KB (its partial rows opt in)
  const size_t shared = sizeof(float) * kLaneWarps * warp_stride;
  static std::atomic<size_t> allowed[cude::kMaxDevices];
  const int err = cude::allow_shared(lane_sse_and_grad_kernel<In>, shared, allowed);
  if (err != 0) return err;
  const long long blocks = (lanes + kLaneWarps - 1) / kLaneWarps;
  lane_sse_and_grad_kernel<In><<<static_cast<unsigned int>(blocks), kThreads,
                                 shared, static_cast<cudaStream_t>(stream)>>>(
      nn, beta, glucose, data, kinetics, sse, gnn, gb, lanes, n_ind, grid,
      warp_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lane_sse_and_grad(const float* nn, const float* beta,
                                 const float* glucose, const float* data,
                                 const float* kinetics, float* sse,
                                 float* gnn, float* gb, long long lanes,
                                 int n_ind, const float* consts, int n_seg,
                                 int substeps, int j0, void* stream) {
  return launch<2>(nn, beta, glucose, data, kinetics, sse, gnn, gb, lanes,
                   n_ind, consts, n_seg, substeps, j0, stream);
}

extern "C" int lane_sse_and_grad_age(const float* nn, const float* beta,
                                     const float* glucose, const float* data,
                                     const float* kinetics, float* sse,
                                     float* gnn, float* gb, long long lanes,
                                     int n_ind, const float* consts, int n_seg,
                                     int substeps, int j0, void* stream) {
  return launch<3>(nn, beta, glucose, data, kinetics, sse, gnn, gb, lanes,
                   n_ind, consts, n_seg, substeps, j0, stream);
}
