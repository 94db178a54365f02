// One fused D2Q9-BGK timestep for NVIDIA Hopper (sm_90a).
//
// Replaces: advanced_hpc_lbm_tpu/ops/pallas_step.py `_step_kernel` (the
// per-step Pallas kernel behind `pallas_fused_step`).  It computes what that
// kernel computes: forcing of row ny-2 with the positivity guard, periodic
// pull-stream, bounce-back on obstacles, pairwise BGK collision, and the sum
// of ||u|| over fluid cells from the pre-collision moments.  It is a new
// design for the GPU, not the Pallas tiling carried over:
//
// * One thread per cell in 32x8 blocks, so that each of the 9 plane reads
//   and writes is coalesced along x.  Pulls come straight from global memory
//   at ((y - CY[k]) mod ny, (x - CX[k]) mod nx); any (ny, nx) is taken and
//   the ragged edge is masked.  Blocks run concurrently in no order, so
//   nothing carries from one block to another (the Pallas kernel parks halo
//   rows in scratch across a sequential grid).
// * Forcing at read time: the Pallas kernel forces its copy of row ny-2 in
//   place before streaming.  Here a thread whose pull source lies on row
//   ny-2 evaluates the guard at that source cell and adds the increment to
//   the pulled value.  No pre-pass, no in-place write.
// * Out of place: f is read, out is written; the caller ping-pongs two
//   buffers.  ||u|| is reduced deterministically, with no float atomics:
//   each block tree-reduces its cells in shared memory and writes one
//   partial; the caller sums the partials.
//
// Bound on this card: each cell moves 73 bytes of device memory per step
// (9 float32 reads + 9 writes + the 1-byte mask), so a 1024x1024 step moves
// 76.5 MB and takes at least about 23 us at the H100's 3.35 TB/s.  The
// neighbour reads of a block mostly hit L1/L2, so only the first touch of
// each plane row costs device memory.  This version seeks correctness, not
// that bound: shared-memory tiles, a persistent kernel and CUDA graphs are
// later work.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC

#include <cstdint>

#include "step_common.cuh"

namespace {

constexpr int kBlockX = lbm::kTileX;
constexpr int kBlockY = lbm::kTileY;
constexpr int kThreads = kBlockX * kBlockY;

__global__ void __launch_bounds__(kThreads)
    step_kernel(const float* __restrict__ f, float* __restrict__ out,
                const uint8_t* __restrict__ mask, float* __restrict__ partials,
                int ny, int nx, lbm::StepConsts c) {
  __shared__ float red[kThreads];
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const lbm::GlobalState src{f, mask, static_cast<size_t>(ny) * nx, nx, ny - 2};

  float norm = 0.0f;
  if (x < nx && y < ny) norm = lbm::global_cell_step(src, out, y, x, ny, c);

  // deterministic block sum of ||u||
  const float total = lbm::block_sum(norm, red, tid, kThreads);
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

}  // namespace

// The thread-block shape; the wrapper sizes the partials row from it.
extern "C" void lbm_step_block_shape(int* block_x, int* block_y) {
  *block_x = kBlockX;
  *block_y = kBlockY;
}

// The runtime's name for an error code the other entry points returned.
extern "C" const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Loads the kernel onto the current device without launching it (module
// loading is lazy), so that a run's first step pays no load.
extern "C" int lbm_step_prepare(void) {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, step_kernel));
}

// One step: out = step(f).  `partials` receives one float per block, in
// row-major block order.  Launches on `stream`; returns the launch's
// cudaError_t (0 = launched).
extern "C" int lbm_step(const float* f, float* out, const uint8_t* mask,
                        float* partials, int ny, int nx, float w0_omega,
                        float w1_omega, float w2_omega, float one_minus_omega,
                        float accel_w1, float accel_w2, void* stream) {
  const lbm::StepConsts c{w0_omega, w1_omega,  w2_omega,
                          one_minus_omega, accel_w1, accel_w2};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY);
  step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      f, out, mask, partials, ny, nx, c);
  return static_cast<int>(cudaGetLastError());
}
