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

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;

// Pull plane k from (sy, sx), adding the forcing increment `dv` when the
// source lies on the forcing row and passes the guard there.  The plain
// version forces the whole plane before rolling and adds 0 elsewhere; so
// does this.
__device__ __forceinline__ float forced_pull(const float* __restrict__ f,
                                             const uint8_t* __restrict__ mask,
                                             size_t plane, int k, int sy,
                                             int sx, int nx, int accel_row,
                                             float dv,
                                             const lbm::StepConsts& c) {
  const size_t i = static_cast<size_t>(sy) * nx + sx;
  float d = 0.0f;
  if (sy == accel_row &&
      lbm::forcing_ok(mask[i] != 0, f[3 * plane + i], f[6 * plane + i],
                      f[7 * plane + i], c)) {
    d = dv;
  }
  return f[k * plane + i] + d;
}

__global__ void __launch_bounds__(kThreads)
    step_kernel(const float* __restrict__ f, float* __restrict__ out,
                const uint8_t* __restrict__ mask, float* __restrict__ partials,
                int ny, int nx, lbm::StepConsts c) {
  __shared__ float red[kThreads];
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;

  float norm = 0.0f;
  if (x < nx && y < ny) {
    const size_t plane = static_cast<size_t>(ny) * nx;
    const int accel_row = ny - 2;
    // source columns/rows of the pull, with periodic wrap
    const int xe = (x == 0) ? nx - 1 : x - 1;  // east-moving speeds pull from x-1
    const int xw = (x == nx - 1) ? 0 : x + 1;  // west-moving speeds pull from x+1
    const int yn = (y == 0) ? ny - 1 : y - 1;  // north-moving speeds pull from y-1
    const int ys = (y == ny - 1) ? 0 : y + 1;  // south-moving speeds pull from y+1
    const float w1 = c.accel_w1, w2 = c.accel_w2;

    float s[9];
    s[0] = f[static_cast<size_t>(y) * nx + x];
    s[1] = forced_pull(f, mask, plane, 1, y, xe, nx, accel_row, w1, c);
    s[2] = f[2 * plane + static_cast<size_t>(yn) * nx + x];
    s[3] = forced_pull(f, mask, plane, 3, y, xw, nx, accel_row, -w1, c);
    s[4] = f[4 * plane + static_cast<size_t>(ys) * nx + x];
    s[5] = forced_pull(f, mask, plane, 5, yn, xe, nx, accel_row, w2, c);
    s[6] = forced_pull(f, mask, plane, 6, yn, xw, nx, accel_row, -w2, c);
    s[7] = forced_pull(f, mask, plane, 7, ys, xw, nx, accel_row, -w2, c);
    s[8] = forced_pull(f, mask, plane, 8, ys, xe, nx, accel_row, w2, c);

    const size_t i = static_cast<size_t>(y) * nx + x;
    const bool obst = mask[i] != 0;
    const float u_sq = lbm::collide(s, obst, c);
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k * plane + i] = s[k];
    norm = obst ? 0.0f : sqrtf(u_sq);
  }

  // deterministic block sum of ||u||: every thread takes part, so that the
  // barriers are reached by the whole block
  red[tid] = norm;
  __syncthreads();
#pragma unroll
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red[tid] = red[tid] + red[tid + stride];
    __syncthreads();
  }
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
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
