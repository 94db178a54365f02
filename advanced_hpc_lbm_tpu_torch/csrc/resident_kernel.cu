// A whole chunk of D2Q9-BGK timesteps in one launch: a cooperative
// persistent kernel for NVIDIA Hopper (sm_90a).
//
// Replaces: advanced_hpc_lbm_tpu/ops/resident.py `_chunk_kernel` (the
// whole-run Pallas kernel behind the `resident` backend).  On the TPU one
// core runs the whole chunk with the state in VMEM, and its grid of one
// program needs no barrier between steps.  Here the state ping-pongs
// between two buffers in device memory and every SM takes part:
//
// * One cooperative launch per chunk (cudaLaunchCooperativeKernel).  The
//   grid is as large as can be co-resident (occupancy x SMs), capped at the
//   tile count; each block walks the step kernel's 32x8 tiles grid-stride
//   and runs the shared per-cell step (step_common.cuh).  A grid barrier
//   (cooperative_groups::this_grid().sync()) separates the steps.  Every
//   block runs every step and reaches every barrier: no early return.
// * Per step, one ||u|| partial per tile into partials[t, tile], in the
//   step kernel's row-major tile order and with its block reduction, so
//   that the caller's torch.sum(dim=1) gives the step backend's av history
//   bit for bit; the state itself is bitwise that of the step kernel.
// * The state is read with plain loads (no read-only cache): a buffer is
//   read after other blocks wrote it, across a barrier.
//
// Bound on this card: the launch latency and the host loop disappear (one
// launch per chunk instead of one per step); what is left per step is the
// step's traffic (73 B/cell) plus one grid barrier of a few microseconds.
// The pair of buffers (72 B/cell) fits in the 50 MB L2 up to about 690 000
// cells, so every reference deck up to 256x256 runs from L2; the 1024x1024
// pair is 75.5 MB and does not fit.  Shared-memory tiles and a state held
// in a cluster's distributed shared memory are later work.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC  (no -rdc: grid
//   sync needs none on CUDA >= 11)

#include <cooperative_groups.h>

#include <cstdint>

#include "step_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = lbm::kTileX * lbm::kTileY;

__global__ void __launch_bounds__(kThreads)
    resident_kernel(float* a, float* b, const uint8_t* mask, float* partials,
                    int ny, int nx, int n_steps, lbm::StepConsts c) {
  __shared__ float red[kThreads];
  cg::grid_group grid = cg::this_grid();
  const int tiles_x = (nx + lbm::kTileX - 1) / lbm::kTileX;
  const int tiles = tiles_x * ((ny + lbm::kTileY - 1) / lbm::kTileY);
  const int tid = threadIdx.y * lbm::kTileX + threadIdx.x;
  const size_t plane = static_cast<size_t>(ny) * nx;

  for (int t = 0; t < n_steps; ++t) {
    // step t reads the buffer that step t-1 wrote
    const float* src_f = (t % 2 == 0) ? a : b;
    float* dst = (t % 2 == 0) ? b : a;
    const lbm::GlobalState<false> src{src_f, mask, plane, nx, ny - 2};
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int x = (tile % tiles_x) * lbm::kTileX + threadIdx.x;
      const int y = (tile / tiles_x) * lbm::kTileY + threadIdx.y;
      float norm = 0.0f;
      if (x < nx && y < ny) norm = lbm::global_cell_step(src, dst, y, x, ny, c);
      const float total = lbm::block_sum(norm, red, tid, kThreads);
      if (tid == 0) partials[static_cast<size_t>(t) * tiles + tile] = total;
    }
    grid.sync();
  }
}

// The grid of a cooperative launch: as many blocks as can be co-resident,
// no more than there are tiles.
cudaError_t grid_blocks(int ny, int nx, int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int tiles = ((nx + lbm::kTileX - 1) / lbm::kTileX) *
                    ((ny + lbm::kTileY - 1) / lbm::kTileY);
  *blocks = per_sm * sms < tiles ? per_sm * sms : tiles;
  return cudaSuccess;
}

}  // namespace

// Loads the kernel onto the current device without launching it and checks
// that the device takes cooperative launches.
extern "C" int lbm_resident_prepare(void) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, resident_kernel);
  if (err != cudaSuccess) return lbm::status(err);
  int blocks = 0;
  return lbm::status(grid_blocks(1, 1, &blocks));
}

// n_steps steps on the state in `a`, ping-ponging with `b`: the state ends
// in `a` for an even n_steps, in `b` for an odd one.  partials is
// (n_steps, tiles) float32, tiles = ceil(ny/8) * ceil(nx/32).  `blocks` is
// 0 (the co-resident limit) except in the test of a refused launch, where
// a grid larger than can be co-resident is refused with
// cudaErrorCooperativeLaunchTooLarge.  Launches on `stream`;
// returns the launch's cudaError_t (0 = launched).
extern "C" int lbm_resident_chunk(float* a, float* b, const uint8_t* mask,
                                  float* partials, int ny, int nx,
                                  int n_steps, int blocks, float w0_omega,
                                  float w1_omega, float w2_omega,
                                  float one_minus_omega, float accel_w1,
                                  float accel_w2, void* stream) {
  if (blocks <= 0) {
    const cudaError_t err = grid_blocks(ny, nx, &blocks);
    if (err != cudaSuccess) return lbm::status(err);
  }
  lbm::StepConsts c{w0_omega,        w1_omega, w2_omega,
                    one_minus_omega, accel_w1, accel_w2};
  void* args[] = {&a, &b, &mask, &partials, &ny, &nx, &n_steps, &c};
  return lbm::status(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(resident_kernel), dim3(blocks),
      dim3(lbm::kTileX, lbm::kTileY), args, 0,
      static_cast<cudaStream_t>(stream)));
}
