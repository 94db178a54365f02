// One D2Q9-BGK timestep on one shard of a device mesh, for NVIDIA Hopper
// (sm_90a): the 1-D ring form (rows sharded, x periodic) and the 2-D torus
// form (rows and columns sharded).
//
// Replaces: advanced_hpc_lbm_tpu/ops/pallas_local.py `_local_kernel` (1-D)
// and `_local2d_kernel` (2-D), behind parallel/halo.py's `pallas` shard
// kernel.  It computes what they compute: one step of a (ly, lx) block whose
// y neighbours (and, on the torus, x neighbours) are halo values delivered
// by the exchange, not periodic wrap images; the forcing row is wherever
// global row ny-2 falls; one ||u|| sum of the block's fluid cells from the
// pre-collision moments.  The design is the step kernel's
// (csrc/step_kernel.cu): one thread per cell in 32x8 blocks, pulls straight
// from device memory, deterministic per-block partials, and the per-cell
// code of step_common.cuh:cell_step, so a sharded state equals the
// single-device state bit for bit.  Only the accessor differs:
//
// * Halos.  A shard's state lives in a ghosted window buffer
//   (parallel/halo.py): its own block plus G ghost rows above and below
//   and, on the torus, G ghost columns left and right, which the exchange
//   fills from the neighbours.  The kernel sees the window from its own
//   cell (0, 0): row -1 is the top halo row, row ly the bottom one; on the
//   torus column -1 and column lx are the row-extended edge columns of the
//   x neighbours, corners included (the port ships those two (9, ly+2)
//   columns, not the TPU kernel's six pre-shifted (ly, 1) columns, which
//   are a Mosaic layout convenience).  The halo rows are rows of the same
//   buffer, so the step reads no copy of the slab: the TPU kernel's halo
//   operands, without a (ly+2)-row window copied each step.  On the ring x
//   stays periodic (columns wrap within [0, lx)).
// * Forcing.  The port forces at the pull source (step_common.cuh), so a
//   pull from a halo cell needs that cell's obstacle bit and forcing flag.
//   Both come from the window's encoded mask (+1 obstacle, +2 forcing), a
//   loop-invariant (ly+2) x (lx or lx+2) window of the neighbours' bits
//   that the runner builds once per run.  Forcing is a row property (row
//   ny-2), so the kernel takes it as one flag per window row (the mask's
//   column 0, which the wrapper extracts): a warp's threads share a row,
//   so the flag is one broadcast load, where a per-cell +2 costs a mask
//   load for each of the six forced pulls.  A halo value is the raw
//   pre-step value and every pull from a cell of row ny-2 is forced, own
//   or halo: one rule for every shard kernel, with no assumption on ly
//   (the TPU's 2-D path pre-forces exported columns and needs ly >= 8).
//   The TPU kernel's `accel_local_row` (-1 off-shard) is the +2 bit of the
//   mask's rows.
//
// Bound on this card: like the step kernel, 73 bytes per own cell and step
// (9 float32 read and written, the 1-byte mask), plus the two halo rows
// (and on the torus two halo columns) of 9 floats and their mask bytes.
// This version seeks correctness, not that bound.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC

#include <cstddef>
#include <cstdint>

#include "step_common.cuh"

namespace {

constexpr int kBlockX = lbm::kTileX;
constexpr int kBlockY = lbm::kTileY;
constexpr int kThreads = kBlockX * kBlockY;

// The shard's window seen from its own cell (0, 0): rows -1 .. ly and, on
// the torus, columns -1 .. lx are halo cells.  Nothing writes the window
// during a launch, so every read goes through the read-only cache.
struct HaloWindow {
  const float* planes;   // own cell (0, 0) of plane 0
  const uint8_t* mask;   // own cell (0, 0) of the encoded mask window
  const uint8_t* rows;   // own row 0's forcing flag (+2), one per row
  size_t plane;          // plane stride of the window, in floats
  ptrdiff_t row;         // row stride of the window, in floats
  ptrdiff_t mask_row;    // row stride of the mask window, in bytes
  __device__ __forceinline__ float f(int k, int r, int c) const {
    return __ldg(planes + k * plane + static_cast<ptrdiff_t>(r) * row + c);
  }
  __device__ __forceinline__ uint8_t bits(int r, int c) const {
    return __ldg(mask + static_cast<ptrdiff_t>(r) * mask_row + c);
  }
  __device__ __forceinline__ bool obst(int r, int c) const {
    return (bits(r, c) & 1) != 0;
  }
  __device__ __forceinline__ bool accel(int r, int) const {
    return (__ldg(rows + r) & 2) != 0;
  }
};

// `win` and `mask` point at window cell (0, 0), the top-left halo cell,
// `accel_rows` at window row 0's flag; `out` at own cell (0, 0) of the
// output block.
template <bool kTorus>
__global__ void __launch_bounds__(kThreads)
    local_step_kernel(const float* __restrict__ win, long long win_plane,
                      int win_row, const uint8_t* __restrict__ mask,
                      int mask_row, const uint8_t* __restrict__ accel_rows,
                      float* __restrict__ out,
                      long long out_plane, int out_row,
                      float* __restrict__ partials, int ly, int lx,
                      lbm::StepConsts c) {
  __shared__ float red[kThreads];
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  // own cell (0, 0): one halo row down and, on the torus, one halo column
  // across
  const int c0 = kTorus ? 1 : 0;
  const HaloWindow src{win + win_row + c0, mask + mask_row + c0, accel_rows + 1,
                       static_cast<size_t>(win_plane), win_row, mask_row};

  float norm = 0.0f;
  if (x < lx && y < ly) {
    // east-/west-moving speeds pull from columns x-1 / x+1: halo columns
    // on the torus, periodic wrap on the ring
    const int xe = kTorus ? x - 1 : (x == 0 ? lx - 1 : x - 1);
    const int xw = kTorus ? x + 1 : (x == lx - 1 ? 0 : x + 1);
    const bool obst = src.obst(y, x);
    float s[9];
    const float u_sq = lbm::cell_step(src, y, x, y - 1, y + 1, xe, xw, s, obst, c);
    float* o = out + static_cast<ptrdiff_t>(y) * out_row + x;
#pragma unroll
    for (int k = 0; k < 9; ++k) o[k * static_cast<size_t>(out_plane)] = s[k];
    norm = obst ? 0.0f : sqrtf(u_sq);
  }

  // deterministic block sum of ||u||
  const float total = lbm::block_sum(norm, red, tid, kThreads);
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

}  // namespace

// The thread-block shape; the wrapper sizes the partials row from it.
extern "C" void lbm_local_block_shape(int* block_x, int* block_y) {
  *block_x = kBlockX;
  *block_y = kBlockY;
}

// Loads both forms onto the current device without launching them.
extern "C" int lbm_local_prepare(void) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, local_step_kernel<false>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, local_step_kernel<true>);
  return lbm::status(err);
}

// One step of a (ly, lx) block: out = step(window).  `win` / `mask` point at
// the top-left halo cell of the (ly+2) x lx (ring) or (ly+2) x (lx+2)
// (torus) window, `accel_rows` at its ly+2 rows' forcing flags (+2);
// strides in elements.  `partials` receives one float per
// 32x8 block of own cells, row-major.  Launches on `stream`; returns the
// launch's cudaError_t (0 = launched).
extern "C" int lbm_local_step(const float* win, long long win_plane, int win_row,
                              const uint8_t* mask, int mask_row,
                              const uint8_t* accel_rows, float* out,
                              long long out_plane, int out_row, float* partials,
                              int ly, int lx, int torus, float w0_omega,
                              float w1_omega, float w2_omega,
                              float one_minus_omega, float accel_w1,
                              float accel_w2, void* stream) {
  const lbm::StepConsts c{w0_omega,        w1_omega, w2_omega,
                          one_minus_omega, accel_w1, accel_w2};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((lx + kBlockX - 1) / kBlockX, (ly + kBlockY - 1) / kBlockY);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (torus) {
    local_step_kernel<true><<<grid, block, 0, st>>>(
        win, win_plane, win_row, mask, mask_row, accel_rows, out, out_plane,
        out_row, partials, ly, lx, c);
  } else {
    local_step_kernel<false><<<grid, block, 0, st>>>(
        win, win_plane, win_row, mask, mask_row, accel_rows, out, out_plane,
        out_row, partials, ly, lx, c);
  }
  return lbm::status(cudaSuccess);
}
