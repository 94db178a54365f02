// Shared per-cell step math of the D2Q9-BGK kernels: the forcing guard,
// the pairwise BGK relaxation with omega folded in, the bounce-back select,
// and the whole per-cell step (`cell_step`) that the step, resident,
// K-step and stream kernels all run, so that the four agree bit for bit.
// Counterpart of ops/kernel_common.py (`forced`, `collide`,
// `lean_window_step`), whose float32 operations these perform in the same
// order; built with -fmad=false so that no multiply-add is contracted and
// the kernels agree bit for bit with those plain PyTorch versions.  Never
// build with --use_fast_math: 1/rho and sqrt must stay IEEE-rounded.
//
// Speed numbering (ops/lattice.py):
//     6 2 5
//     3 0 1     1=E, 2=N, 3=W, 4=S, 5=NE, 6=NW, 7=SW, 8=SE
//     7 4 8
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace lbm {

// The cell tile of the step and resident kernels: one thread per cell, 32
// along x so that every plane row is read and written coalesced.  Each
// tile writes one ||u|| partial; the two kernels share the tile and its
// reduction order, so their partials agree bit for bit.
constexpr int kTileX = 32;
constexpr int kTileY = 8;

// float32 scalars of one step, rounded once on the host
// (ops/kernel_common.step_constants); device code never recomputes them.
struct StepConsts {
  float w0_omega;         // W[0] * omega
  float w1_omega;         // W[1] * omega (axis speeds)
  float w2_omega;         // W[5] * omega (diagonal speeds)
  float one_minus_omega;  // 1 - omega
  float accel_w1;         // forcing increment of the axis speeds
  float accel_w2;         // forcing increment of the diagonal speeds
};

// Positivity guard of the row forcing, evaluated at the cell whose
// pre-stream values are being forced: fluid, and the three decremented
// speeds stay strictly positive.
__device__ __forceinline__ bool forcing_ok(bool obst, float f3, float f6,
                                           float f7, const StepConsts& c) {
  return !obst && (f3 - c.accel_w1 > 0.0f) && (f6 - c.accel_w2 > 0.0f) &&
         (f7 - c.accel_w2 > 0.0f);
}

// BGK relaxation + bounce-back of one cell, in place on its 9 streamed
// values.  Returns u_sq of the streamed (pre-collision) moments, which BGK
// conserves, for the ||u|| reduction.
__device__ __forceinline__ float collide(float s[9], bool obst,
                                         const StepConsts& c) {
  float rho = s[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) rho = rho + s[k];
  const float inv_rho = 1.0f / rho;
  const float u_x = (s[1] + s[5] + s[8] - s[3] - s[6] - s[7]) * inv_rho;
  const float u_y = (s[2] + s[5] + s[6] - s[4] - s[7] - s[8]) * inv_rho;
  const float u_sq = u_x * u_x + u_y * u_y;
  const float base = 1.0f - u_sq * 1.5f;
  const float om1 = c.one_minus_omega;

  float o[9];
  o[0] = c.w0_omega * rho * base + om1 * s[0];
  // opposite speeds k / ko share the even part of their equilibrium
  auto pair = [&](int k, int ko, float cu, float w_omega) {
    const float t = w_omega * rho;
    const float even = base + (cu * cu) * 4.5f;
    const float odd = cu * 3.0f;
    o[k] = t * (even + odd) + om1 * s[k];
    o[ko] = t * (even - odd) + om1 * s[ko];
  };
  pair(1, 3, u_x, c.w1_omega);
  pair(2, 4, u_y, c.w1_omega);
  pair(5, 7, u_x + u_y, c.w2_omega);
  pair(8, 6, u_x - u_y, c.w2_omega);

  if (obst) {
    // reflected pull: each speed takes its opposite's streamed value
    const float r1 = s[1], r2 = s[2], r5 = s[5], r6 = s[6];
    s[1] = s[3]; s[3] = r1;
    s[2] = s[4]; s[4] = r2;
    s[5] = s[7]; s[7] = r5;
    s[6] = s[8]; s[8] = r6;
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) s[k] = o[k];
  }
  return u_sq;
}

// Pull plane k from source cell (r, c), adding the forcing increment `dv`
// when the source is a forcing cell (an image of row ny-2, or a +2 cell of
// the stream kernel's encoded mask) and passes the guard there.  The plain version forces the whole plane before rolling and adds
// 0 elsewhere (which turns a -0.0 into +0.0); so does this.
template <class Src>
__device__ __forceinline__ float forced_pull(const Src& src, int k, int r,
                                             int c, float dv,
                                             const StepConsts& cc) {
  float d = 0.0f;
  if (src.accel(r, c) && forcing_ok(src.obst(r, c), src.f(3, r, c),
                                 src.f(6, r, c), src.f(7, r, c), cc)) {
    d = dv;
  }
  return src.f(k, r, c) + d;
}

// The whole per-cell step, shared by the step, resident and K-step kernels
// so that the three agree bit for bit: force at the pull source, pull the
// 9 values, collide and bounce back.  `Src` is an accessor of the
// pre-step state:
//   float f(int k, int r, int c)   value of plane k at row r, column c
//   bool obst(int r, int c)        the cell is blocked
//   bool accel(int r, int c)       cell (r, c) is forced: an image of row
//                                  ny-2 (step, resident, K-step; they
//                                  ignore c) or a +2 cell of the stream
//                                  kernel's encoded mask
// (r, c) is the cell; rn/rs are the rows its north-/south-moving speeds
// pull from, ce/cw the columns its east-/west-moving speeds pull from.
// Writes the post-step values to s and returns u_sq of the pre-collision
// moments (see collide).
template <class Src>
__device__ __forceinline__ float cell_step(const Src& src, int r, int c,
                                           int rn, int rs, int ce, int cw,
                                           float s[9], bool obst,
                                           const StepConsts& cc) {
  const float w1 = cc.accel_w1, w2 = cc.accel_w2;
  s[0] = src.f(0, r, c);
  s[1] = forced_pull(src, 1, r, ce, w1, cc);
  s[2] = src.f(2, rn, c);
  s[3] = forced_pull(src, 3, r, cw, -w1, cc);
  s[4] = src.f(4, rs, c);
  s[5] = forced_pull(src, 5, rn, ce, w2, cc);
  s[6] = forced_pull(src, 6, rn, cw, -w2, cc);
  s[7] = forced_pull(src, 7, rs, cw, -w2, cc);
  s[8] = forced_pull(src, 8, rs, ce, w2, cc);
  return collide(s, obst, cc);
}

// The state in device memory: (9, ny, nx) float32 planes and the uint8
// mask, indexed by global (row, column), both read through the read-only
// data cache (__ldg), which is right only when no thread of the launch
// writes them: the step kernel's state (read-only loads of the mask and the
// planes measured 32.3 us per step at 1024^2 against 33.6 us with plain
// mask loads, H100 80GB HBM3 at 700 W).
struct GlobalState {
  const float* planes;
  const uint8_t* mask;
  size_t plane;  // ny * nx
  int nx;
  int accel_row;  // ny - 2
  __device__ __forceinline__ float f(int k, int r, int c) const {
    return __ldg(planes + k * plane + static_cast<size_t>(r) * nx + c);
  }
  __device__ __forceinline__ bool obst(int r, int c) const {
    return __ldg(mask + static_cast<size_t>(r) * nx + c) != 0;
  }
  __device__ __forceinline__ bool accel(int r, int) const { return r == accel_row; }
};

// One step of global cell (y, x) of a periodic (ny, nx) grid: reads `src`,
// writes the 9 new values to `out` and returns ||u|| (0 on obstacles).
__device__ __forceinline__ float global_cell_step(const GlobalState& src, float* out, int y,
                                                  int x, int ny, const StepConsts& cc) {
  const int nx = src.nx;
  // source columns/rows of the pull, with periodic wrap
  const int xe = (x == 0) ? nx - 1 : x - 1;  // east-moving speeds pull from x-1
  const int xw = (x == nx - 1) ? 0 : x + 1;  // west-moving speeds pull from x+1
  const int yn = (y == 0) ? ny - 1 : y - 1;  // north-moving speeds pull from y-1
  const int ys = (y == ny - 1) ? 0 : y + 1;  // south-moving speeds pull from y+1
  const bool obst = src.obst(y, x);
  float s[9];
  const float u_sq = cell_step(src, y, x, yn, ys, xe, xw, s, obst, cc);
  const size_t i = static_cast<size_t>(y) * nx + x;
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k * src.plane + i] = s[k];
  return obst ? 0.0f : sqrtf(u_sq);
}

// Deterministic block sum of `v` over the block's `n` threads (a power of
// two) through `red` (n floats of shared memory): every thread must call
// it, so that the barriers are reached by the whole block.  The result is
// valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red, int tid,
                                           int n) {
  red[tid] = v;
  __syncthreads();
  for (int stride = n / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red[tid] = red[tid] + red[tid + stride];
    __syncthreads();
  }
  return red[0];
}

// Host side: `err`, or else the runtime's last error, as the int the
// entry points return.  Either way the last error is cleared, so that a
// refused launch is not reported again by the next launch's check.
inline int status(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace lbm
