// Shared machinery of the two ghost-zone kernels (csrc/kstep_kernel.cu and
// csrc/stream_kernel.cu): a window of the state in shared memory that K
// steps advance (in place, or ping-pong with a second window, or into a
// dense tile), the asynchronous copies that fill the next window, and the
// accessor, cell map and reductions of a step.
//
// * Steps.  A step computes a rectangle of the window, each cell by
//   step_common.cuh:cell_step.  In place with register staging: each thread
//   pulls the 9 values of each of its cells into registers, a barrier ends
//   the reads, the values are written back into the same window, and a
//   second barrier publishes them (one window per tile).  Or from one
//   window into another (two buffers ping-pong, one barrier per step), or
//   into a dense tile of own cells.  The barrier is the block's, or that
//   of a team of the block's warps (a named barrier), as the caller passes.
// * Compile-time cell map.  Thread tid takes cells i = tid + j * kThreads
//   of the rectangle, j = 0, 1, ...; a rectangle 32 or more columns wide is
//   read as a 32-column strip (cell i: row i / 32, column i % 32, one window
//   row per warp, so a warp's x-shifted reads fall on 32 consecutive banks)
//   and the columns beyond it packed row by row; a narrower one row by row.
//   Every divisor is a compile-time constant.
// * Forcing.  A pull tests forcing only on the window rows that `RowBits`
//   marks (images of row ny-2, or rows whose encoded mask holds a +2 cell);
//   a window with none runs the step without the test (kForce = false).
// * ||u||.  Each thread sums ||u|| of its counted cells, each warp reduces
//   its threads' sums by shuffles in a fixed order, and lane 0 hands the
//   warp's sum to the caller; the caller sums the warps in warp order.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "step_common.cuh"

namespace lbm {

// ---- asynchronous copies global -> shared (sm_80 and later) ---------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v mod n in [0, n) for any int v (n > 0): the periodic wrap of a window
// that reaches past the grid's edge, also more than once on small grids.
__device__ __forceinline__ int wrap(int v, int n) {
  const int m = v % n;
  return m < 0 ? m + n : m;
}

// Sum of v over the warp, by shuffles in a fixed order; valid in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

// ---- a window in shared memory ----------------------------------------------

// kH rows of kP floats (the row pitch) for each of the 9 planes, then the
// kH x kP mask bytes; kBytes is a multiple of 16, so that consecutive
// windows keep 16-byte rows.
template <int kH, int kP>
struct WinGeo {
  static_assert(kP % 4 == 0, "16-byte rows");
  static constexpr int kPlane = kH * kP;
  static constexpr int kFloats = 9 * kPlane;
  static constexpr int kMaskBytes = (kPlane + 15) / 16 * 16;
  static constexpr int kBytes = 4 * kFloats + kMaskBytes;
};

// One bit per window row, kept in registers (kWords 32-bit words for up to
// 32 * kWords rows); test() selects the word by compile-time comparisons,
// so the bits never go to local memory.
template <int kWords>
struct RowBits {
  uint32_t w[kWords];
  __device__ __forceinline__ bool any() const {
    uint32_t a = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) a |= w[i];
    return a != 0;
  }
  __device__ __forceinline__ bool test(int r) const {
    uint32_t word = w[0];
#pragma unroll
    for (int i = 1; i < kWords; ++i) word = r >= 32 * i ? w[i] : word;
    return ((word >> (r & 31)) & 1u) != 0;
  }
};

// Row bits of a window from a per-row predicate, by each warp on its own
// (so no barrier is needed): lane l decides rows l, l + 32, ...
template <int kH, class Pred>
__device__ __forceinline__ RowBits<(kH + 31) / 32> row_bits(int lane, Pred pred) {
  RowBits<(kH + 31) / 32> bits;
#pragma unroll
  for (int i = 0; i < (kH + 31) / 32; ++i) {
    const int r = 32 * i + lane;
    bits.w[i] = __ballot_sync(0xffffffffu, r < kH && pred(r));
  }
  return bits;
}

// Rows of a window mask (kH x kP bytes, kP % 4 == 0) that hold an encoded
// +2 (forcing) cell.
template <int kH, int kP>
__device__ __forceinline__ RowBits<(kH + 31) / 32> forcing_rows(const uint8_t* mask,
                                                                int lane) {
  return row_bits<kH>(lane, [&](int r) {
    const uint32_t* row = reinterpret_cast<const uint32_t*>(mask + r * kP);
    uint32_t any = 0;
#pragma unroll
    for (int q = 0; q < kP / 4; ++q) any |= row[q];
    return (any & 0x02020202u) != 0;
  });
}

// The accessor cell_step reads a window through.  kEncoded: mask bytes
// +1 obstacle, +2 forcing cell (a pull is forced where its source row is
// marked in `frow` and the source cell has +2); otherwise nonzero =
// obstacle and every cell of a marked row is forced.  kForce = false: no
// row is marked, the forcing test compiles away (the pull still adds 0.0f,
// as the step kernel's does).
template <int kH, int kP, bool kForce, bool kEncoded>
struct Window {
  using Geo = WinGeo<kH, kP>;
  static constexpr int kPitch = kP;
  const float* planes;
  const uint8_t* mask;
  RowBits<(kH + 31) / 32> frow;
  __device__ __forceinline__ float f(int k, int r, int c) const {
    return planes[k * Geo::kPlane + r * kP + c];
  }
  static __device__ __forceinline__ bool obst_of(uint8_t bits) {
    return kEncoded ? (bits & 1) != 0 : bits != 0;
  }
  __device__ __forceinline__ bool obst(int r, int c) const {
    return obst_of(mask[r * kP + c]);
  }
  __device__ __forceinline__ bool accel(int r, int c) const {
    if constexpr (!kForce) {
      return false;
    } else if constexpr (kEncoded) {
      return frow.test(r) && (mask[r * kP + c] & 2) != 0;
    } else {
      return frow.test(r);
    }
  }
};

// Cell i of a kRows x kCols rectangle, relative to its corner: the
// compile-time map described at the top of this file.
template <int kRows, int kCols>
__device__ __forceinline__ void cell_of(int i, int& r, int& c) {
  if constexpr (kCols > 32) {
    if (i < 32 * kRows) {
      r = i >> 5;
      c = i & 31;
    } else {
      const int e = i - 32 * kRows;
      r = e / (kCols - 32);
      c = 32 + e % (kCols - 32);
    }
  } else if constexpr (kCols == 32) {
    r = i >> 5;
    c = i & 31;
  } else {
    r = i / kCols;
    c = i % kCols;
  }
}

// Where a step writes the new values of window cell (r, c) (offset `off`
// = r * pitch + c in a plane): planes of kPlane floats, cell `index` of
// each.  WindowDst: a window's own planes (the same offsets).  TileDst: a
// dense kRows x kCols tile whose corner is window cell (kR0, kC0).
// kUnrolled: stage every round of the thread's cells in registers before
// writing (as in place) rather than write each cell as it is computed.
template <class Geo>
struct WindowDst {
  static constexpr int kPlane = Geo::kPlane;
  static constexpr bool kUnrolled = false;
  float* planes;
  static __device__ __forceinline__ int index(int, int, int off) { return off; }
};

template <int kRows, int kCols, int kR0, int kC0>
struct TileDst {
  static constexpr int kPlane = kRows * kCols;
  static constexpr bool kUnrolled = true;
  float* planes;
  static __device__ __forceinline__ int index(int r, int c, int) {
    return (r - kR0) * kCols + (c - kC0);
  }
};

// The threads that run a step and their barrier: the whole block.
struct BlockBarrier {
  __device__ __forceinline__ int tid() const { return threadIdx.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// One step of the window rectangle rows [kR0, kR0 + kRows) x columns
// [kC0, kC0 + kCols) by the kThreads threads of `bar` (thread bar.tid(),
// barrier bar.sync()), from the window `win` reads into `dst`.  kInPlace
// (dst is win's own planes): each thread stages its cells' new values in
// registers (the rounds unrolled), a barrier ends the reads, the values are
// written back and a second barrier publishes them.  Otherwise (dst is
// other memory) each cell is written as it is computed, in a loop over the
// thread's cells (or, for a kUnrolled dst, after all of them), and one
// barrier publishes the step.  `counted(r, c, bits, obst)` says whether
// cell (r, c)'s ||u|| counts; `warp_total(v)` is called by lane 0 of every
// warp with the warp's sum, before the barriers that end the step.
template <int kThreads, int kR0, int kRows, int kC0, int kCols, bool kInPlace, class Win,
          class Dst, class Counted, class WarpTotal, class Bar>
__device__ __forceinline__ void step(const Win& win, const Dst& dst, const StepConsts& cc,
                                     Counted counted, WarpTotal warp_total, const Bar& bar) {
  constexpr int kCells = kRows * kCols;
  const int tid = bar.tid();
  float norm = 0.0f;
  // the new values of cell i into v; returns the cell's index in a plane of dst
  auto cell = [&](int i, float* v) {
    int r, c;
    cell_of<kRows, kCols>(i, r, c);
    r += kR0;
    c += kC0;
    const int off = r * Win::kPitch + c;
    const uint8_t bits = win.mask[off];
    const bool obst = Win::obst_of(bits);
    const float u_sq = cell_step(win, r, c, r - 1, r + 1, c - 1, c + 1, v, obst, cc);
    if (counted(r, c, bits, obst)) norm = norm + sqrtf(u_sq);
    return Dst::index(r, c, off);
  };
  if constexpr (kInPlace || Dst::kUnrolled) {
    constexpr int kRounds = (kCells + kThreads - 1) / kThreads;
    float v[kRounds][9];
    int off[kRounds];
#pragma unroll
    for (int j = 0; j < kRounds; ++j) {
      if ((j + 1) * kThreads <= kCells || tid + j * kThreads < kCells) {
        off[j] = cell(tid + j * kThreads, v[j]);
      }
    }
    norm = warp_sum(norm);
    if ((tid & 31) == 0) warp_total(norm);
    if constexpr (kInPlace) bar.sync();  // every read of the step is done
#pragma unroll
    for (int j = 0; j < kRounds; ++j) {
      if ((j + 1) * kThreads <= kCells || tid + j * kThreads < kCells) {
#pragma unroll
        for (int k = 0; k < 9; ++k) dst.planes[k * Dst::kPlane + off[j]] = v[j][k];
      }
    }
  } else {
#pragma unroll 1
    for (int i = tid; i < kCells; i += kThreads) {
      float v[9];
      const int off = cell(i, v);
#pragma unroll
      for (int k = 0; k < 9; ++k) dst.planes[k * Dst::kPlane + off] = v[k];
    }
    norm = warp_sum(norm);
    if ((tid & 31) == 0) warp_total(norm);
  }
  bar.sync();  // the step's values are published
}

// The same, by the whole block into another window's (or the same
// window's) planes `dst`.
template <int kThreads, int kR0, int kRows, int kC0, int kCols, bool kInPlace, class Win,
          class Counted, class WarpTotal>
__device__ __forceinline__ void step(const Win& win, float* dst, const StepConsts& cc,
                                     Counted counted, WarpTotal warp_total) {
  step<kThreads, kR0, kRows, kC0, kCols, kInPlace>(
      win, WindowDst<typename Win::Geo>{dst}, cc, counted, warp_total, BlockBarrier{});
}

}  // namespace lbm
