// K = 8 D2Q9-BGK timesteps per pass over a state in device memory, in
// place or out of place, with the cell mask encoded as data: the streaming
// kernel for NVIDIA Hopper (sm_90a).
//
// Replaces: advanced_hpc_lbm_tpu/ops/pallas_stream.py `_kernel` and its
// step body advanced_hpc_lbm_tpu/ops/kernel_common.py
// `lean_window_step_rows` (the shrinking region below is that trapezoid in
// both directions), behind the `stream` backend.
//
// Mask.  One uint8 per cell: +1 obstacle, +2 forcing cell, +4 left out of
// the ||u|| sums (the cell keeps its true dynamics).  Forcing is read from
// the mask, per cell, on the window rows that hold a +2 cell.
//
// In place (out == f), one state buffer.  The TPU kernel is safe in place
// because its grid runs tiles in order; here blocks run concurrently and
// in no order, so the pass is made hazard-free by construction:
//
// * Ownership.  The grid is cut into work items: slabs of kSlab rows times
//   segments of kSeg columns (the last slab and segment may be shorter).
//   A persistent grid (one block per SM) walks them: block b takes items
//   b, b + grid, ...  Only the block of an item writes its cells, and only
//   it reads them from f.
// * Snapshot.  Every ghost value a block needs from outside an item's
//   cells comes from a snapshot of the old state, taken by
//   `snapshot_kernel` just before the pass in the same stream: for each
//   slab the K rows above and the K rows below it (all columns), and for
//   each segment the K columns left and right of it (all rows).  That side
//   buffer is 2K/kSlab + 2K/kSeg of a state (20% + 1.6%); no block writes
//   it during the pass.
// * Chunks and the schedule.  A block walks an item along x in chunks of
//   kChunk columns, and its items one after another.  A chunk's window
//   (its cells with a ghost ring K deep) steps ping-pong between the
//   block's two window buffers, and K is even, so the result ends in the
//   buffer it was loaded into; the other buffer is then free and the next
//   chunk's window is copied into it by cp.async:
//
//     ... steps of chunk j ... issue load(j+1) ... wait for it
//     (cp.async.wait_group 0) and a barrier ... write chunk j ... barrier
//     ... steps of chunk j+1
//
//   A chunk is written only after the next chunk's load has completed:
//   every thread has waited for its own copies and the block has met at a
//   barrier, not merely issued them.  The only own cells of an item that
//   chunk j's window reads are those of chunks j-1, j, j+1 (kChunk >= K):
//   chunk j-1 is written after load(j) completed and chunk j after
//   load(j+1), so every read of f sees the old value.  Chunks of the next
//   item are other cells.  (The TPU kernel's "egress(i) after
//   ingress(i+1)", turned 90 degrees and kept inside one block.)
//
// Out of place the same schedule runs with out != f.
//
// Steps.  K steps ping-pong (window_common.cuh): step s computes rows
// [s, kH - s) and columns [s, kW - s) of the window, each cell by
// step_common.cuh:cell_step, so the state equals the step kernel's bit for
// bit.  The rectangle is the full window's whatever the chunk's size: in a
// short last slab or chunk the cells past the loaded ones hold stale
// values, which reach no own cell in K steps (they spread one cell per
// step from outside the ghost ring).  Windows wrap with mod ny / mod nx: a
// window is a periodic image of the grid, also on grids smaller than a
// window; where ny, nx >= K and nx % 4 == 0 the window loads 16-byte groups
// at plain offsets (wrapped by one add at the grid's edge), else cell by
// cell with mod.  Forcing is tested only on the rows whose mask holds a +2
// cell.
//
// Partials.  One ||u|| sum per step and item (own cells with neither +1
// nor +4): partials[s, slab * segments + segment].  Each warp adds its
// step sums into its own shared slot across an item's chunks; thread s
// then adds the slots in warp order, so the sums are deterministic.
//
// Bound on this card: device memory moves (36 + 1 + 36) B per cell per
// pass and the snapshot 2 x 21.6% of the state, 10.9 B per cell and step
// (45.70 us per step at 4096^2 at 3.35 TB/s).  What is left is instruction
// issue: a chunk steps 16176 cells for 10240 own cell steps (1.58x), ~145
// instructions each, with one block of 1024 threads per SM (two 96 x 32
// windows fill its shared memory).  Stepping in place with the cells
// staged in registers (one window per chunk, the other free for the next
// chunk's copy during the steps) spilled at 512, 768 and 1024 threads and
// was slower; an L2 prefetch of the next chunk's window during the steps
// cost more than it saved.  Measured time per step: PERF.md
// (chip_smoke.py 3s, H100 80GB HBM3).
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC

#include <cstdint>

#include "step_common.cuh"
#include "window_common.cuh"

namespace {

constexpr int K = 8;          // steps per pass = ghost depth
constexpr int kSlab = 80;     // own rows of an item
constexpr int kSeg = 1024;    // own columns of an item
constexpr int kChunk = 16;    // own columns of one window
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kH = kSlab + 2 * K;   // window rows
constexpr int kW = kChunk + 2 * K;  // window columns = row pitch
constexpr int kGroups = kW / 4;     // 16-byte groups per window row
using Geo = lbm::WinGeo<kH, kW>;
constexpr size_t kSmemBytes = 2 * static_cast<size_t>(Geo::kBytes);
static_assert(kChunk >= K, "a chunk's ghost ring must lie in its neighbours");
static_assert(kChunk % 4 == 0 && kSeg % kChunk == 0, "16-byte groups of a chunk");

// Global row of snapshot row i (0..2K) of a slab starting at y0 with h rows:
// the K rows above it, then the K rows below it.
__device__ __forceinline__ int snap_row(int i, int y0, int h, int ny) {
  return lbm::wrap(i < K ? y0 - K + i : y0 + h + i - K, ny);
}

// The old ghost values of every item: rows_snap (9, slabs, 2K, nx) and
// cols_snap (9, segments, ny, 2K).
__global__ void __launch_bounds__(256)
    snapshot_kernel(const float* __restrict__ f, float* __restrict__ rows_snap,
                    float* __restrict__ cols_snap, int ny, int nx) {
  const int slabs = (ny + kSlab - 1) / kSlab, segs = (nx + kSeg - 1) / kSeg;
  const size_t plane = static_cast<size_t>(ny) * nx;
  const size_t rows_n = static_cast<size_t>(slabs) * 2 * K * nx;
  const size_t cols_n = static_cast<size_t>(segs) * ny * 2 * K;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < rows_n + cols_n; i += stride) {
    size_t src;
    float* dst;
    size_t dst_plane;
    if (i < rows_n) {
      const int slab = static_cast<int>(i / (2 * K * static_cast<size_t>(nx)));
      const int rem = static_cast<int>(i % (2 * K * static_cast<size_t>(nx)));
      const int y0 = slab * kSlab, h = min(kSlab, ny - y0);
      src = static_cast<size_t>(snap_row(rem / nx, y0, h, ny)) * nx + rem % nx;
      dst = rows_snap + i;
      dst_plane = rows_n;
    } else {
      const size_t j = i - rows_n;
      const int seg = static_cast<int>(j / (static_cast<size_t>(ny) * 2 * K));
      const int rem = static_cast<int>(j % (static_cast<size_t>(ny) * 2 * K));
      const int y = rem / (2 * K), c = rem % (2 * K);
      const int xs = seg * kSeg, sw = min(kSeg, nx - xs);
      src = static_cast<size_t>(y) * nx +
            lbm::wrap(c < K ? xs - K + c : xs + sw + c - K, nx);
      dst = cols_snap + j;
      dst_plane = cols_n;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) dst[k * dst_plane] = f[k * plane + src];
  }
}

// The kernel's arguments, a __grid_constant__ parameter: they stay in the
// constant bank, and the window load and write below read them by
// reference without a local copy.
struct Args {
  const float* f;
  float* out;
  const uint8_t* mask;
  const float* rows_snap;
  const float* cols_snap;
  float* partials;
  int ny, nx;
  int vec;  // 16-byte window rows: nx % 4 == 0, ny, nx >= K, aligned buffers
  lbm::StepConsts c;
  __device__ __forceinline__ int segs() const { return (nx + kSeg - 1) / kSeg; }
  __device__ __forceinline__ int slabs() const { return (ny + kSlab - 1) / kSlab; }
  __device__ __forceinline__ int items() const { return slabs() * segs(); }
  __device__ __forceinline__ size_t plane() const { return static_cast<size_t>(ny) * nx; }
};

// Chunk j of item `item`: own rows [y0, y0 + h), own columns [x0, x0 + w)
// of the segment [xs, xs + sw) of slab `slab`.
struct Chunk {
  int slab, seg, y0, h, xs, sw, x0, w;
  __device__ __forceinline__ Chunk(const Args& a, int item, int j) {
    slab = item / a.segs();
    seg = item - slab * a.segs();
    y0 = slab * kSlab;
    h = min(kSlab, a.ny - y0);
    xs = seg * kSeg;
    sw = min(kSeg, a.nx - xs);
    x0 = xs + j * kChunk;
    w = min(kChunk, xs + sw - x0);
  }
  __device__ __forceinline__ bool last_of_item() const { return x0 + w >= xs + sw; }
};

// The chunk after (item, j) in a block's walk (item >= items: none).
__device__ __forceinline__ void next_chunk(const Args& a, int& item, int& j) {
  if (Chunk(a, item, j).last_of_item()) {
    item += gridDim.x;
    j = 0;
  } else {
    ++j;
  }
}

// Issue the copies of chunk (item, j)'s window into `buf` (no wait).
// Window cell (r, cc) is global cell (y0 - K + r, x0 - K + cc), taken from
// the slab's row snapshot (r < K or r >= K + h), the segment's column
// snapshot (columns outside the segment), or f (the item's own cells).
__device__ __forceinline__ void load_window(uint8_t* buf, const Args& a, int item, int j,
                                         int tid) {
  const Chunk c(a, item, j);
  float* const wf = reinterpret_cast<float*>(buf);
  uint8_t* const wm = buf + 4 * Geo::kFloats;
  const size_t rows_n = static_cast<size_t>(a.slabs()) * 2 * K * a.nx;
  const size_t cols_n = static_cast<size_t>(a.segs()) * a.ny * 2 * K;
  const float* const rsnap = a.rows_snap + static_cast<size_t>(c.slab) * 2 * K * a.nx;
  const float* const csnap = a.cols_snap + static_cast<size_t>(c.seg) * a.ny * 2 * K;
  const int H = c.h + 2 * K, W = c.w + 2 * K;
  // source of global column gx of window row r: (pointer, plane stride)
  auto source = [&](int r, int gx, int gxw, size_t& stride) -> const float* {
    if (r < K || r >= K + c.h) {  // ghost rows: the slab's row snapshot
      stride = rows_n;
      return rsnap + static_cast<size_t>(r < K ? r : r - c.h) * a.nx + gxw;
    }
    const int y = c.y0 + r - K;
    if (gx < c.xs || gx >= c.xs + c.sw) {  // ghost columns: the segment's
      stride = cols_n;
      return csnap + static_cast<size_t>(y) * 2 * K +
             (gx < c.xs ? gx - (c.xs - K) : K + gx - (c.xs + c.sw));
    }
    stride = a.plane();  // own cells of this item, not yet written
    return a.f + static_cast<size_t>(y) * a.nx + gx;
  };
  if (a.vec) {
    for (int i = tid; i < kH * kGroups; i += kThreads) {
      const int r = i / kGroups, q = i - r * kGroups;
      if (r >= H || 4 * q >= W) continue;
      const int gx = c.x0 - K + 4 * q;
      const int gxw = gx < 0 ? gx + a.nx : (gx >= a.nx ? gx - a.nx : gx);
      int gy = c.y0 - K + r;
      gy = gy < 0 ? gy + a.ny : (gy >= a.ny ? gy - a.ny : gy);
      size_t stride;
      const float* const p = source(r, gx, gxw, stride);
      const int jw = r * kW + 4 * q;
#pragma unroll
      for (int k = 0; k < 9; ++k) lbm::cp_async16(wf + k * Geo::kPlane + jw, p + k * stride);
      lbm::cp_async4(wm + jw, a.mask + static_cast<size_t>(gy) * a.nx + gxw);
    }
  } else {
    for (int i = tid; i < kH * kW; i += kThreads) {
      const int r = i / kW, cc = i - r * kW;
      if (r >= H || cc >= W) continue;
      const int gx = c.x0 - K + cc, gxw = lbm::wrap(gx, a.nx);
      size_t stride;
      const float* const p = source(r, gx, gxw, stride);
#pragma unroll
      for (int k = 0; k < 9; ++k) lbm::cp_async4(wf + k * Geo::kPlane + i, p + k * stride);
      // read only after the wait and barrier, like the copies
      wm[i] = a.mask[static_cast<size_t>(lbm::wrap(c.y0 - K + r, a.ny)) * a.nx + gxw];
    }
  }
}

// Write chunk (item, j)'s own cells from its window `planes` to out, and
// at an item's last chunk its ||u|| partials (threads s < K).
__device__ __forceinline__ void write_chunk(const float* planes, float (*wsum)[kWarps],
                                         const Args& a, int item, int j, int tid) {
  const Chunk c(a, item, j);
  const size_t plane = a.plane();
  for (int i = tid; i < kSlab * kChunk; i += kThreads) {
    const int r = i / kChunk, col = i % kChunk;
    if (r < c.h && col < c.w) {
      const size_t gi = static_cast<size_t>(c.y0 + r) * a.nx + c.x0 + col;
      const int jw = (r + K) * kW + col + K;
#pragma unroll
      for (int k = 0; k < 9; ++k) a.out[k * plane + gi] = planes[k * Geo::kPlane + jw];
    }
  }
  if (c.last_of_item() && tid < K) {
    float total = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      total = total + wsum[tid][wi];
      wsum[tid][wi] = 0.0f;
    }
    a.partials[static_cast<size_t>(tid) * a.items() + item] = total;
  }
}

// Steps s = S..K of one chunk, ping-pong between its window `planes` (odd
// steps read it) and `other`; warp sums added into wsum[s-1].  K is even:
// the result ends in `planes`.
template <int S, bool kForce, class Counted>
__device__ __forceinline__ void steps(const lbm::Window<kH, kW, kForce, true>& win,
                                      float* planes, float* other, const lbm::StepConsts& c,
                                      Counted counted, float (*wsum)[kWarps], int warp) {
  auto from = win;
  from.planes = S % 2 ? planes : other;
  lbm::step<kThreads, S, kH - 2 * S, S, kW - 2 * S, false>(
      from, S % 2 ? other : planes, c, counted,
      [&](float v) { wsum[S - 1][warp] = wsum[S - 1][warp] + v; });
  if constexpr (S < K) steps<S + 1, kForce>(win, planes, other, c, counted, wsum, warp);
}

// f and out may be one buffer: neither is __restrict__.
__global__ void __launch_bounds__(kThreads, 1) stream_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(smem_raw);
  __shared__ float wsum[K][kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < K * kWarps) (&wsum[0][0])[tid] = 0.0f;  // first read after a barrier

  // the chunk that steps (its window in buffer b, the other buffer its
  // ping-pong partner) and the one after it
  int item = blockIdx.x, j = 0;  // the grid has at most `items` blocks
  load_window(smem, a, item, j, tid);
  lbm::cp_async_commit();
  for (int b = 0; item < a.items(); b ^= 1) {
    uint8_t* const buf = smem + b * Geo::kBytes;
    uint8_t* const spare = smem + (b ^ 1) * Geo::kBytes;
    float* const planes = reinterpret_cast<float*>(buf);
    const uint8_t* const wm = buf + 4 * Geo::kFloats;
    lbm::cp_async_wait<0>();  // this chunk's copies have landed
    __syncthreads();          // ... everyone's
    int next_item = item, next_j = j;
    next_chunk(a, next_item, next_j);
    {
      const Chunk c(a, item, j);
      const unsigned h = c.h, w = c.w;
      auto counted = [h, w](int r, int col, uint8_t bits, bool) {
        return (bits & 5) == 0 && static_cast<unsigned>(r - K) < h &&
               static_cast<unsigned>(col - K) < w;
      };
      float* const other = reinterpret_cast<float*>(spare);
      const auto frow = lbm::forcing_rows<kH, kW>(wm, lane);
      if (frow.any()) {
        const lbm::Window<kH, kW, true, true> win{planes, wm, frow};
        steps<1, true>(win, planes, other, a.c, counted, wsum, warp);
      } else {
        const lbm::Window<kH, kW, false, true> win{planes, wm, frow};
        steps<1, false>(win, planes, other, a.c, counted, wsum, warp);
      }
    }
    // the partner window is free: the next chunk's window goes there, and
    // this chunk is written only once that load has completed
    if (next_item < a.items()) load_window(spare, a, next_item, next_j, tid);
    lbm::cp_async_commit();
    lbm::cp_async_wait<0>();
    __syncthreads();
    write_chunk(planes, wsum, a, item, j, tid);
    __syncthreads();  // this window is free: the next chunk's partner
    item = next_item;
    j = next_j;
  }
}

static_assert(K % 2 == 0, "K steps per pass of the stream tier");

// Blocks per SM of the persistent grid per device (0: not prepared), and
// the device's SMs.
constexpr int kMaxDevices = 64;
int g_per_sm[kMaxDevices];
int g_sms[kMaxDevices];

cudaError_t prepare_on(int dev) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, snapshot_kernel);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  }
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream_kernel, kThreads,
                                                        kSmemBytes);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;  // a block does not fit on an SM
  g_sms[dev] = sms;
  g_per_sm[dev] = per_sm;
  return cudaSuccess;
}

// Prepares the kernels on the current device unless they are; sets *dev.
cudaError_t prepared(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && *dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && g_per_sm[*dev] == 0) err = prepare_on(*dev);
  return err;
}

}  // namespace

// The kernel's geometry; the wrapper sizes the side buffer and the
// partials from it.
extern "C" void lbm_stream_geometry(int* k, int* slab, int* seg) {
  *k = K;
  *slab = kSlab;
  *seg = kSeg;
}

// Loads both kernels onto the current device, sets the stream kernel's
// shared-memory limit and sizes its persistent grid, without launching
// either.  A launch on a device not yet prepared prepares it first.
extern "C" int lbm_stream_prepare(void) {
  int dev = 0;
  return lbm::status(prepared(&dev));
}

// Blocks per SM of the stream kernel's persistent grid on the current
// device, preparing it first; 0 if it cannot run there.
extern "C" int lbm_stream_blocks_per_sm(void) {
  int dev = 0;
  const int per_sm = prepared(&dev) == cudaSuccess ? g_per_sm[dev] : 0;
  lbm::status(cudaSuccess);
  return per_sm;
}

// The ghost snapshot of state f into rows_snap / cols_snap (sized by the
// wrapper from lbm_stream_geometry).  Launches on `stream`.
extern "C" int lbm_stream_snapshot(const float* f, float* rows_snap,
                                   float* cols_snap, int ny, int nx,
                                   void* stream) {
  const int slabs = (ny + kSlab - 1) / kSlab, segs = (nx + kSeg - 1) / kSeg;
  const size_t n = (static_cast<size_t>(slabs) * nx + static_cast<size_t>(segs) * ny) * 2 * K;
  const size_t blocks = (n + 255) / 256;
  snapshot_kernel<<<static_cast<unsigned>(blocks < 65536 ? blocks : 65536), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(f, rows_snap, cols_snap, ny, nx);
  return lbm::status(cudaSuccess);
}

// K steps: out = step^K(f), out == f allowed (in place), from the snapshot
// that lbm_stream_snapshot took of f.  `partials` receives K x tiles
// floats, tiles = slabs x segments.  Launches on `stream`; returns the
// launch's cudaError_t (0 = launched).
extern "C" int lbm_stream(const float* f, float* out, const uint8_t* mask,
                          const float* rows_snap, const float* cols_snap,
                          float* partials, int ny, int nx, float w0_omega,
                          float w1_omega, float w2_omega, float one_minus_omega,
                          float accel_w1, float accel_w2, void* stream) {
  const lbm::StepConsts c{w0_omega,        w1_omega, w2_omega,
                          one_minus_omega, accel_w1, accel_w2};
  int dev = 0;
  const cudaError_t err = prepared(&dev);
  if (err != cudaSuccess) return lbm::status(err);
  const int items = ((ny + kSlab - 1) / kSlab) * ((nx + kSeg - 1) / kSeg);
  const int blocks = g_per_sm[dev] * g_sms[dev];
  const int grid = items < blocks ? items : blocks;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = nx % 4 == 0 && nx >= K && ny >= K && aligned(f) && aligned(out) &&
                   aligned(rows_snap) && aligned(cols_snap) &&
                   reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  const Args args{f, out, mask, rows_snap, cols_snap, partials, ny, nx, vec ? 1 : 0, c};
  stream_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(args);
  return lbm::status(cudaSuccess);
}
