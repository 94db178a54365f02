// K D2Q9-BGK timesteps per pass over device memory: a ghost-zone kernel
// for NVIDIA Hopper (sm_90a), K = 2..8.
//
// Replaces: advanced_hpc_lbm_tpu/ops/pallas_k.py `_kernel_k` and
// `_kernel_k_lean` (which compute the same thing bit for bit; the lean
// form only works around Mosaic's register liveness) and
// advanced_hpc_lbm_tpu/ops/pallas_multi.py `_kernel2` (the same scheme at
// K = 2), behind the `pallask` and `pallas2` backends.  The TPU kernels
// take full-width row slabs, park halo rows in scratch for the next tile
// and fetch tile 0's wrap rows by DMA, which needs the TPU's sequential
// grid.  Here every tile loads everything it needs itself:
//
// * Tiles and windows.  The grid is cut into kTx x kTy tiles of own cells,
//   numbered row-major.  A tile's window is its cells with K ghost rows
//   above and below and kA = K rounded up to 4 ghost columns left and
//   right (so that window rows are 16-byte rows of device memory): 9 planes
//   and the mask bytes, (kTy + 2K) x (kTx + 2kA), in shared memory.  Window
//   cells wrap mod ny and mod nx, so a window is a periodic image of the
//   grid, also on grids smaller than a window (17x23 at K=8 wraps more than
//   once).
// * Schedule: one block per SM, warp-specialised.  The last warpgroup
//   (4 warps) is the producer; the others form kTeams consumer teams of 8
//   warps.  The producer gives back all but 24 of its registers
//   (setmaxnreg) and the teams take them: 3 teams at 80 registers up to
//   K = 3 (a block of 25 or 28 warps gets 72 at launch, 7 warps sharing a
//   sub-partition's 16384), 2 teams at 112 above (96 at launch).  Three
//   teams beat two at K = 3 (15.9 against 17.2-17.5 us per step at
//   1024^2).  A ring of kStages windows (5 at K = 3, 3 from
//   K = 6: what 227 KB holds beside a staging tile per team) sits between
//   them, each stage with a "full" and an "empty" mbarrier.  Block b takes
//   tiles b, b + grid, ... (its n-th tile into stage n mod kStages), and
//   team j of it takes the block's tiles n = j, j + kTeams, ...: no SM
//   holds more than one tile above the mean, and no team either (at 1024^2
//   2048 tiles on 132 SMs: 15 or 16 an SM, 5 or 6 a team).
// * Feed.  The producer waits until a stage is empty and fills it with the
//   next tile's window.  A window inside the grid (1860 of 2048 tiles at
//   1024^2; rows and planes 16-byte aligned) arrives as one bulk tensor
//   copy of the 9 planes (cp.async.bulk.tensor, a (kW, kH, 9) box of a
//   CUtensorMap) that completes the stage's transaction count; its 40- or
//   48-byte mask rows, no TMA box width, by 4-byte cp.async.  A window
//   that wraps takes 16-byte cp.async copies of its 4-column groups (no
//   group straddles the wrap: xorg and nx are multiples of 4), each at its
//   wrapped row and column, spread over the producer's 4 warps (~17 copies
//   a thread); only rows that are not 16-byte aligned (nx % 4 != 0) go
//   cell by cell.  Every producer thread's copies arrive on the stage's
//   full mbarrier when they land (cp.async.mbarrier.arrive.noinc).
// * Steps.  A team waits until its stage is full, then steps K - 1 times
//   in place (window_common.cuh): step s computes rows [s, H - s) and the
//   columns [kA - K + s, kA + kTx + K - s) from the values step s-1 left
//   valid, each cell by step_common.cuh:cell_step, so the state agrees with
//   the step kernel's bit for bit; two named barriers of the team a step
//   (bar.sync 1 + team, 256), no division by a runtime value.  Step K
//   computes exactly the own cells and writes them out of place into the
//   team's dense (9, kTy, kTx) staging tile; the stage is then free.
// * Output.  One elected thread stores the staging tile with a bulk tensor
//   store (clipped at the grid's edge by the copy itself) and waits only
//   for the copy to have read it (wait_group.read) before the team's next
//   step K writes it again.  Rows not 16-byte aligned are stored by the
//   team from the staging tile.  One ||u|| partial per step and tile (own
//   fluid cells, warps summed in warp order, as before) goes to
//   partials[s, tile].
// * Forcing.  A pull is forced where its source row is an image of row
//   ny-2 (row bits of the window, by ballot), the guard at the source cell;
//   a window holding no image of it steps without the test.
// * Launches.  A launch is a programmatic dependent of the one before it
//   in the stream: its blocks start on the SMs the previous launch leaves
//   while that one ends, and the producer waits (griddepcontrol) for it to
//   be done before its first load.  The CUtensorMaps
//   (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so
//   that the library links no libcuda) are made once per (buffer, shape,
//   box) and kept in a small table: a ping-pong run uses four (a load and
//   a store map of each buffer); a launch looks them up.
// * Walks.  On a grid of whole tiles, at most kWalkTilesPerSm a pass per
//   SM, whose buffers both bulk copies take (walks), one launch walks the
//   run loop's chunk of passes (333 at K = 3): pass i reads one buffer and
//   writes the other, and the launch's items are the (pass, tile) pairs in
//   order, block b taking items b, b + grid, ... as it takes tiles in a
//   pass, pass i its tiles row-major from tile row i mod tiles_y on
//   (item_tile), so that the first tiles of a pass hold only tiles stored
//   early in the pass before.  Each tile has a flag, base + 1 + the last
//   pass it stored (base: the run's passes before the launch; the run
//   zeroes the flags once).  Before a window of pass i > 0 loads, the
//   producer waits until its tile and the 8 around it have stored pass
//   i - 1 (wait_stored): the window's reads follow their writes, and the
//   tile's own store follows their windows' reads of its cells in pass
//   i - 1, each loaded before it stored.  A team says an item stored
//   (flag_stored: cp.async.bulk.wait_group, a proxy fence, a release) once
//   its next store is issued, or before it waits for a window not yet
//   there, or at the end, so that nothing waits in a cycle.  Its blocks
//   wait for each other, so a walk is launched cooperative (co-resident).
//   A walk is its own instantiation (kWalk), so that the one-pass kernel
//   keeps none of its code.  Elsewhere, and always in the local form, a
//   pass is a launch.
//
// Bound on this card: device memory moves (9 x 4 + 1) B per cell in and
// 36 B out per pass, 24.3 B per cell and step at K = 3 and 18.25 at K = 4
// (121.87 and 91.40 us per step at 4096^2 at 3.35 TB/s).  A cell step is
// ~145 instructions (94 float32 operations, an IEEE 1/rho and sqrt, 10
// shared-memory loads and 9 stores; SASS), and the ghost ring is stepped
// redundantly (1844 cell steps per 1536 own ones at K = 3, 2680 per 2048 at
// K = 4).  On an H100 80GB HBM3 at 700 W (chip_smoke.py 3k): K = 3 runs
// 187-190 us per step at 4096^2 and 15.4-15.9 at 1024^2 a launch a pass,
// where the design before (3 blocks of 256 threads per SM, two windows
// each, every thread issuing copies and stores) ran 237-241 and 18.8-19.1.
// At 1024^2 a launch of one pass is ~2.4 us per tile of an SM plus ~9 us
// of its start (the producers of 132 SMs asking for 3 windows each at
// once: a team's first window lands 3-7 us after the pass before ends)
// and of the 68 SMs whose 16th tile runs on one team alone (~6 us); a
// walk pays neither but its items more (kWalkTilesPerSm): 13.8 against
// 15.2 us a step at 1024^2, 5.5 against 5.9 at 512^2.
//
// The local form (kLocal, `lbm_local_ca`) replaces
// advanced_hpc_lbm_tpu/ops/pallas_local.py `_local_ca_kernel`, behind
// parallel/halo.py's `pallas` shard kernel with ca_steps = K: K steps of one
// shard of a 1-D ring from its (ly+2K, nx) ghost window, whose K ghost rows
// above and below the own rows [K, K+ly) the exchange fills from the ring
// neighbours.  It shares the schedule, the feed (its interior windows are
// boxes of the ghost window, its stores boxes of the (ly, nx) output), the
// steps and the per-cell code: one code path keeps the two forms equal to
// the plain versions alike.  Three differences:
//
// * Tiles.  The tiles cover the own rows only; tile rows y0.. load window
//   rows y0.. (own row y is window row y + K), x wraps mod nx.  The last
//   tile row may be ragged (ly not a multiple of kTy): its window then
//   reaches past the ghost window's last row, ly+2K-1, and those rows are
//   loaded wrapped mod ly+2K, i.e. garbage.  The steps spread garbage one
//   row per step, so after K steps it has reached window row ly+K, the
//   first row past the own rows, and no own row (the TPU kernel's argument
//   for its wrapping rolls over the whole window), whatever kTy is.
// * Forcing.  From the window's encoded mask (+2), per cell, on the rows
//   that hold a +2 cell: global row ny-2 can appear twice in a window (a
//   shard's own row and, on the last shard, the ghost image of it), and a
//   mask marks both.
// * Partials.  Only own cells of a tile are counted, and a tile's own
//   cells are own rows of the shard, so the ghost rows never enter the
//   ||u|| sums.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda is linked)

#include <cstdint>
#include <mutex>
#include <type_traits>

#include "step_common.cuh"
#include "window_common.cuh"

namespace {

constexpr int kTx = 32;  // tile width (own cells): one warp per window row
constexpr int kTy = 16;  // tile height (own cells)
constexpr int kTeamThreads = 256;  // a consumer team: 8 warps
constexpr int kTeamWarps = kTeamThreads / 32;
constexpr int kProducerThreads = 128;  // the producer: a warpgroup
constexpr int kProducerRegs = 24;      // ... at setmaxnreg's least
constexpr int kSmemLimit = 232448;  // shared memory a block may use (227 KB)
constexpr int kAlign = 128;         // bulk copies' shared-memory alignment

template <int K>
struct Shape {
  static constexpr int kA = (K + 3) / 4 * 4;  // ghost columns loaded per side
  static constexpr int kH = kTy + 2 * K;      // window rows
  static constexpr int kW = kTx + 2 * kA;     // window columns = row pitch
  static constexpr int kGroups = kW / 4;      // groups of 4 columns per window row
  using Geo = lbm::WinGeo<kH, kW>;
  // consumer teams per block: 3 up to K = 3, where the staged cells of 24
  // warps fit 80 registers; else 2, at 112
  static constexpr int kTeams = K <= 3 ? 3 : 2;
  static constexpr int kThreads = kTeams * kTeamThreads + kProducerThreads;
  // Registers a thread: at launch, what the SM's 4 sub-partitions give the
  // block's warps (a quarter each, 16384 registers a sub-partition); then
  // the producer warpgroup gives back all but kProducerRegs, and the
  // consumers take them (setmaxnreg).
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kLaunchRegs = 16384 / (kWarps / 4 * 32) / 8 * 8;
  static constexpr int kConsumerRegs = K <= 3 ? 80 : 112;
  static_assert(kWarps % 4 == 0, "whole warpgroups");
  static_assert(kTeams * kTeamWarps * kConsumerRegs + 4 * kProducerRegs <= kWarps * kLaunchRegs,
                "the block's registers");
  static_assert(kTeams * 2 * kConsumerRegs + kProducerRegs <= 512, "a sub-partition's");
  static constexpr int kPlaneBytes = 4 * Geo::kFloats;  // one bulk copy
  static constexpr int kStageBytes = (Geo::kBytes + kAlign - 1) / kAlign * kAlign;
  static constexpr int kOutBytes = 4 * 9 * kTy * kTx;  // a team's staging tile
  // beside the ring: the alignment, the staging tiles, the mbarriers (2 a
  // stage, up to 8 stages) and the ||u|| sums (2 tiles x K steps x 8 warps
  // a team)
  static constexpr int kSumBytes = 4 * kTeams * 2 * K * kTeamWarps;
  static constexpr int kFixedBytes = kAlign + kTeams * kOutBytes + 2 * 8 * 8 + kSumBytes;
  static constexpr int kStages = (kSmemLimit - kFixedBytes) / kStageBytes;
  static_assert(kStages >= 3 && kStages <= 8, "a ring of 3 to 8 windows");
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr size_t kSmemBytes = kFixedBytes + kRingBytes;
};

// The kernel's arguments, a __grid_constant__ parameter: they stay in the
// constant bank, so the steps keep none of them in registers, and the
// tensor maps are addressed there by the bulk copies.  kLocal = false: a
// periodic (rows, nx) grid, src_rows = rows, mask nonzero = blocked,
// forcing on row rows-2.  kLocal = true: the own rows [0, rows) of a shard
// read from its (src_rows = rows+2K, nx) window, mask encoded (+1/+2).
// `f` / `out` have plane strides f_plane / out_plane.  bulk_load: f,
// f_plane, nx and mask allow 16-byte window rows and `src_map` maps f;
// bulk_store: out and out_plane allow them and `out_map` maps out.
struct Args {
  CUtensorMap src_map;  // (nx, src_rows, 9) floats, box (kW, kH, 9)
  CUtensorMap out_map;  // (nx, rows, 9) floats, box (kTx, kTy, 9)
  // a walk's odd passes read `out` and write `f`: src_map of out, out_map of f
  CUtensorMap src_map_odd, out_map_odd;
  const float* f;
  long long f_plane;
  int src_rows;
  float* out;
  long long out_plane;
  const uint8_t* mask;
  float* partials;
  int* flags;  // the walk's: a tile's is base + 1 + the last pass it stored
  int rows, nx, bulk_load, bulk_store, passes, base;
  lbm::StepConsts c;
  __device__ __forceinline__ int tiles_x() const { return (nx + kTx - 1) / kTx; }
  __device__ __forceinline__ int tiles_y() const { return (rows + kTy - 1) / kTy; }
  __device__ __forceinline__ int tiles() const { return tiles_x() * tiles_y(); }
  // row and column of tile t's own cell (0, 0)
  __device__ __forceinline__ void origin(int t, int& y0, int& x0) const {
    const int ty = t / tiles_x();
    y0 = ty * kTy;
    x0 = (t - ty * tiles_x()) * kTx;
  }
  __device__ __forceinline__ int item(int j, int& i) const;
};

// Item j of a launch on a grid of tx x ty tiles: pass i = j / tiles, and
// the tile at position j mod tiles of that pass, whose tile rows start at
// row i mod ty, so that the first tiles of a pass need only tiles that the
// pass before stored early (lbm_kstep_item).
__host__ __device__ __forceinline__ int item_tile(int tx, int ty, int j, int& i) {
  const int n = tx * ty;
  i = j / n;
  const int pos = j - i * n, r = pos / tx;
  int row = r + i % ty;
  if (row >= ty) row -= ty;
  return row * tx + (pos - r * tx);
}

__device__ __forceinline__ int Args::item(int j, int& i) const {
  return item_tile(tiles_x(), tiles_y(), j, i);
}

// A walk pays on grids of at most this many tiles a pass per SM: it saves
// a launch's start and tail, ~9 us a pass, and costs its items: at 512^2
// and 1024^2 (4 and 16 tiles an SM) it ran 7% and 9% faster than a launch
// a pass; at 2048^2 and 4096^2 (62 and 248) 12-14% slower even with its
// blocks paced to one band of tile rows (unpaced, they drifted apart over
// the walk, L2 lost the ghost rows, and 4096^2 ran 300 against 194 us a
// step).
constexpr int kWalkTilesPerSm = 16;

// Whether a launch of `passes` passes walks them all on a card of `sms`
// SMs (else one launch a pass): the periodic form, buffers that both bulk
// copies take, a grid of whole tiles, so that a window's cells lie in its
// tile and the 8 around it, and at most kWalkTilesPerSm tiles a pass per
// SM (lbm_kstep_walks).
template <bool kLocal>
__host__ __device__ __forceinline__ bool walks(int rows, int nx, bool bulk, int sms) {
  return !kLocal && bulk && rows % kTy == 0 && nx % kTx == 0 &&
         (rows / kTy) * (nx / kTx) <= kWalkTilesPerSm * sms;
}

// Whether the window of the tile at (y0, x0) lies inside its source rows
// and columns (no wrap): such a window is one box of the source.  The rule
// of the bulk feed, with the alignment (lbm_kstep_bulk_tiles).
template <int K, bool kLocal>
__host__ __device__ __forceinline__ bool rows_inside(int y0, int src_rows) {
  const int yorg = kLocal ? y0 : y0 - K;
  return yorg >= 0 && yorg + Shape<K>::kH <= src_rows;
}

template <int K>
__host__ __device__ __forceinline__ bool cols_inside(int x0, int nx) {
  const int xorg = x0 - Shape<K>::kA;
  return xorg >= 0 && xorg + Shape<K>::kW <= nx;
}

template <int K, bool kLocal>
__host__ __device__ __forceinline__ bool window_inside(int y0, int x0, int src_rows, int nx) {
  return rows_inside<K, kLocal>(y0, src_rows) && cols_inside<K>(x0, nx);
}

// ---- mbarriers, bulk copies, named barriers (sm_90) ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The mbarrier counts one arrival once this thread's earlier cp.async
// copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(0), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, int x, int y,
                                          const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3}], [%4];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(0), "r"(smem_addr(src))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// This thread's bulk stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ... all but the last one.
__device__ __forceinline__ void bulk_wait_prior() {
  asm volatile("cp.async.bulk.wait_group 1;\n" ::: "memory");
}

// Whether the phase of parity `parity` of the mbarrier has completed (no wait).
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// ---- the walk's flags ---------------------------------------------------------------

constexpr int kMaxPolls = 1 << 24;  // ~10 s of polling: a fault, not a wait

// Sets tile t's flag to `value` once this thread's bulk store of it is done
// (cp.async.bulk.wait_group): the proxy fence orders the store's writes
// (async proxy) before the flag's release (generic proxy).
__device__ __forceinline__ void flag_stored(const Args& a, int t, int value) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("st.release.gpu.b32 [%0], %1;\n" ::"l"(a.flags + t), "r"(value) : "memory");
}

// Before the calling warp copies tile t of the launch's pass i > 0, it
// waits until t and the 8 tiles around it (wrapped) have stored pass
// i - 1 (their flags are at base + i).  Then the warp's copies and the
// bulk copy after it read what those stores wrote, and overwrite nothing
// their windows had still to read: each of them loaded its window, which
// holds the cells of t's tile, before it stored.  A poll that exceeds
// kMaxPolls (~10 s of polling; a pass takes at most milliseconds, so only
// a fault, or the card taken from the process for that long, gets there)
// traps, so that a fault ends the run with an error instead of a hang.
__device__ __forceinline__ void wait_stored(const Args& a, int t, int i, int lane) {
  // every lane polls a flag (lanes past 8 repeat lanes 0-8's) and the
  // loop's exit is a vote: no branch of the warp diverges, which keeps the
  // producer in its 24 registers (a loop of lanes 0-8 alone spilled 216
  // bytes a thread)
  const int tx = a.tiles_x(), ty = a.tiles_y();
  const int e = lane % 9, r = t / tx, c = t - r * tx;
  int y = r + e / 3 - 1, x = c + e % 3 - 1;
  y = y < 0 ? y + ty : y >= ty ? y - ty : y;
  x = x < 0 ? x + tx : x >= tx ? x - tx : x;
  const int* const flag = a.flags + y * tx + x;
  const int want = a.base + i;
  for (int polls = 0;; ++polls) {
    int v;
    asm volatile("ld.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(flag) : "memory");
    if (__all_sync(0xffffffffu, v >= want)) break;
    if (polls >= kMaxPolls) __trap();
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// A consumer team's 256 threads and their named barrier.  Its in-place
// steps' barriers also hold the team until its last bulk store has read
// the staging tile (thread 0 issued it), which the step after them
// overwrites; the last step's barrier makes the team's shared-memory
// writes visible to the bulk copies (the staging tile's store, the next
// window's load into the stage it wrote).
struct TeamBarrier {
  int tt, id;
  __device__ __forceinline__ int tid() const { return tt; }
  __device__ __forceinline__ void bar() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kTeamThreads) : "memory");
  }
};

struct InPlaceBarrier : TeamBarrier {
  __device__ __forceinline__ void sync() const {
    if (tt == 0) bulk_wait_read();
    bar();
  }
};

struct LastBarrier : TeamBarrier {
  __device__ __forceinline__ void sync() const {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar();
  }
};

// ---- the producer ------------------------------------------------------------------

// Fill `buf` with tile t's window, by the producer's 128 threads (thread
// pt), each then arriving on the stage's full mbarrier `full` once its
// copies have landed, and lane 0 of each warp once the warp's stores are
// done (expected: 128 + 4 arrivals; warp 0's carries the bulk copy's
// bytes).  Window cell (r, c) is source cell ((yorg + r) mod src_rows,
// (xorg + c) mod nx): yorg K rows above the tile on the periodic grid, or
// window row y0 of a shard's ghost window (whose own rows start K rows
// down).
template <int K, bool kLocal>
__device__ __forceinline__ void load_window(uint8_t* buf, const Args& a, int t, bool odd,
                                            int pt, uint32_t full) {
  using S = Shape<K>;
  using G = typename S::Geo;
  int y0, x0;
  a.origin(t, y0, x0);
  const int yorg = kLocal ? y0 : y0 - K, xorg = x0 - S::kA;
  float* const wf = reinterpret_cast<float*>(buf);
  uint8_t* const wm = buf + S::kPlaneBytes;
  const size_t fp = static_cast<size_t>(a.f_plane);
  const float* const src = odd ? a.out : a.f;  // a walk's odd pass reads out
  const bool bulk = a.bulk_load && window_inside<K, kLocal>(y0, x0, a.src_rows, a.nx);
  if (a.bulk_load) {
    // 16-byte groups of 4 columns: xorg and nx are multiples of 4, so no
    // group straddles the wrap; the bulk copy brings the planes of a
    // window inside the grid, 16-byte copies those of one that wraps
    for (int i = pt; i < S::kH * S::kGroups; i += kProducerThreads) {
      const int r = i / S::kGroups, q = i - r * S::kGroups;
      const int y = bulk ? yorg + r : lbm::wrap(yorg + r, a.src_rows);
      const int x = bulk ? xorg + 4 * q : lbm::wrap(xorg + 4 * q, a.nx);
      const size_t g = static_cast<size_t>(y) * a.nx + x;
      const int j = r * S::kW + 4 * q;
      if (!bulk) {
#pragma unroll
        for (int k = 0; k < 9; ++k) lbm::cp_async16(wf + k * G::kPlane + j, src + k * fp + g);
      }
      lbm::cp_async4(wm + j, a.mask + g);
    }
  } else {
    // rows not 16-byte aligned: cell by cell, the mask bytes loaded before
    // any is stored
    constexpr int kEach = (G::kPlane + kProducerThreads - 1) / kProducerThreads;
    uint8_t m[kEach];
#pragma unroll
    for (int e = 0; e < kEach; ++e) {
      const int i = pt + e * kProducerThreads;
      if (e + 1 < kEach || i < G::kPlane) {
        const int r = i / S::kW, c = i - r * S::kW;
        const size_t g = static_cast<size_t>(lbm::wrap(yorg + r, a.src_rows)) * a.nx +
                         lbm::wrap(xorg + c, a.nx);
#pragma unroll
        for (int k = 0; k < 9; ++k) lbm::cp_async4(wf + k * G::kPlane + i, a.f + k * fp + g);
        m[e] = a.mask[g];
      }
    }
#pragma unroll
    for (int e = 0; e < kEach; ++e) {
      const int i = pt + e * kProducerThreads;
      if (e + 1 < kEach || i < G::kPlane) wm[i] = m[e];
    }
  }
  cp_async_arrive(full);
  __syncwarp();  // the warp's mask bytes, released by lane 0's arrival
  if ((pt & 31) == 0) {
    if (pt == 0 && bulk) {
      // the stage's earlier writes (by 16-byte copies) before the bulk copy's
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive_expect_tx(full, S::kPlaneBytes);
      tma_load(wf, odd ? &a.src_map_odd : &a.src_map, xorg, yorg, full);
    } else {
      mbar_arrive(full);
    }
  }
}

// ---- the consumers ------------------------------------------------------------------

// Steps s = S..K of one window: in place up to K - 1, then step K (the own
// cells) into the staging tile.
template <int K, int S, bool kLocal, bool kForce, class Counted>
__device__ __forceinline__ void steps(const lbm::Window<Shape<K>::kH, Shape<K>::kW, kForce,
                                                        kLocal>& win,
                                      float* planes, float* staged, const lbm::StepConsts& c,
                                      Counted counted, float (*wsum)[kTeamWarps], int warp,
                                      const TeamBarrier& team) {
  using Sh = Shape<K>;
  auto total = [&](float v) { wsum[S - 1][warp] = v; };
  if constexpr (S < K) {
    lbm::step<kTeamThreads, S, Sh::kH - 2 * S, Sh::kA - K + S, kTx + 2 * (K - S), true>(
        win, lbm::WindowDst<typename Sh::Geo>{planes}, c, counted, total,
        InPlaceBarrier{team});
    steps<K, S + 1, kLocal, kForce>(win, planes, staged, c, counted, wsum, warp, team);
  } else {
    lbm::step<kTeamThreads, K, kTy, Sh::kA, kTx, false>(
        win, lbm::TileDst<kTy, kTx, K, Sh::kA>{staged}, c, counted, total, LastBarrier{team});
  }
}

// One team's items: the block's n-th items for n = team, team + kTeams, ...
// In a walk, thread 0 says that an item is stored (its flag) once its bulk
// store is done: after the team's next store was issued, or before it
// waits for a window that is not there yet, or at the end; `held` (shared)
// keeps the flag and value of the item it has not yet said.  So no flag is
// held back while the team waits, and nothing waits in a cycle: items are
// taken in increasing order, and each waits only on items of the pass
// before.
template <int K, bool kLocal, bool kWalk>
__device__ __forceinline__ void consume(const Args& a, uint8_t* ring, float* staged,
                                        uint32_t full0, uint32_t empty0,
                                        float (*sums)[K][kTeamWarps], int* held, int team,
                                        int tt) {
  using S = Shape<K>;
  const int lane = tt & 31, warp = tt >> 5;
  const TeamBarrier bar{tt, 1 + team};
  const int tiles = a.tiles(), items = kWalk ? tiles * a.passes : tiles;
  if (kWalk && tt == 0) held[0] = -1;
  for (int m = 0;; ++m) {
    const int n = team + m * S::kTeams;
    const int g = blockIdx.x + n * static_cast<int>(gridDim.x);  // the item
    if (g >= items) break;
    int i = 0;  // its pass of the launch
    const int t = kWalk ? a.item(g, i) : g;
    const int s = n % S::kStages;
    const uint32_t phase = (n / S::kStages) & 1;
    if (kWalk && tt == 0 && held[0] >= 0 && !mbar_test(full0 + 8 * s, phase)) {
      bulk_wait();
      flag_stored(a, held[0], held[1]);
      held[0] = -1;
    }
    mbar_wait(full0 + 8 * s, phase);
    uint8_t* const buf = ring + s * S::kStageBytes;
    float* const planes = reinterpret_cast<float*>(buf);
    const uint8_t* const wm = buf + S::kPlaneBytes;
    float(*wsum)[kTeamWarps] = sums[m & 1];
    int y0, x0;
    a.origin(t, y0, x0);
    // own cells inside the grid: rows [K, K + own_h), columns [kA, kA + own_w)
    const int own_h = min(kTy, a.rows - y0), own_w = min(kTx, a.nx - x0);
    {
      const unsigned uh = own_h, uw = own_w;
      auto counted = [uh, uw](int r, int col, uint8_t, bool obst) {
        return !obst && static_cast<unsigned>(r - K) < uh &&
               static_cast<unsigned>(col - S::kA) < uw;
      };
      lbm::RowBits<(S::kH + 31) / 32> frow;
      if constexpr (kLocal) {
        frow = lbm::forcing_rows<S::kH, S::kW>(wm, lane);
      } else {
        const int yorg = y0 - K, nr = a.src_rows;
        const bool inside = yorg >= 0 && yorg + S::kH <= nr;
        frow = lbm::row_bits<S::kH>(lane, [&](int r) {
          return (inside ? yorg + r : lbm::wrap(yorg + r, nr)) == nr - 2;
        });
      }
      if (frow.any()) {
        const lbm::Window<S::kH, S::kW, true, kLocal> win{planes, wm, frow};
        steps<K, 1, kLocal, true>(win, planes, staged, a.c, counted, wsum, warp, bar);
      } else {
        const lbm::Window<S::kH, S::kW, false, kLocal> win{planes, wm, frow};
        steps<K, 1, kLocal, false>(win, planes, staged, a.c, counted, wsum, warp, bar);
      }
    }
    if (tt == 0) {
      mbar_arrive(empty0 + 8 * s);  // the stage is free
      if (a.bulk_store) {
        if (kWalk && (i & 1)) {
          tma_store(&a.out_map_odd, x0, y0, staged);
        } else {
          tma_store(&a.out_map, x0, y0, staged);
        }
      }
      if (kWalk) {
        if (held[0] >= 0) {
          bulk_wait_prior();
          flag_stored(a, held[0], held[1]);
        }
        held[0] = t;
        held[1] = a.base + i + 1;
      }
    }
    if (!a.bulk_store) {
      const size_t op = static_cast<size_t>(a.out_plane);
      for (int j = tt; j < kTy * kTx; j += kTeamThreads) {
        const int oy = j / kTx, ox = j % kTx;
        if (oy < own_h && ox < own_w) {
          const size_t g = static_cast<size_t>(y0 + oy) * a.nx + x0 + ox;
#pragma unroll
          for (int k = 0; k < 9; ++k) a.out[k * op + g] = staged[k * kTy * kTx + j];
        }
      }
    }
    if (tt < K) {
      float total = 0.0f;
#pragma unroll
      for (int w = 0; w < kTeamWarps; ++w) total = total + wsum[tt][w];
      a.partials[(static_cast<size_t>(i) * K + tt) * tiles + t] = total;
    }
  }
  if (tt == 0) {
    bulk_wait();
    if (kWalk && held[0] >= 0) flag_stored(a, held[0], held[1]);
  }
}

// kWalk: a launch that walks its passes (walks); else one pass.
template <int K, bool kLocal, bool kWalk>
__global__ void __launch_bounds__(Shape<K>::kThreads, 1)
    kstep_kernel(const __grid_constant__ Args a) {
  using S = Shape<K>;
  extern __shared__ float4 smem_raw[];
  uint8_t* const base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) / kAlign * kAlign);
  uint8_t* const ring = base;
  float* const staged = reinterpret_cast<float*>(base + S::kRingBytes);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(base + S::kRingBytes +
                                                     S::kTeams * S::kOutBytes);
  auto* const sums = reinterpret_cast<float(*)[2][K][kTeamWarps]>(bars + 2 * S::kStages);
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + S::kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full0 + 8 * s, kProducerThreads + kProducerThreads / 32);
      mbar_init(empty0 + 8 * s, 1);  // the team's thread 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the next pass may launch now: its blocks take the SMs this grid
  // leaves and set up while it ends, then wait (below) for it to be done
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  __shared__ int held[S::kTeams][2];  // each team's (see consume)
  const int team = threadIdx.x / kTeamThreads;
  if (team == S::kTeams) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // the previous pass (the launch before in the stream) has ended and
    // its writes are visible: every access of device memory of this grid
    // follows this wait (the consumers' follow the windows' loads)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const int pt = threadIdx.x - S::kTeams * kTeamThreads;
    const int items = kWalk ? a.tiles() * a.passes : a.tiles();
    for (int n = 0;; ++n) {
      const int j = blockIdx.x + n * static_cast<int>(gridDim.x);
      if (j >= items) break;
      int i = 0;
      const int t = kWalk ? a.item(j, i) : j;
      const int s = n % S::kStages;
      // in a walk, pass i > 0 of the launch loads once the tiles its
      // window holds have stored pass i - 1 (pass 0 follows the launch
      // before, by griddepcontrol.wait)
      if (kWalk && i > 0) wait_stored(a, t, i, pt & 31);
      if (n >= S::kStages) mbar_wait(empty0 + 8 * s, (n / S::kStages - 1) & 1);
      uint8_t* const buf = ring + s * S::kStageBytes;
      load_window<K, kLocal>(buf, a, t, kWalk && (i & 1), pt, full0 + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));
    consume<K, kLocal, kWalk>(a, ring, staged + team * (S::kOutBytes / 4), full0, empty0,
                              sums[team], held[team], team, threadIdx.x % kTeamThreads);
  }
}

// ---- host side ----------------------------------------------------------------------

// Blocks per SM of the persistent grid per device, K and form (0: not
// prepared), and the device's SMs.
constexpr int kMaxDevices = 64;
int g_per_sm[kMaxDevices][9][2];
int g_sms[kMaxDevices];

cudaError_t current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  return *dev < kMaxDevices ? cudaSuccess : cudaErrorInvalidDevice;
}

// Sets one kernel's shared-memory limit on the current device and sets
// *per_sm from the occupancy query; fails where a block fits no SM or
// starts with other than kLaunchRegs registers.
template <int K, bool kLocal, bool kWalk>
cudaError_t prepare_kernel(int* per_sm) {
  const auto kernel = kstep_kernel<K, kLocal, kWalk>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Shape<K>::kSmemBytes));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, Shape<K>::kThreads,
                                                        Shape<K>::kSmemBytes);
  }
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;  // a block does not fit on an SM
  // the consumers' setmaxnreg.inc takes what the producer gives back of
  // the launch's registers: with fewer at launch it would wait for ever
  if (attr.numRegs != Shape<K>::kLaunchRegs) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// Prepares the form's kernels (the periodic form's walk too) on device
// `dev`, the current device, and records its blocks per SM and SMs.
template <int K, bool kLocal>
cudaError_t prepare_on(int dev) {
  int per_sm = 0, walk_per_sm = 0, sms = 0;
  cudaError_t err = prepare_kernel<K, kLocal, false>(&per_sm);
  if (err == cudaSuccess && !kLocal) err = prepare_kernel<K, false, true>(&walk_per_sm);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  g_sms[dev] = sms;
  g_per_sm[dev][K][kLocal] = per_sm;
  return cudaSuccess;
}

// Prepares the kernel on the current device unless it is; sets *dev.
template <int K, bool kLocal>
cudaError_t prepared(int* dev) {
  cudaError_t err = current_device(dev);
  if (err == cudaSuccess && g_per_sm[*dev][K][kLocal] == 0) err = prepare_on<K, kLocal>(*dev);
  return err;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no libcuda link).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor maps made so far, by (buffer, plane stride, shape, box): a
// run asks for the same few every pass, so each is encoded once.
struct MapEntry {
  const float* p;
  long long plane;
  int rows, nx, box_w, box_h;
  CUtensorMap map;
};
constexpr int kMaps = 64;
MapEntry g_maps[kMaps];
int g_map_count = 0, g_map_next = 0;
std::mutex g_maps_mutex;

// *map = the (nx, rows, 9) float map of `p` (row stride nx, plane stride
// `plane` floats, 16-byte multiples) with a (box_w, box_h, 9) box.
cudaError_t tensor_map(const float* p, long long plane, int rows, int nx, int box_w,
                       int box_h, CUtensorMap* map) {
  const std::lock_guard<std::mutex> lock(g_maps_mutex);
  for (int i = 1; i <= g_map_count; ++i) {  // the newest first
    const MapEntry& e = g_maps[(g_map_next - i + kMaps) % kMaps];
    if (e.p == p && e.plane == plane && e.rows == rows && e.nx == nx && e.box_w == box_w &&
        e.box_h == box_h) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  MapEntry& e = g_maps[g_map_next];
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(nx), static_cast<cuuint64_t>(rows), 9};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(nx) * 4,
                                 static_cast<cuuint64_t>(plane) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h),
                             9};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                            const_cast<float*>(p), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  e.p = p;
  e.plane = plane;
  e.rows = rows;
  e.nx = nx;
  e.box_w = box_w;
  e.box_h = box_h;
  g_map_next = (g_map_next + 1) % kMaps;
  if (g_map_count < kMaps) ++g_map_count;
  *map = e.map;
  return cudaSuccess;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// `passes` passes from f (pass i reads what pass i - 1 wrote, pass 0 f, and
// writes the other of f and out), partials[pass][K][tile]: one launch that
// walks them (`flags` the run's, `base` its passes before this launch), or
// where the grid does not walk (walks) one launch a pass.  The local form
// takes one pass.
template <int K, bool kLocal>
cudaError_t launch(const float* f, long long f_plane, int src_rows, float* out,
                   long long out_plane, const uint8_t* mask, float* partials, int* flags,
                   int passes, int base, int rows, int nx, const lbm::StepConsts& c,
                   cudaStream_t stream) {
  using S = Shape<K>;
  int dev = 0;
  cudaError_t err = prepared<K, kLocal>(&dev);
  if (err != cudaSuccess) return err;
  const int tiles = ((nx + kTx - 1) / kTx) * ((rows + kTy - 1) / kTy);
  const int grid = tiles < g_sms[dev] ? tiles : g_sms[dev];
  const bool bulk_load = nx % 4 == 0 && f_plane % 4 == 0 && aligned16(f) &&
                         reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  const bool bulk_store = nx % 4 == 0 && out_plane % 4 == 0 && aligned16(out);
  if (passes > 1 && !walks<kLocal>(rows, nx, bulk_load && bulk_store, g_sms[dev])) {
    float* const buf[2] = {const_cast<float*>(f), out};
    for (int i = 0; i < passes && err == cudaSuccess; ++i) {
      err = launch<K, kLocal>(buf[i & 1], f_plane, src_rows, buf[(i + 1) & 1], out_plane,
                              mask, partials + static_cast<size_t>(i) * K * tiles, nullptr,
                              1, 0, rows, nx, c, stream);
    }
    return err;
  }
  Args args{};
  if (bulk_load) err = tensor_map(f, f_plane, src_rows, nx, S::kW, S::kH, &args.src_map);
  if (err == cudaSuccess && bulk_store) {
    err = tensor_map(out, out_plane, rows, nx, kTx, kTy, &args.out_map);
  }
  if (err == cudaSuccess && passes > 1) {
    err = tensor_map(out, out_plane, rows, nx, S::kW, S::kH, &args.src_map_odd);
    if (err == cudaSuccess) err = tensor_map(f, f_plane, rows, nx, kTx, kTy, &args.out_map_odd);
  }
  if (err != cudaSuccess) return err;
  args.f = f;
  args.f_plane = f_plane;
  args.src_rows = src_rows;
  args.out = out;
  args.out_plane = out_plane;
  args.mask = mask;
  args.partials = partials;
  args.flags = flags;
  args.rows = rows;
  args.nx = nx;
  args.bulk_load = bulk_load ? 1 : 0;
  args.bulk_store = bulk_store ? 1 : 0;
  args.passes = passes;
  args.base = base;
  args.c = c;
  // launched as a programmatic dependent of the launch before it; a walk's
  // blocks wait for each other's flags, so it is launched co-resident
  cudaLaunchAttribute attrs[2]{};
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = S::kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attrs;
  if (kLocal || passes == 1) return cudaLaunchKernelEx(&cfg, kstep_kernel<K, kLocal, false>, args);
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kstep_kernel<K, false, true>, args);
}

// Calls fn(std::integral_constant<int, K>{}) for K = k, the one list of
// the K the kernel is built for (K_RANGE in ops/kstep_kernel.py).
template <class Fn>
cudaError_t with_k(int k, Fn fn) {
  switch (k) {
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 5: return fn(std::integral_constant<int, 5>{});
    case 6: return fn(std::integral_constant<int, 6>{});
    case 7: return fn(std::integral_constant<int, 7>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The tile of own cells of one team; the wrapper sizes the partials from it.
extern "C" void lbm_kstep_tile_shape(int* tile_x, int* tile_y) {
  *tile_x = kTx;
  *tile_y = kTy;
}

// Consumer teams per block and window stages of the ring of the kernel
// for K; returns 0, or cudaErrorInvalidValue for a K not built.
extern "C" int lbm_kstep_schedule(int k, int* teams, int* stages) {
  return static_cast<int>(with_k(k, [&](auto kk) {
    *teams = Shape<decltype(kk)::value>::kTeams;
    *stages = Shape<decltype(kk)::value>::kStages;
    return cudaSuccess;
  }));
}

// Tiles of one pass of the (ny, nx) grid at K that the bulk tensor copy
// feeds (the others wrap): the kernel's own rule, for 16-byte aligned
// state and 4-byte aligned mask buffers.  0 for a K not built.
extern "C" int lbm_kstep_bulk_tiles(int ny, int nx, int k) {
  int bulk = 0;
  with_k(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    if (nx % 4 != 0) return cudaSuccess;
    int rows = 0, cols = 0;
    for (int y0 = 0; y0 < ny; y0 += kTy) rows += rows_inside<K, false>(y0, ny);
    for (int x0 = 0; x0 < nx; x0 += kTx) cols += cols_inside<K>(x0, nx);
    bulk = rows * cols;
    return cudaSuccess;
  });
  return bulk;
}

// Loads the kernel for K (both forms) onto the current device and sets its
// shared-memory limit, without launching it.  A launch on a device not yet
// prepared prepares it first.
extern "C" int lbm_kstep_prepare(int k) {
  return lbm::status(with_k(k, [](auto kk) {
    constexpr int K = decltype(kk)::value;
    int dev = 0;
    const cudaError_t err = prepared<K, false>(&dev);
    return err != cudaSuccess ? err : prepared<K, true>(&dev);
  }));
}

// Blocks per SM that fit of the kernel for K (form `local`) on the current
// device, preparing it first (the grid takes one an SM); 0 if it cannot
// run there.
extern "C" int lbm_kstep_blocks_per_sm(int k, int local) {
  int per_sm = 0;
  with_k(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    int dev = 0;
    const cudaError_t err = local ? prepared<K, true>(&dev) : prepared<K, false>(&dev);
    if (err == cudaSuccess) per_sm = g_per_sm[dev][K][local != 0];
    return err;
  });
  lbm::status(cudaSuccess);
  return per_sm;
}

// `passes` passes of K steps: pass i reads f (i even) or out (i odd) and
// writes the other, so the state ends in out after an odd count of passes
// and in f after an even one.  `partials` receives passes x K x tiles
// floats, tiles = ceil(ny/16) * ceil(nx/32), in row-major tile order.  On a
// grid that walks (lbm_kstep_walks) one launch runs every pass, on `flags`
// (tiles ints, zero at the start of a run, which this launch's passes
// continue after `base` passes); elsewhere one launch runs each pass
// (`flags` unused, may be null for one pass).  Launches on `stream`;
// returns the launches' cudaError_t (0 = launched).
extern "C" int lbm_kstep(const float* f, float* out, const uint8_t* mask,
                         float* partials, int* flags, int ny, int nx, int k, int passes,
                         int base, float w0_omega, float w1_omega, float w2_omega,
                         float one_minus_omega, float accel_w1,
                         float accel_w2, void* stream) {
  if (passes < 1 || (passes > 1 && flags == nullptr)) {
    return lbm::status(cudaErrorInvalidValue);
  }
  const lbm::StepConsts c{w0_omega,        w1_omega, w2_omega,
                          one_minus_omega, accel_w1, accel_w2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(ny) * nx;
  return lbm::status(with_k(k, [&](auto kk) {
    return launch<decltype(kk)::value, false>(f, plane, ny, out, plane, mask, partials,
                                              flags, passes, base, ny, nx, c, st);
  }));
}

// Whether lbm_kstep walks a launch's passes in one launch on the (ny, nx)
// grid with 16-byte aligned state and 4-byte aligned mask buffers on the
// current device (else it launches once a pass): the kernel's rule
// (walks); 0 where the device cannot be prepared.
extern "C" int lbm_kstep_walks(int ny, int nx) {
  int dev = 0;
  if (lbm::status(prepared<3, false>(&dev)) != 0) return 0;
  return walks<false>(ny, nx, nx % 4 == 0, g_sms[dev]);
}

// The tile of item j of a walk on the (ny, nx) grid, and its pass in *pass
// (item_tile).
extern "C" int lbm_kstep_item(int ny, int nx, int j, int* pass) {
  return item_tile((nx + kTx - 1) / kTx, (ny + kTy - 1) / kTy, j, *pass);
}

// K steps of one shard: out = the own rows of step^K(win), win the
// (ly+2K, nx) ghost window (plane stride win_plane) with its (ly+2K, nx)
// encoded mask, out (ly, nx) with plane stride out_plane.  `partials`
// receives K x tiles floats, tiles = ceil(ly/16) * ceil(nx/32).  Launches
// on `stream`; returns the launch's cudaError_t (0 = launched).
extern "C" int lbm_local_ca(const float* win, long long win_plane, float* out,
                            long long out_plane, const uint8_t* mask,
                            float* partials, int ly, int nx, int k,
                            float w0_omega, float w1_omega, float w2_omega,
                            float one_minus_omega, float accel_w1,
                            float accel_w2, void* stream) {
  const lbm::StepConsts c{w0_omega,        w1_omega, w2_omega,
                          one_minus_omega, accel_w1, accel_w2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lbm::status(with_k(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    return launch<K, true>(win, win_plane, ly + 2 * K, out, out_plane, mask, partials,
                           nullptr, 1, 0, ly, nx, c, st);
  }));
}
