// A whole chunk of D2Q9-BGK timesteps in one launch, for NVIDIA Hopper
// (sm_90a), in two forms: a banded kernel of D steps per round for grids
// whose bands are all co-resident in shared memory (the small decks), and
// a cooperative kernel of K steps per round for every other grid.
//
// Replaces: advanced_hpc_lbm_tpu/ops/resident.py `_chunk_kernel` (the
// whole-run Pallas kernel behind the `resident` backend).  On the TPU one
// core runs the whole chunk with the state in VMEM, and its grid of one
// program needs no barrier between steps.  Here many SMs share a chunk, and
// each form meets only its neighbours between steps, through values or
// flags that carry their step, never through a grid barrier.  Both run
// every cell through step_common.cuh:cell_step in the same operand order,
// so the state equals the step kernel's bit for bit, and both write the
// step kernel's per-tile ||u|| partials into partials[t, tile] (row-major
// 32x8 tiles), so that the caller's torch.sum(dim=1) gives the step
// backend's av history bit for bit.  Which form runs is a rule on the
// shape, decided by the wrapper before the launch (ops/resident.py:
// form_of, with lbm_resident_banded_fits' rule).
//
// The banded form (resident_banded_kernel<D, SW>), for the small decks:
// * Band b is the step kernel's tile row b: grid rows 8b .. 8b+7, the last
//   band ragged when ny % 8 != 0.  A band is cut into segments of whole
//   tiles (SW = 32 or 64 columns; the last segment ragged), as many as
//   give each SM one block where the grid leaves SMs to spare.  One block
//   of 512 threads per (band, segment).  The grid is a cooperative launch
//   of exactly bands x segments blocks, which guarantees that every block
//   is resident, as the spin-waits below need.  There is no grid-wide
//   barrier.
// * Rounds of D steps (temporal blocking).  A block keeps its cells in
//   shared memory for the whole chunk, with a ring of ghost cells D deep
//   (D rows above and below, D columns either side, the corners): two
//   ping-pong copies of their 9 planes, and the mask of the same cells.
//   The cells are read from `a` once at chunk start and written back once
//   at chunk end, to `a` for an even n_steps, else to `b`, as the other
//   forms leave them.  D is a rule on the shape: band_depth of the
//   segment width that banded_geometry picks, 4 for blocks of 32 columns,
//   2 for blocks of 64; those two kernels are built.  Round r, from state
//   t = rD:
//     1. take round r-2's tile sums (below); gather the ring of state t
//        from the outbox slot r % 2: every thread's values (up to
//        band_gather, 12 at D = 4 and 64 columns) loaded at once, each
//        value marked t+1 put into the copy, the others loaded again, all
//        at once, until every one is; a block barrier;
//     2. D steps that need nothing from outside the block: step s computes
//        the rectangle D-1-s cells beyond the own cells (the trapezoid;
//        the ring's cells are stepped and discarded, their ||u|| never
//        summed), from one copy into the other, each thread's cells (up to
//        two) computed into registers first; a block barrier between two
//        steps;
//     3. the last step sends the own cells within D of the block's edge,
//        state t+D, to slot (r+1) % 2, marked t+D+1, straight from the
//        registers; the next round's gather follows with no barrier (it
//        writes the ring of the copy the last step wrote only the own
//        cells of, and the last step read the other copy).
//   The last round of a launch runs n mod D steps (the trapezoid's last
//   ones) and sends nothing.  At chunk start each block reads only its own
//   cells of `a` and sends state 0 into slot 0, marked 1; the wrapper
//   resets the outbox to 0 (no step) before every launch, on the launch's
//   stream.  Within a round there is no L2 round trip, no second pass
//   over the edge cells and no second barrier a step.
// * The outbox: 64-bit words, the float's bits and above them the step
//   they belong to plus one, stored and loaded as one volatile access so
//   that a value and its step arrive together; nothing else is a flag.
//   Two slots, by round parity: the edge rows [bands][2D][9][nx] (each
//   band's first D rows, then its last D) and the edge columns
//   [bands][segments][2D][9][8] (each block's first D columns, then its
//   last D).  A row l of a band h rows long is stored as edge row l if l <
//   D and as edge row 2D - h + l if l >= h - D (both where h < 2D); a
//   reader takes row l from the first D if l < D, else from the last D
//   (edge_index): a ring row D or fewer rows beyond a band lies within D of
//   its owner band's edge on the reader's side, so the writer stored it
//   there.  The same holds for columns.  So the ring comes from the right
//   cells wherever it reaches: each ring cell is read from the band and
//   segment that own it, by its wrapped grid row and column, even where a
//   ragged band or segment is narrower than D (the ring then spans two
//   bands or segments), where a grid has one band or one segment (a block
//   is its own neighbour, and reads back what it sent), and across the
//   periodic wrap.  D is not bounded by the shortest band.
// * Write after read: a block overwrites the words of slot (r+1) % 2 in
//   round r's last step.  They held state t-D, which its neighbours read
//   in their gathers of round r-1.  Being within D cells is symmetric
//   (Chebyshev distance on the torus): every block that reads this block's
//   cells owns cells of this block's ring, and this block has read, in its
//   gather of round r, values of each of them marked t+1, which that block
//   sent in the last step of its round r-1, after its gather of round r-1.
//   So no block runs more than one round ahead of a neighbour.  Read after
//   write: a value is used only once it is marked with its step.  A poll
//   that exceeds kMaxPolls traps, so that a fault ends the run with an
//   error instead of a hang.  Outbox accesses are volatile 64-bit loads
//   and stores, served by L2, never by L1 (the same slot is re-read every
//   second round and L1 is not coherent across SMs).
// * ||u|| partials: block_sum's tree over a 32x8 tile (strides 128, 64,
//   32, then 16 .. 1) is, per column, ((r0+r4)+(r2+r6)) + ((r1+r5)+(r3+r7))
//   over its 8 rows, then __shfl_down_sync by 16, 8, 4, 2, 1 across the
//   warp.  Each step puts each own cell's ||u|| (0 off the grid) into one
//   of two rounds' buffers in shared memory; in the next round but one a
//   warp per (step, tile) adds the column in that order, and its lane 0
//   holds the tile's partial bit for bit.
// * Which grids: nx <= 320, a block of the widest segment fitting the
//   card's opt-in shared memory at its D (92 336 B at 64 columns and D =
//   2; 83 584 B at 32 and D = 4), and ceil(ny/8) bands co-resident (the
//   kernel's occupancy x SMs, over the segments a band needs at least):
//   the reference's 128^2,
//   128x256 and 256^2 decks and the 64^2 mini deck, not 512^2 or 1024^2.
//   The shared memory no longer bounds nx (the one-step form's rule, the
//   whole band's copies, stopped at 318 columns): 64 rows of 320 columns
//   are taken now, and the widest grid of 256 rows is still 256 columns
//   wide (5 segments a band above that, too many blocks).
// * The depth, and what bounds a step (scripts/torch_resident_variants.py,
//   H100 80GB HBM3, 700 W; us per step at 64^2 / 128^2 / 256x128 / 256^2,
//   ny x nx).  D = 1: 1.77 / 1.78 / 1.76 / 2.05; D = 2: 1.40 / 1.39 / 1.38
//   / 1.74; D = 3: 1.33 / 1.34 / 1.34 / 1.76; D = 4: 1.33 / 1.33 / 1.35 /
//   1.91; D = 5 and 6 were slower everywhere (1.44-1.48 and 1.57-1.58 on
//   the three grids of 32-column blocks, 2.87 and 3.49 at 256^2; 128
//   registers with spills).  The one-step form ran 2.81 / 2.76 / 2.94 /
//   3.06 in the same call.  So D = 4 for blocks of 32 columns, and D = 2
//   for blocks of 64, whose 512 threads pass twice over the ring's
//   rectangle at every step but the last (band_depth; the script's
//   depth_<d> variants build every block at another D).  At the rule's D the
//   wait for the neighbours costs nothing measurable (without it, 1.45 /
//   1.42 / 1.40 / 1.90); with the cell step replaced by a copy a step
//   takes 0.70 / 0.70 / 0.79 / 1.15: about 0.6 us of a step is the cell
//   steps, the rest the round's skeleton (a barrier a step, the gather,
//   the sends and the tile sums, a quarter or a half of each a step).
//   Polling the missing values one at a time, as the one-step form did,
//   cost 0.6-2 us a step more; segments of 64 columns at 128 columns wide
//   (64 blocks) 0.4 us more; the ring's loads before the tile sums, or
//   relaxed atomics in place of volatile accesses, as fast.
// * History: with one thread per column stepping all 8 rows of a band,
//   the state in device memory and one int flag per band (stored after a
//   fence, polled by one thread while the block waited), it ran 14.94 /
//   18.36 / 20.07 us per step at 64^2 / 128^2 / 256^2 against a
//   grid-barrier form's 3.56 / 3.80 / 4.19 (168 registers, 1 KB of
//   spills); with the band in shared memory, 1-4 rows per thread and
//   only the edge rows waiting, 2.59 / 3.12 / 5.51 (one block per band
//   left 100 SMs idle at 256^2); cut into segments with a flag per block,
//   6.75 / 6.77 / 5.50: a corner cell waited on four flags one after
//   another.  The one-step form (a ring one cell deep, exchanged every
//   step: the inner cells stepped while the ghost loads flew, then the
//   edge cells in a second pass, two block barriers a step) ran 2.72 /
//   2.69 / 2.97 us per step at 64^2 / 128^2 / 256^2; without the wait for
//   the neighbours' values 2.60 / 2.53 / 2.96, with the cell step replaced
//   by a copy 1.80 / 2.25 / 2.15 (H100 80GB HBM3, 700 W).

// The cooperative form (resident_kernel<K>), for every grid the banded
// form does not take (512^2 and up, and any grid wider than 320 columns):
// * Tiles and blocks.  A band is the step kernel's tile row (8 rows, the
//   last one ragged), cut into windows of 128 columns (the last one
//   ragged).  A tile is a segment of a band: seg_windows consecutive
//   windows, segs segments a band, the last one ragged.  One cooperative
//   launch per chunk of as many blocks as tiles, no more than can be
//   co-resident (one per SM: two windows fill its shared memory, 512
//   threads its registers); block b owns tiles b, b + gridDim.x, ... in
//   band-major order.  There is no grid barrier.
// * Segments (coop_segments, a rule on the shape and the co-resident
//   blocks).  Where there are at least as many bands as blocks, one a
//   band: a block owns whole bands (4096^2: 512 bands on 132 blocks).
//   Else the count that makes the most windows a block steps per round,
//   ceil(bands * segs / blocks) * ceil(windows / segs), least, the fewest
//   on a tie: 1024^2 keeps one (8 windows a block for 1, 2, 4 or 8),
//   512^2 takes 2 (2 windows a block on 128 blocks, where whole bands gave
//   4 on 64 and left 68 SMs idle), 640x1024 8 (5 windows, not 8),
//   672x1024 3 (6), 8x4096 32 (one window on each of 32 blocks).
// * Rounds.  A chunk runs in rounds of K steps (K = 3 by the shape rule
//   coop_k; a last round of n mod K, and one round split in two where that
//   makes the rounds as many, mod 2, as the steps, so that the state ends
//   in `a` for an even n and in `b` for an odd one).  Round r reads buffer
//   r % 2 and writes the other.  A block walks its tiles' windows: each
//   window is its 8 rows with K ghost rows above and below and 4 ghost
//   columns each side, copied by cp.async into shared memory while the
//   previous window steps, then stepped K times in place
//   (window_common.cuh's Window and forcing rows; each thread's cells staged
//   in registers, two barriers a step: step s computes the rectangle K - s
//   cells beyond the own ones) and its own cells written to the other
//   buffer.  A round of k < K steps runs the trapezoid's last k steps.
// * Meeting the neighbours.  A window's ghost cells (K rows above and
//   below, K columns either side, the corners) are read straight from the
//   round's source buffer.  Each window announces the step of the state it
//   has written there: a 64-bit outbox word, [bands][windows], the step + 1
//   in its high half, stored with ll_store by one thread after the block's
//   barrier and a fence.  Before a window's copies are issued, the block's
//   last warp polls the words of every (band, window) within K cells of it
//   that another block owns (coop_flag: the bands of its first and last
//   ghost rows above and below and its own, by the windows of its first and
//   last ghost columns left and right and its own), then fences; the words
//   are loaded one window ahead, so that the loads fly while a window
//   steps, by the last warp, which has the fewest cells in a round's first
//   steps.  A window this block owns needs no wait: the block wrote its
//   state in the previous round, and writes the next one only to the other
//   buffer.  A poll that exceeds kMaxPolls traps.  The wrapper resets the
//   outbox before every launch; round 0 waits for nothing (state 0 is in
//   place before the launch).
// * Write after read.  The round's source buffer plays the banded form's
//   outbox slot of the round's parity.  A window overwrites its cells of
//   that buffer at round r + 1 only after it has seen the words of round
//   r + 1 of every window within K cells that another block owns (it needs
//   their state t + k); each stores its word after the copies of its own
//   window of round r, which read this window's cells of state t, have
//   landed.  Being within K cells is symmetric, across rows and columns
//   alike: every window that reads this one's cells is one this one waits
//   for, or one this block owns, whose reads of round r ended before the
//   block began round r + 1.  So no window overwrites cells that a
//   neighbour still has to read, and no block runs more than a round
//   ahead of a neighbour.  Cells of windows that other blocks own are read
//   from L2 (cp.async.cg, __ldcg), never from a stale L1 line.
// * ||u|| partials: each own cell's ||u|| (0 on an obstacle and off the
//   grid) goes to shared memory per step, and a warp sums each tile in
//   block_sum's order (as the banded form), to partials[t, tile].
// * Bound: 72/K bytes per cell and step for the state (read and written
//   once per round) and 9 for the ghost rows, 33 at K = 3.  It runs 25.08
//   us per step at 1024^2, 86.99 at 2048^2, 330.85 at 4096^2 (one segment
//   a band), 6.96 at 512^2, 13.44 at 768^2, 13.58 at 640x1024, 17.20 at
//   672x1024, 3.80 at 256x512 and 3.83 at 8x4096 (segmented), K = 3
//   (chip_smoke.py 3r, H100 80GB HBM3, 700 W).  At 1024^2 its cell steps
//   alone take 19.2 us, at the K-step kernel's rate per SM, and overlap its
//   copies (15.0 alone) by ~9 (scripts/torch_resident_variants.py).  K = 1
//   / 2 / 4: 39.08 / 28.27 / 30.46 us at 1024^2.
// * History: with a copy of each band's 2K edge rows in an outbox of
//   step-tagged 64-bit words (value and step in one word, two slots), the
//   outbox doubled the state's traffic (72 bytes per cell and step at K =
//   2) and the form ran 41.96 us per step at 1024^2; gathering ghosts by
//   volatile loads issued after a window's steps cost 15 of 42.8 us
//   (scripts/torch_resident_variants.py); bands of 16 or 32 rows cut the
//   outbox's share but left SMs idle (73.74 us at 1024^2); one state
//   buffer stepped in place was within 3% of the pair.  With whole bands
//   as the unit a block owns, grids of fewer bands than SMs left SMs idle
//   (512^2: 12.67 us on 64 blocks, scripts/torch_resident_turns.py), and
//   a grid-barrier form (a persistent grid over the 32x8 tiles, one grid
//   barrier per step, 73 bytes per cell and step) ran them instead: 7.90
//   us at 512^2, 5.24 at 256x512, 8.21 at 256x1024, 23.37 at 640x1024,
//   24.12 at 656x1024, 3.98 at 8x4096 and 40.65 at 1024^2, slower than the
//   segmented tiles on each (chip_smoke.py 3r, the same call), and was
//   retired.  Warp 0 as the flagging warp cost 1.5-1.8% at 1024^2 to
//   4096^2 (scripts/torch_resident_turns.py).
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC

#include <cstdint>
#include <type_traits>

#include "step_common.cuh"
#include "window_common.cuh"

namespace {

// ---- the banded form ------------------------------------------------------

constexpr int kBandRows = lbm::kTileY;  // a band is one tile row
constexpr int kSpeeds = 9;
// The widest grid the banded form takes.
constexpr int kMaxBandCols = 320;
// A block owns a segment of at most 2 tiles (64 columns) of a band and
// steps it, and its ring, with 512 threads of up to 128 registers.
constexpr int kMaxSegTiles = 2;
constexpr int kBandThreads = kMaxSegTiles * lbm::kTileX * kBandRows;
constexpr int kMaxPolls = 1 << 24;  // ~seconds of polling: a fault, not a wait

// An outbox word: a float's bits, and above them the step it belongs to
// plus one (0, the reset value, belongs to no step); the cooperative
// form's flag words carry the step alone.
using Word = unsigned long long;

__host__ __device__ constexpr int num_bands(int ny) {
  return (ny + kBandRows - 1) / kBandRows;
}

__host__ __device__ constexpr int num_tiles_x(int nx) {
  return (nx + lbm::kTileX - 1) / lbm::kTileX;
}

// Segments a band needs at least: blocks of at most kMaxSegTiles tiles.
constexpr int min_segments(int nx) {
  return (num_tiles_x(nx) + kMaxSegTiles - 1) / kMaxSegTiles;
}

// The widest segment of a band nx wide: a block's columns at most.
constexpr int widest_segment(int nx) {
  return (num_tiles_x(nx) < kMaxSegTiles ? num_tiles_x(nx) : kMaxSegTiles) * lbm::kTileX;
}

// Ring cells of a block seg_w columns wide at depth d, at most: d rows
// above and below (the corners included), d columns either side.
__host__ __device__ constexpr int band_ring(int d, int seg_w) {
  return 2 * d * (seg_w + 2 * d) + 2 * kBandRows * d;
}

// Ring values a thread gathers per round, at most.
__host__ __device__ constexpr int band_gather(int d, int seg_w) {
  return (kSpeeds * band_ring(d, seg_w) + kBandThreads - 1) / kBandThreads;
}

// Dynamic shared memory of a block seg_w columns wide at depth d: the
// ||u|| of two rounds' steps of its own cells, the table of its threads'
// ring values (source and destination), two copies of its cells' 9
// planes with the ring, and the mask of the same cells.
__host__ __device__ constexpr size_t band_smem(int d, int seg_w) {
  const size_t cells = static_cast<size_t>(kBandRows + 2 * d) * (seg_w + 2 * d);
  return sizeof(float) * (2 * static_cast<size_t>(d) * kBandRows * seg_w + 2 * kSpeeds * cells) +
         sizeof(int) * 2 * static_cast<size_t>(band_gather(d, seg_w)) * kBandThreads + cells;
}

// Words of one outbox slot at depth d: the edge rows of every band,
// [bands][2d][9][nx] (its first d rows, then its last d), then the edge
// columns of every block, [bands][segs][2d][9][kBandRows] (its first d
// columns, then its last d).
__host__ __device__ constexpr long long slot_words(int bands, int segs, int nx, int d) {
  return 2LL * d * kSpeeds * bands * (nx + static_cast<long long>(segs) * kBandRows);
}

// Where a reader finds row (or column) l of a band (or segment) n long in
// its 2d edge rows (columns): among the first d if l < d, else among the
// last d.  A ring cell d or fewer cells beyond a band lies within d of
// that band's edge on the reader's side, so the writer stored it there
// (it stores row l as edge row l if l < d, and as edge row d + l - (n -
// d) if l >= n - d; both where n < 2d).
__host__ __device__ constexpr int edge_index(int l, int n, int d) {
  return l < d ? l : 2 * d - n + l;
}

// The exchange depth D of a block seg_w columns wide (ops/resident.py:
// band_depth is the same rule): 4 for blocks of 32 columns, 2 for blocks
// of 64, of D = 1 .. 6 timed at 64^2, 128^2, 256x128 and 256^2 the
// fastest, or within 1% of it (see the note above).  The banded kernels
// built are resident_banded_kernel<band_depth(SW), SW> for SW = 32 and 64.
__host__ __device__ constexpr int band_depth(int seg_w) {
  return seg_w == lbm::kTileX ? 4 : 2;
}

// A block of the narrower segment is the smaller: where the widest
// segment's block fits the card, so does the other (banded_fits).
static_assert(band_smem(band_depth(lbm::kTileX), lbm::kTileX) <=
                  band_smem(band_depth(kMaxSegTiles * lbm::kTileX), kMaxSegTiles * lbm::kTileX),
              "the widest block is the largest");

// The blocks of a launch on a card with `sms` SMs: the band's width cut
// into `segs` segments of seg_w columns (whole tiles, the last one
// ragged), as many as give each SM one block, and at least min_segments;
// and their exchange depth D, band_depth(seg_w) (ops/resident.py:
// banded_geometry is the same rule).
void banded_geometry(int ny, int nx, int sms, int* seg_w, int* segs, int* depth) {
  const int tiles = num_tiles_x(nx);
  int target = sms / num_bands(ny);
  target = target < tiles ? target : tiles;
  target = target > min_segments(nx) ? target : min_segments(nx);
  const int seg_tiles = (tiles + target - 1) / target;
  *seg_w = seg_tiles * lbm::kTileX;
  *segs = (tiles + seg_tiles - 1) / seg_tiles;
  *depth = band_depth(*seg_w);
}

// A volatile 64-bit access is one access (relaxed, at system scope): a
// value and its step arrive together.  It is served by L2, never by L1.
__device__ __forceinline__ Word ll_load(Word* p) {
  return *reinterpret_cast<volatile Word*>(p);
}

__device__ __forceinline__ void ll_store(Word* p, float v, unsigned tag) {
  *reinterpret_cast<volatile Word*>(p) = (static_cast<Word>(tag) << 32) | __float_as_uint(v);
}

// The shape of a block's copies at depth D, SW columns wide: local row lr
// (-D .. 8+D-1) and column lc (-D .. SW+D-1) at copy row lr + D, column
// lc + D.
template <int D, int SW>
struct Band {
  static constexpr int kRows = kBandRows + 2 * D;
  static constexpr int kPitch = SW + 2 * D;
  static constexpr int kPlane = kRows * kPitch;
  static constexpr int kGather = band_gather(D, SW);
  static constexpr int kRed = D * kBandRows * SW;  // ||u|| of one round's steps
  static constexpr size_t kSmem = band_smem(D, SW);
};

// The accessor of one block's step: every value in a copy, by copy row
// and column.
template <int D, int SW>
struct BandCells {
  const float* cur;     // [9][kRows][kPitch]: the step's state
  const uint8_t* mask;  // [kRows][kPitch]
  unsigned accel_rows;  // bit r: copy row r is an image of row ny-2
  __device__ __forceinline__ float f(int k, int r, int c) const {
    return cur[(k * Band<D, SW>::kRows + r) * Band<D, SW>::kPitch + c];
  }
  __device__ __forceinline__ bool obst(int r, int c) const {
    return mask[r * Band<D, SW>::kPitch + c] != 0;
  }
  __device__ __forceinline__ bool accel(int r, int) const { return (accel_rows >> r) & 1u; }
};

// Where this thread's own cell goes in a slot, -1 where it does not: as
// one of its band's first or last D rows, one of its block's first or
// last D columns.
struct EdgeSlots {
  int row[2], col[2];
};

// One step of a round, E cells beyond the block's own ones: the rectangle
// of local rows -E .. 8+E-1 and columns -E .. SW+E-1 from `st` into
// `next`, each thread's cells (tid, tid + 512, ...) computed into
// registers first.  Cells beyond the ragged band's h rows or segment's w
// columns are stepped too, and not kept.  The ||u|| of the own 8 x SW
// cells (0 off the grid and on obstacles) go to red; at E = 0, where the
// thread's cell is its own one, its values of the new state go to `out`
// (unless null), marked `tag`.
template <int D, int SW, int E>
__device__ __forceinline__ void band_step(const BandCells<D, SW>& st, float* next, float* red,
                                          int h, int w, const lbm::StepConsts& c,
                                          const EdgeSlots& edge, Word* out, int nx,
                                          unsigned tag) {
  using B = Band<D, SW>;
  constexpr int kCols = SW + 2 * E;
  constexpr int kCells = (kBandRows + 2 * E) * kCols;
  constexpr int kPasses = (kCells + kBandThreads - 1) / kBandThreads;
  const int tid = threadIdx.x;
  float v[kPasses][kSpeeds], norm[kPasses];
  int off[kPasses], own[kPasses];
#pragma unroll
  for (int j = 0; j < kPasses; ++j) {
    const int i = tid + j * kBandThreads;
    if ((j + 1) * kBandThreads <= kCells || i < kCells) {
      const int lr = i / kCols - E, lc = i % kCols - E;
      const int r = lr + D, cc = lc + D;
      // cells beyond h + E rows or w + E columns are not kept: the ring
      // below or right of a ragged block lies there
      off[j] = lr < h + E && lc < w + E ? r * B::kPitch + cc : -1;
      const bool obst = st.obst(r, cc);
      const float u_sq = lbm::cell_step(st, r, cc, r - 1, r + 1, cc - 1, cc + 1, v[j], obst, c);
      own[j] = static_cast<unsigned>(lr) < kBandRows && static_cast<unsigned>(lc) < SW
                   ? lr * SW + lc : -1;
      norm[j] = lr < h && lc < w && !obst ? sqrtf(u_sq) : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < kPasses; ++j) {
    if ((j + 1) * kBandThreads <= kCells || tid + j * kBandThreads < kCells) {
      if (off[j] >= 0) {
#pragma unroll
        for (int k = 0; k < kSpeeds; ++k) next[k * B::kPlane + off[j]] = v[j][k];
      }
      if (own[j] >= 0) red[own[j]] = norm[j];
    }
  }
  if constexpr (E == 0) {
    if (out != nullptr) {
#pragma unroll
      for (int k = 0; k < kSpeeds; ++k) {
        if (edge.row[0] >= 0) ll_store(out + edge.row[0] + k * nx, v[0][k], tag);
        if (edge.row[1] >= 0) ll_store(out + edge.row[1] + k * nx, v[0][k], tag);
        if (edge.col[0] >= 0) ll_store(out + edge.col[0] + k * kBandRows, v[0][k], tag);
        if (edge.col[1] >= 0) ll_store(out + edge.col[1] + k * kBandRows, v[0][k], tag);
      }
    }
  }
}

// The step of a round e cells beyond the own ones (e < D), by its
// compile-time form.
template <int D, int SW, int E = D - 1>
__device__ __forceinline__ void band_step_at(int e, const BandCells<D, SW>& st, float* next,
                                             float* red, int h, int w,
                                             const lbm::StepConsts& c, const EdgeSlots& edge,
                                             Word* out, int nx, unsigned tag) {
  if constexpr (E > 0) {
    if (e < E) {
      band_step_at<D, SW, E - 1>(e, st, next, red, h, w, c, edge, out, nx, tag);
      return;
    }
  }
  band_step<D, SW, E>(st, next, red, h, w, c, edge, out, nx, tag);
}

// One block per (band, segment); blockDim = kBandThreads; rounds of D
// steps.  outbox: two slots of slot_words each (see slot_words).
template <int D, int SW>
__global__ void __launch_bounds__(kBandThreads, 1)
    resident_banded_kernel(float* a, float* b, const uint8_t* mask, float* partials,
                           Word* outbox, int ny, int nx, int n_steps, lbm::StepConsts c) {
  using B = Band<D, SW>;
  const int segs = (nx + SW - 1) / SW;
  const int bands = num_bands(ny);
  const int band = blockIdx.x / segs, s = blockIdx.x % segs;
  if (band >= bands) return;  // only a test's refused grid has more blocks
  const int y0 = band * kBandRows, x0 = s * SW;
  const int h = min(kBandRows, ny - y0), w = min(SW, nx - x0);
  const int tid = threadIdx.x;
  const size_t plane = static_cast<size_t>(ny) * nx;
  const long long slot = slot_words(bands, segs, nx, D);
  const int row_edge = kSpeeds * nx, col_edge = kSpeeds * kBandRows;
  // offsets in a slot: the edge rows of band q, the edge columns of block
  // (q, g)
  const int cols_at = 2 * D * bands * row_edge;
  auto rows_of = [=](int q) { return q * 2 * D * row_edge; };
  auto cols_of = [=](int q, int g) { return cols_at + (q * segs + g) * 2 * D * col_edge; };

  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);                   // [2][D][8][SW]
  int* src_tab = reinterpret_cast<int*>(red + 2 * B::kRed);       // [kGather][512]
  int* dst_tab = src_tab + B::kGather * kBandThreads;             // [kGather][512]
  float* copy0 = reinterpret_cast<float*>(dst_tab + B::kGather * kBandThreads);
  float* copy1 = copy0 + kSpeeds * B::kPlane;                     // [9][kRows][kPitch] each
  uint8_t* mcells = reinterpret_cast<uint8_t*>(copy1 + kSpeeds * B::kPlane);

  // the mask of the block's cells and its ring (0 beyond them), and the
  // copy rows that are images of row ny-2
  unsigned accel_rows = 0;
  for (int lr = -D; lr < h + D; ++lr) {
    if (lbm::wrap(y0 + lr, ny) == ny - 2) accel_rows |= 1u << (lr + D);
  }
  for (int m = tid; m < B::kPlane; m += kBandThreads) {
    const int lr = m / B::kPitch - D, lc = m % B::kPitch - D;
    mcells[m] = lr < h + D && lc < w + D
                    ? mask[static_cast<size_t>(lbm::wrap(y0 + lr, ny)) * nx +
                           lbm::wrap(x0 + lc, nx)]
                    : 0;
  }
  // The ring values this thread gathers each round, m = tid + q * 512 for
  // q < kGather: value m = k * ring + p of the block's ring cells p (the
  // D rows above at columns -D .. w+D-1, the D rows below likewise, the D
  // columns left of rows 0 .. h-1, the D columns right likewise); where it
  // lies in a slot (-1: none), and where in a copy.
  {
    const int rw = w + 2 * D;
    const int ring = 2 * D * rw + 2 * h * D;
    for (int q = 0; q < B::kGather; ++q) {
      const int m = tid + q * kBandThreads;
      int src = -1, dst = 0;
      if (m < kSpeeds * ring) {
        const int k = m / ring, p = m % ring;
        int lr, lc;
        if (p < 2 * D * rw) {  // a row above or below: an edge row of its band
          const bool below = p >= D * rw;
          const int pr = below ? p - D * rw : p;
          lr = below ? h + pr / rw : pr / rw - D;
          lc = pr % rw - D;
          const int gy = lbm::wrap(y0 + lr, ny), q2 = gy / kBandRows;
          const int hq = min(kBandRows, ny - q2 * kBandRows);
          src = rows_of(q2) + edge_index(gy - q2 * kBandRows, hq, D) * row_edge + k * nx +
                lbm::wrap(x0 + lc, nx);
        } else {  // a column left or right: an edge column of its block
          const int pc = p - 2 * D * rw;
          const bool right = pc >= h * D;
          const int pq = right ? pc - h * D : pc;
          lr = pq / D;
          lc = right ? w + pq % D : pq % D - D;
          const int gx = lbm::wrap(x0 + lc, nx), g2 = gx / SW;
          const int wg = min(SW, nx - g2 * SW);
          src = cols_of(band, g2) + edge_index(gx - g2 * SW, wg, D) * col_edge +
                k * kBandRows + lr;
        }
        dst = (k * B::kRows + lr + D) * B::kPitch + lc + D;
      }
      src_tab[q * kBandThreads + tid] = src;
      dst_tab[q * kBandThreads + tid] = dst;
    }
  }
  // This thread's own cell (the one it steps at E = 0) and where it goes
  // in a slot.
  const int olr = tid / SW, olc = tid % SW;
  const bool own = olr < h && olc < w;  // false past the block's 8 x SW threads
  EdgeSlots edge{{-1, -1}, {-1, -1}};
  if (own) {
    if (olr < D) edge.row[0] = rows_of(band) + olr * row_edge + x0 + olc;
    if (olr >= h - D) edge.row[1] = rows_of(band) + (2 * D - h + olr) * row_edge + x0 + olc;
    if (olc < D) edge.col[0] = cols_of(band, s) + olc * col_edge + olr;
    if (olc >= w - D) edge.col[1] = cols_of(band, s) + (2 * D - w + olc) * col_edge + olr;
  }

  // state 0: the own cells into copy 0, their edge values into slot 0
  if (own) {
#pragma unroll
    for (int k = 0; k < kSpeeds; ++k) {
      const float v = a[k * plane + static_cast<size_t>(y0 + olr) * nx + x0 + olc];
      copy0[(k * B::kRows + olr + D) * B::kPitch + olc + D] = v;
      if (edge.row[0] >= 0) ll_store(outbox + edge.row[0] + k * nx, v, 1);
      if (edge.row[1] >= 0) ll_store(outbox + edge.row[1] + k * nx, v, 1);
      if (edge.col[0] >= 0) ll_store(outbox + edge.col[0] + k * kBandRows, v, 1);
      if (edge.col[1] >= 0) ll_store(outbox + edge.col[1] + k * kBandRows, v, 1);
    }
  }
  __syncthreads();

  // round rr's ||u|| partials of each of the block's tiles and steps, one
  // (step, tile) a warp, from red (block_sum's order over the tile, see
  // the note above)
  const int tiles_x = num_tiles_x(nx);
  auto tile_partials = [&](int rr) {
    const int t0 = rr * D, k = min(D, n_steps - t0);
    const float* rd = red + (rr % 2) * B::kRed;
    const int warp = tid >> 5, lane = tid & 31;
    for (int item = warp; item < k * (SW / lbm::kTileX); item += kBandThreads / 32) {
      const int j = item / (SW / lbm::kTileX), tt = item % (SW / lbm::kTileX);
      const float* r = rd + j * kBandRows * SW + tt * lbm::kTileX + lane;
      const float column = ((r[0] + r[4 * SW]) + (r[2 * SW] + r[6 * SW])) +
                           ((r[SW] + r[5 * SW]) + (r[3 * SW] + r[7 * SW]));
      const float total = lbm::warp_sum(column);
      const int tx = x0 / lbm::kTileX + tt;
      if (lane == 0 && tx < tiles_x) {
        partials[(static_cast<size_t>(t0 + j) * bands + band) * tiles_x + tx] = total;
      }
    }
  };
  float* cur = copy0;
  float* nxt = copy1;
  const int rounds = (n_steps + D - 1) / D;
  for (int r = 0; r < rounds; ++r) {
    const int t = r * D, k = min(D, n_steps - t);
    Word* in = outbox + (r % 2) * slot;
    Word* out = r + 1 < rounds ? outbox + ((r + 1) % 2) * slot : nullptr;
    // Round r-2's tile sums, then the ring of state t: every load in flight
    // at once, each value marked t+1 into the copy that holds state t, and
    // the others loaded again, all at once, until every one is.
    if (r >= 2) tile_partials(r - 2);
    Word got[B::kGather];
    unsigned pending = 0;  // bit q: value q is still to come
#pragma unroll
    for (int q = 0; q < B::kGather; ++q) {
      const int src = src_tab[q * kBandThreads + tid];
      if (src >= 0) {
        got[q] = ll_load(in + src);
        pending |= 1u << q;
      }
    }
    for (int polls = 0;; ++polls) {
#pragma unroll
      for (int q = 0; q < B::kGather; ++q) {
        if (((pending >> q) & 1u) &&
            static_cast<unsigned>(got[q] >> 32) == static_cast<unsigned>(t + 1)) {
          cur[dst_tab[q * kBandThreads + tid]] = __uint_as_float(static_cast<unsigned>(got[q]));
          pending &= ~(1u << q);
        }
      }
      if (pending == 0) break;
      if (polls >= kMaxPolls) __trap();
#pragma unroll
      for (int q = 0; q < B::kGather; ++q) {
        if ((pending >> q) & 1u) got[q] = ll_load(in + src_tab[q * kBandThreads + tid]);
      }
    }
    __syncthreads();  // the ring is in
    // k steps, the last k of the D-step trapezoid: e = k-1 .. 0 cells
    // beyond the own ones; the last one sends the own edge cells
    float* rd = red + (r % 2) * B::kRed;
    for (int e = k - 1; e >= 0; --e) {
      band_step_at<D, SW>(e, BandCells<D, SW>{cur, mcells, accel_rows}, nxt,
                          rd + (k - 1 - e) * kBandRows * SW, h, w, c, edge, out, nx, t + k + 1);
      if (e > 0) __syncthreads();  // the step's values are in, its reads done
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  __syncthreads();  // the last round's ||u|| are in
  if (rounds >= 2) tile_partials(rounds - 2);
  if (rounds >= 1) tile_partials(rounds - 1);

  // state n_steps back to its buffer: `a` for an even n_steps, else `b`
  if (own) {
    float* dst = (n_steps % 2 == 0) ? a : b;
#pragma unroll
    for (int k = 0; k < kSpeeds; ++k) {
      dst[k * plane + static_cast<size_t>(y0 + olr) * nx + x0 + olc] =
          cur[(k * B::kRows + olr + D) * B::kPitch + olc + D];
    }
  }
}
// ---- the cooperative form ---------------------------------------------------

// A block of the cooperative form: 16 warps, one block per SM (its two
// windows take most of the SM's shared memory, its threads all of its
// registers at 128 each).
constexpr int kCoopThreads = 512;
constexpr int kCoopWarps = kCoopThreads / 32;

// The geometry of the cooperative form for K steps per round.  A window is
// a band's 8 rows by kW = 4 tiles of own columns with K ghost rows above
// and below and kA = K rounded up to 4 ghost columns left and right
// (16-byte rows of device memory); it steps K times in place while the
// next window arrives in a second buffer.
template <int K>
struct Coop {
  static constexpr int kW = 4 * lbm::kTileX;  // own columns
  static constexpr int kTiles = kW / lbm::kTileX;
  static constexpr int kA = (K + 3) / 4 * 4;  // ghost columns loaded per side
  static constexpr int kH = kBandRows + 2 * K;  // window rows
  static constexpr int kP = kW + 2 * kA;        // window columns = row pitch
  static constexpr int kGroups = kP / 4;        // 16-byte groups per window row
  using Geo = lbm::WinGeo<kH, kP>;
  // ||u|| of the own cells, per step of a round: [K][8][kW]
  static constexpr int kRedFloats = K * kBandRows * kW;
  static constexpr size_t kSmemBytes =
      2 * static_cast<size_t>(Geo::kBytes) + sizeof(float) * kRedFloats;
};

// Windows of a band nx wide, and the outbox's words: one per band and
// window.
__host__ __device__ constexpr int coop_windows(int nx) {
  return (nx + 4 * lbm::kTileX - 1) / (4 * lbm::kTileX);
}

__host__ __device__ constexpr long long coop_flag_words(int ny, int nx) {
  return static_cast<long long>(num_bands(ny)) * coop_windows(nx);
}

// The steps of round r of a chunk of n steps at K steps per round: rounds
// of K and a last one of n mod K, with one round split in two where that
// makes the number of rounds as even as n, so that the state ends in the
// buffer the caller expects (ops/resident.py: coop_rounds).
__host__ __device__ inline int coop_round_steps(int r, int n, int k) {
  const int rounds = (n + k - 1) / k, tail = n - k * (rounds - 1);
  if (rounds % 2 == n % 2) return r < rounds - 1 ? k : tail;
  if (tail >= 2) return r < rounds - 1 ? k : (r == rounds - 1 ? tail - 1 : 1);
  return r < rounds - 2 ? k : (r == rounds - 2 ? k - 1 : 1);
}

// v mod n for v within one n of [0, n), else by the general wrap (grids
// smaller than a window).
__device__ __forceinline__ int wrap_near(int v, int n) {
  if (v < 0) {
    v += n;
  } else if (v >= n) {
    v -= n;
  }
  return static_cast<unsigned>(v) < static_cast<unsigned>(n) ? v : lbm::wrap(v, n);
}

// The kernel's arguments, a __grid_constant__ parameter (the out-of-line
// functions below read them by reference).  `vec`: 16-byte window rows (nx
// % 4 == 0, nx >= the window's pitch, ny >= K, aligned buffers).  A tile
// is a segment of a band: seg_windows consecutive windows (the last
// segment ragged), segs of them per band (coop_segments).
struct CoopArgs {
  float* a;
  float* b;
  const uint8_t* mask;
  float* partials;
  Word* flags;  // coop_flag_words: [bands][windows]
  int ny, nx, n_steps, vec;
  int segs, seg_windows;
  lbm::StepConsts c;
};

// Whether this block owns window cw of band p: its tile p * segs + cw /
// seg_windows is blockIdx.x, blockIdx.x + gridDim.x, ...
__device__ __forceinline__ bool coop_owns(const CoopArgs& a, int p, int cw) {
  const int tile = a.segs == 1 ? p : p * a.segs + cw / a.seg_windows;
  return static_cast<unsigned>(tile) % gridDim.x == blockIdx.x;
}

// A window of a block's round: band q (rows y0 .. y0+h-1), window c (own
// columns x0 .. x0+w-1) of tile `tile`, whose windows end before c_end.
// The block's tiles are blockIdx.x, blockIdx.x + gridDim.x, ..., in
// band-major order (tile = q * segs + segment); each is walked window by
// window along x.
struct CoopWin {
  int tile, q, y0, h, c, c_end, x0, w;
  __device__ __forceinline__ void first(int t, int kw, const CoopArgs& a) {
    tile = t;
    q = t / a.segs;
    y0 = q * kBandRows;
    h = min(kBandRows, a.ny - y0);
    c = (t - q * a.segs) * a.seg_windows;
    c_end = min(c + a.seg_windows, coop_windows(a.nx));
    x0 = c * kw;
    w = min(kw, a.nx - x0);
  }
  // The window after this one; false at the end of the block's round.
  __device__ __forceinline__ bool next(int kw, int tiles, const CoopArgs& a) {
    if (c + 1 < c_end) {
      ++c;
      x0 += kw;
      w = min(kw, a.nx - x0);
    } else if (tile + static_cast<int>(gridDim.x) < tiles) {
      first(tile + gridDim.x, kw, a);
    } else {
      return false;
    }
    return true;
  }
};

// Lanes of the flagging warp that wait for flags, one entry each (coop_flag).
constexpr int kFlagLanes = 25;

// The flag that window wn's ghost cells wait for, entry e < kFlagLanes: the
// (band, window) of grid cell (y0 + dy, x0 + dx), wrapped, for dy in {-K,
// -1, 0, h, h + K - 1} (e / 5) and dx in {-K, -1, 0, w, w + K - 1} (e % 5).
// The K ghost rows above span at most the bands of their first and last
// row (only the last band is shorter than 8 rows, and K <= 4), the K ghost
// columns left at most the windows of their first and last column (only
// the last window is narrower than 128), and likewise below and right: so
// the 25 entries name every (band, window) that the window's cells and
// ghost cells touch, its corners included.  -1 where this block owns that
// window: it wrote the window's state in the previous round, and writes
// the next one only to the other buffer.
template <int K>
__device__ __forceinline__ long long coop_flag(const CoopArgs& a, const CoopWin& wn, int e) {
  const int i = e / 5, j = e - 5 * i;
  const int dy = i == 0 ? -K : i == 1 ? -1 : i == 2 ? 0 : i == 3 ? wn.h : wn.h + K - 1;
  const int dx = j == 0 ? -K : j == 1 ? -1 : j == 2 ? 0 : j == 3 ? wn.w : wn.w + K - 1;
  const int p = wrap_near(wn.y0 + dy, a.ny) / kBandRows;
  const int cw = wrap_near(wn.x0 + dx, a.nx) / Coop<K>::kW;
  if (coop_owns(a, p, cw)) return -1;
  return static_cast<long long>(p) * coop_windows(a.nx) + cw;
}

// Lane e of the flagging warp loads the flag of entry e (see coop_flag)
// into `word` (no wait; all ones where no flag is needed).
template <int K>
__device__ __forceinline__ Word coop_flag_load(const CoopArgs& a, const CoopWin& wn, int lane) {
  if (lane >= kFlagLanes) return ~0ULL;
  const long long f = coop_flag<K>(a, wn, lane);
  return f < 0 ? ~0ULL : ll_load(a.flags + f);
}

// The flagging warp waits until every flag window wn's ghost cells need is
// at `want` or later (state t, t + 1 the step it carries) and then fences,
// so that the block's copies after the next barrier read what the flags'
// writers stored before them.
template <int K>
__device__ __forceinline__ void coop_flag_wait(const CoopArgs& a, const CoopWin& wn, Word word,
                                               unsigned want, int lane) {
  for (int polls = 0; static_cast<unsigned>(word >> 32) < want; ++polls) {
    if (polls >= kMaxPolls) __trap();
    word = ll_load(a.flags + coop_flag<K>(a, wn, lane));
  }
  __syncwarp();
  __threadfence();
}

// Issue the copies of window `wn` from `src` into `buf` (no wait): the
// state and the mask of its own rows and of its K ghost rows above and
// below.  Window cell (r, c) is grid cell (y0 - K + r, x0 - kA + c),
// wrapped.  Cells of windows that other blocks own are read from device
// memory, never from this SM's L1 (cp.async.cg, or __ldcg on the 4-byte
// path): other SMs wrote them.
template <int K>
__device__ __noinline__ void coop_load(uint8_t* buf, const CoopArgs& a, const float* src,
                                       const CoopWin& wn, int tid) {
  using C = Coop<K>;
  using G = typename C::Geo;
  float* const wf = reinterpret_cast<float*>(buf);
  uint8_t* const wm = buf + 4 * G::kFloats;
  const size_t plane = static_cast<size_t>(a.ny) * a.nx;
  const int rows = wn.h + 2 * K;  // the own rows and their ghost rows
  if (a.vec) {
    for (int m = tid; m < rows * C::kGroups; m += kCoopThreads) {
      const int r = m / C::kGroups, g = m - r * C::kGroups;
      int gx = wn.x0 - C::kA + 4 * g;  // a group wraps as a whole (nx % 4 == 0)
      gx = gx < 0 ? gx + a.nx : (gx >= a.nx ? gx - a.nx : gx);
      int gy = wn.y0 - K + r;
      gy = gy < 0 ? gy + a.ny : (gy >= a.ny ? gy - a.ny : gy);
      const size_t gi = static_cast<size_t>(gy) * a.nx + gx;
      const int j = r * C::kP + 4 * g;
      lbm::cp_async4(wm + j, a.mask + gi);
#pragma unroll
      for (int s = 0; s < kSpeeds; ++s) lbm::cp_async16(wf + s * G::kPlane + j, src + s * plane + gi);
    }
  } else {
    for (int m = tid; m < rows * C::kP; m += kCoopThreads) {
      const int r = m / C::kP, c = m - r * C::kP;
      const int gy = wrap_near(wn.y0 - K + r, a.ny), gx = wrap_near(wn.x0 - C::kA + c, a.nx);
      const size_t gi = static_cast<size_t>(gy) * a.nx + gx;
      wm[m] = a.mask[gi];  // read only after the wait and barrier, like the copies
      if (coop_owns(a, gy / kBandRows, gx / C::kW)) {
#pragma unroll
        for (int s = 0; s < kSpeeds; ++s) lbm::cp_async4(wf + s * G::kPlane + m, src + s * plane + gi);
      } else {
#pragma unroll
        for (int s = 0; s < kSpeeds; ++s) wf[s * G::kPlane + m] = __ldcg(src + s * plane + gi);
      }
    }
  }
}

// Step S of a round, in place in the window: the rectangle rows [S, kH -
// S) x columns [kA - K + S, kA + kW + K - S).  A thread's cells (tid, tid +
// kCoopThreads, ...) are all computed into registers (their loads and
// arithmetic interleave), a barrier ends the step's reads, they are
// written back, and each own cell's ||u|| (0 on an obstacle and off the
// grid) goes to red[(r - K) * kW + c - kA]; a second barrier publishes the
// step.
template <int K, int S, class Win>
__device__ __forceinline__ void coop_step(const Win& win, float* planes,
                                          const lbm::StepConsts& cc, float* red, unsigned own_h,
                                          unsigned own_w) {
  using C = Coop<K>;
  constexpr int kRows = C::kH - 2 * S, kCols = C::kW + 2 * (K - S);
  constexpr int kCells = kRows * kCols;
  constexpr int kRounds = (kCells + kCoopThreads - 1) / kCoopThreads;
  float v[kRounds][kSpeeds], norm[kRounds];
  int off[kRounds], own[kRounds];
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int i = threadIdx.x + j * kCoopThreads;
    if ((j + 1) * kCoopThreads <= kCells || i < kCells) {
      int r, c;
      lbm::cell_of<kRows, kCols>(i, r, c);
      r += S;
      c += C::kA - K + S;
      off[j] = r * C::kP + c;
      const bool obst = Win::obst_of(win.mask[off[j]]);
      const float u_sq = lbm::cell_step(win, r, c, r - 1, r + 1, c - 1, c + 1, v[j], obst, cc);
      const unsigned orow = r - K, ocol = c - C::kA;
      own[j] = orow < kBandRows && ocol < C::kW ? static_cast<int>(orow * C::kW + ocol) : -1;
      norm[j] = orow < own_h && ocol < own_w && !obst ? sqrtf(u_sq) : 0.0f;
    }
  }
  __syncthreads();  // every read of the step is done
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    if ((j + 1) * kCoopThreads <= kCells || threadIdx.x + j * kCoopThreads < kCells) {
#pragma unroll
      for (int k = 0; k < kSpeeds; ++k) planes[k * C::Geo::kPlane + off[j]] = v[j][k];
      if (own[j] >= 0) red[own[j]] = norm[j];
    }
  }
  __syncthreads();  // the step's values are published
}

// Steps S..K of a round in the window `planes`; the ||u|| of step S into
// red, of each later step into the next 8 x kW floats.
template <int K, int S, bool kForce>
__device__ __forceinline__ void coop_steps(float* planes, const uint8_t* mask,
                                           const lbm::RowBits<(Coop<K>::kH + 31) / 32>& frow,
                                           const lbm::StepConsts& cc, float* red,
                                           unsigned own_h, unsigned own_w) {
  using C = Coop<K>;
  const lbm::Window<C::kH, C::kP, kForce, false> win{planes, mask, frow};
  coop_step<K, S>(win, planes, cc, red, own_h, own_w);
  if constexpr (S < K) {
    coop_steps<K, S + 1, kForce>(planes, mask, frow, cc, red + kBandRows * C::kW, own_h, own_w);
  }
}

// A round of k <= K steps is the last k steps of the K-step trapezoid:
// steps s0 = K - k + 1 .. K.
template <int K, int S, bool kForce>
__device__ __forceinline__ void coop_steps_from(int s0, float* planes, const uint8_t* mask,
                                                const lbm::RowBits<(Coop<K>::kH + 31) / 32>& frow,
                                                const lbm::StepConsts& cc, float* red,
                                                unsigned own_h, unsigned own_w) {
  if constexpr (S < K) {
    if (s0 > S) {
      coop_steps_from<K, S + 1, kForce>(s0, planes, mask, frow, cc, red, own_h, own_w);
      return;
    }
  }
  coop_steps<K, S, kForce>(planes, mask, frow, cc, red, own_h, own_w);
}

// After a round of k steps from state t: window wn's own cells (in the
// window `planes`) to dst, and the ||u|| partial of each of its tiles and
// steps (block_sum's order, see the banded form's note) to partials[t + s,
// tile].
template <int K>
__device__ __noinline__ void coop_store(const float* planes, const float* red, const CoopArgs& a,
                                        float* dst, const CoopWin& wn, int t, int k, int tid) {
  using C = Coop<K>;
  constexpr int kPl = C::Geo::kPlane;
  const size_t plane = static_cast<size_t>(a.ny) * a.nx;
  for (int m = tid; m < kBandRows * C::kW; m += kCoopThreads) {
    const int oy = m / C::kW, ox = m - oy * C::kW;
    if (oy < wn.h && ox < wn.w) {
      const size_t g = static_cast<size_t>(wn.y0 + oy) * a.nx + wn.x0 + ox;
      const int j = (oy + K) * C::kP + ox + C::kA;
#pragma unroll
      for (int s = 0; s < kSpeeds; ++s) dst[s * plane + g] = planes[s * kPl + j];
    }
  }
  const int warp = tid >> 5, lane = tid & 31;
  const int tiles_x = num_tiles_x(a.nx);
  const size_t tiles = static_cast<size_t>(tiles_x) * num_bands(a.ny);
  for (int pr = warp; pr < k * C::kTiles; pr += kCoopWarps) {
    const int s = pr / C::kTiles, tile = pr - s * C::kTiles;
    const float* const r = red + s * kBandRows * C::kW + tile * lbm::kTileX + lane;
    constexpr int w = C::kW;
    const float column = ((r[0] + r[4 * w]) + (r[2 * w] + r[6 * w])) +
                         ((r[w] + r[5 * w]) + (r[3 * w] + r[7 * w]));
    const float total = lbm::warp_sum(column);
    const int tx = wn.x0 / lbm::kTileX + tile;
    if (lane == 0 && tx < tiles_x) {
      a.partials[static_cast<size_t>(t + s) * tiles + static_cast<size_t>(wn.q) * tiles_x + tx] =
          total;
    }
  }
}

// One cooperative launch per chunk; blockDim = kCoopThreads.  Block b owns
// tiles b, b + gridDim.x, ...; every block is resident (the cooperative
// launch guarantees it), as the polls need.  There is no grid barrier.
template <int K>
__global__ void __launch_bounds__(kCoopThreads, 1)
    resident_kernel(const __grid_constant__ CoopArgs a) {
  using C = Coop<K>;
  using G = typename C::Geo;
  extern __shared__ float4 coop_smem[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(coop_smem);
  float* const red = reinterpret_cast<float*>(smem + 2 * G::kBytes);
  const int tid = threadIdx.x, lane = tid & 31;
  // The last warp waits for the neighbours' flags: it has the fewest cells
  // in a round's first steps (the ragged last pass over a step's cells) and
  // no tile sum to take in coop_store at K < 4.
  const bool flagger = tid >= kCoopThreads - 32;
  const int tiles = num_bands(a.ny) * a.segs;
  if (static_cast<int>(blockIdx.x) >= tiles) return;  // more blocks than tiles

  int t = 0;
  for (int r = 0; t < a.n_steps; ++r) {
    const int k = coop_round_steps(r, a.n_steps, K);
    const float* const src = r % 2 == 0 ? a.a : a.b;
    float* const dst = r % 2 == 0 ? a.b : a.a;
    // state 0 is in place before the launch; state t > 0 of a neighbour's
    // window is in `src` once its flag carries t + 1
    const unsigned want = t + 1;
    const bool wait = t > 0;
    CoopWin wn, wnext;
    wn.first(blockIdx.x, C::kW, a);
    wnext = wn;
    bool more = wnext.next(C::kW, tiles, a);
    if (wait && flagger) {
      coop_flag_wait<K>(a, wn, coop_flag_load<K>(a, wn, lane), want, lane);
      if (more) coop_flag_wait<K>(a, wnext, coop_flag_load<K>(a, wnext, lane), want, lane);
    }
    __syncthreads();
    coop_load<K>(smem, a, src, wn, tid);
    lbm::cp_async_commit();
    lbm::cp_async_wait<0>();
    __syncthreads();
    for (int i = 0;; ++i) {
      uint8_t* const cur = smem + (i % 2) * G::kBytes;
      uint8_t* const nxt = smem + ((i + 1) % 2) * G::kBytes;
      float* const planes = reinterpret_cast<float*>(cur);
      // the next window's copies (its flags are in) while this one steps;
      // the flags of the one after it on their way meanwhile
      if (more) coop_load<K>(nxt, a, src, wnext, tid);
      lbm::cp_async_commit();
      CoopWin wafter = wnext;
      const bool after = more && wafter.next(C::kW, tiles, a);
      const Word flag = wait && after && flagger ? coop_flag_load<K>(a, wafter, lane) : 0;
      {
        const uint8_t* const wm = cur + 4 * G::kFloats;
        const auto frow = lbm::row_bits<C::kH>(lane, [&](int rr) {
          return rr < wn.h + 2 * K && wrap_near(wn.y0 - K + rr, a.ny) == a.ny - 2;
        });
        if (frow.any()) {
          coop_steps_from<K, 1, true>(K - k + 1, planes, wm, frow, a.c, red, wn.h, wn.w);
        } else {
          coop_steps_from<K, 1, false>(K - k + 1, planes, wm, frow, a.c, red, wn.h, wn.w);
        }
      }
      coop_store<K>(planes, red, a, dst, wn, t, k, tid);
      if (wait && after && flagger) coop_flag_wait<K>(a, wafter, flag, want, lane);
      lbm::cp_async_wait<0>();
      __syncthreads();  // this window is stored; the next one's copies have landed
      if (tid == 0) {
        // this window's state t + k is in dst, and its ghost rows of state
        // t are read: its flag says so to the neighbours
        __threadfence();
        ll_store(a.flags + static_cast<long long>(wn.q) * coop_windows(a.nx) + wn.c, 0.0f,
                 t + k + 1);
      }
      if (!more) break;
      wn = wnext;
      wnext = wafter;
      more = after;
    }
    t += k;
  }
}

// ---- host side of the cooperative form ------------------------------------

constexpr int kCoopMaxK = 4;
constexpr int kMaxDevices = 64;
// blocks of the cooperative form that can be co-resident, per device and K
// (occupancy x SMs; 0: not prepared)
int g_coop_blocks[kMaxDevices][kCoopMaxK + 1];

// Calls fn(std::integral_constant<int, K>{}) for K = k, the one list of the
// K the cooperative form is built for (COOP_K in ops/resident.py).
template <class Fn>
cudaError_t with_coop_k(int k, Fn fn) {
  switch (k) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

// Sets the kernel's shared-memory limit on the current device and counts
// the blocks that can be co-resident there, unless done; *blocks gets them.
template <int K>
cudaError_t coop_prepared(int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_coop_blocks[dev][K] == 0) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaFuncSetAttribute(resident_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Coop<K>::kSmemBytes));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel<K>,
                                                        kCoopThreads, Coop<K>::kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;  // a block does not fit on an SM
    g_coop_blocks[dev][K] = per_sm * sms;
  }
  *blocks = g_coop_blocks[dev][K];
  return cudaSuccess;
}

// The K of the cooperative form for an (ny, nx) grid (ops/resident.py:
// coop_k is the same rule): 3, the fastest K on every grid timed.
int coop_k(int ny, int nx) {
  (void)ny;
  (void)nx;
  return 3;
}

// Segments per band of the cooperative form on `blocks` co-resident blocks
// (ops/resident.py: coop_segments is the same rule).  Where there are at
// least as many bands as blocks, one: every block has a band.  Else the
// count that makes the most windows a block steps per round,
// ceil(bands * segs / blocks) * ceil(windows / segs), least; on a tie the
// fewest segments, whose edges make windows wait for column neighbours.
// (A count whose segments would leave the last one empty never wins: the
// fewer segments of the same width tie and take it.)
int coop_segments(int bands, int windows, int blocks) {
  if (bands >= blocks) return 1;
  int best = 1, most = windows;
  for (int segs = 2; segs <= windows; ++segs) {
    const long long m = (static_cast<long long>(bands) * segs + blocks - 1) / blocks *
                        ((windows + segs - 1) / segs);
    if (m < most) {
      best = segs;
      most = static_cast<int>(m);
    }
  }
  return best;
}

// The blocks of a launch: one per tile, no more than can be co-resident.
int coop_grid(int tiles, int max_blocks) { return tiles < max_blocks ? tiles : max_blocks; }

// ---- host side ------------------------------------------------------------

cudaError_t num_sms(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Calls fn(std::integral_constant<int, SW>{}) for a segment of seg_w
// columns (32 or 64): the one list of the banded kernels that are built,
// resident_banded_kernel<band_depth(SW), SW>.
template <class Fn>
cudaError_t with_band(int seg_w, Fn fn) {
  static_assert(kMaxSegTiles == 2, "the kernels built");
  switch (seg_w) {
    case lbm::kTileX: return fn(std::integral_constant<int, lbm::kTileX>{});
    case 2 * lbm::kTileX: return fn(std::integral_constant<int, 2 * lbm::kTileX>{});
    default: return cudaErrorInvalidValue;
  }
}

// blocks of the banded kernel of segment tiles that can be resident on one
// SM, per device (0: not prepared)
int g_band_per_sm[kMaxDevices][kMaxSegTiles + 1];

// Sets the shared-memory limit of the banded kernel SW columns wide (at its
// depth D = band_depth(SW)) on the current device and counts its blocks an
// SM can hold, unless done; *per_sm gets them (0 where a block does not
// fit the card).
template <int SW>
cudaError_t banded_prepared(int* per_sm) {
  constexpr int D = band_depth(SW);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& held = g_band_per_sm[dev][SW / lbm::kTileX];
  if (held == 0) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (Band<D, SW>::kSmem > static_cast<size_t>(optin)) {
      *per_sm = 0;
      return cudaSuccess;
    }
    err = cudaFuncSetAttribute(resident_banded_kernel<D, SW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Band<D, SW>::kSmem));
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, resident_banded_kernel<D, SW>,
                                                        kBandThreads, Band<D, SW>::kSmem);
    if (err != cudaSuccess) return err;
    if (n < 1) {
      *per_sm = 0;
      return cudaSuccess;
    }
    held = n;
  }
  *per_sm = held;
  return cudaSuccess;
}

// The banded form's limits on the current device for a grid nx wide: the
// opt-in shared memory of a block, and the bands that can be co-resident
// (the blocks of the widest segment that can be, occupancy x SMs, over the
// segments a band needs at least; 0 where the kernel cannot take nx at
// all).  A launch with narrower segments has one block an SM at most
// (banded_geometry), and its block is the smaller.
cudaError_t banded_limits(int nx, int* smem_optin, int* max_bands) {
  int dev = 0, coop = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *max_bands = 0;
  if (nx < 1 || nx > kMaxBandCols) return cudaSuccess;
  int per_sm = 0;
  err = with_band(widest_segment(nx),
                  [&](auto sw) { return banded_prepared<decltype(sw)::value>(&per_sm); });
  if (err != cudaSuccess) return err;
  *max_bands = per_sm * sms / min_segments(nx);
  return cudaSuccess;
}

// The dynamic shared memory of the widest block of a band nx wide, at its
// depth.
constexpr size_t widest_band_smem(int nx) {
  return band_smem(band_depth(widest_segment(nx)), widest_segment(nx));
}

// The shape rule (ops/resident.py:banded_fits is the same rule in Python):
// a block of the widest segment fits the card, and every band is
// co-resident.
bool banded_fits(int ny, int nx, int smem_optin, int max_bands) {
  return ny >= 1 && nx >= 1 && nx <= kMaxBandCols &&
         widest_band_smem(nx) <= static_cast<size_t>(smem_optin) &&
         num_bands(ny) <= max_bands;
}

}  // namespace

// Loads both forms' kernels onto the current device without launching
// them, checks that the device takes cooperative launches, and sets their
// shared-memory limits.
extern "C" int lbm_resident_prepare(void) {
  int smem = 0, max_bands = 0;
  cudaError_t err = cudaSuccess;
  for (int nx = lbm::kTileX; nx <= kMaxSegTiles * lbm::kTileX && err == cudaSuccess;
       nx += lbm::kTileX) {
    err = banded_limits(nx, &smem, &max_bands);  // the kernel of this width
  }
  for (int k = 1; k <= kCoopMaxK && err == cudaSuccess; ++k) {
    err = with_coop_k(k, [](auto kk) {
      int blocks = 0;
      return coop_prepared<decltype(kk)::value>(&blocks);
    });
  }
  return lbm::status(err);
}

// The banded form's limits for a grid nx wide (see banded_limits); returns
// a cudaError_t.
extern "C" int lbm_resident_banded_limits(int nx, int* smem_optin, int* max_bands) {
  return lbm::status(banded_limits(nx, smem_optin, max_bands));
}

// 1 if the banded form takes an (ny, nx) grid on the current device, 0 if
// another form runs it; a negative cudaError_t on failure.
extern "C" int lbm_resident_banded_fits(int ny, int nx) {
  int smem = 0, max_bands = 0;
  const int err = lbm::status(banded_limits(nx, &smem, &max_bands));
  if (err != 0) return -err;
  return banded_fits(ny, nx, smem, max_bands) ? 1 : 0;
}

// The exchange depth the banded form runs an (ny, nx) grid at on the
// current device, or a negative cudaError_t.
extern "C" int lbm_resident_banded_depth(int ny, int nx) {
  int sms = 0, seg_w = 0, segs = 0, depth = 0;
  const cudaError_t err = num_sms(&sms);
  if (err != cudaSuccess) return -lbm::status(err);
  if (ny < 1 || nx < 1) return -static_cast<int>(cudaErrorInvalidValue);
  banded_geometry(ny, nx, sms, &seg_w, &segs, &depth);
  return depth;
}

// The dynamic shared memory of the widest block of a band nx wide, at its
// depth, in bytes.
extern "C" long long lbm_resident_banded_smem(int nx) {
  return static_cast<long long>(widest_band_smem(nx));
}

// The scratch of a banded launch on the current device: the outbox, in
// 64-bit words (two slots of edge values).
extern "C" int lbm_resident_banded_scratch(int ny, int nx, long long* n_words) {
  int sms = 0, seg_w = 0, segs = 0, depth = 0;
  const cudaError_t err = num_sms(&sms);
  if (err != cudaSuccess) return lbm::status(err);
  if (ny < 1 || nx < 1 || nx > kMaxBandCols) return static_cast<int>(cudaErrorInvalidValue);
  banded_geometry(ny, nx, sms, &seg_w, &segs, &depth);
  *n_words = 2 * slot_words(num_bands(ny), segs, nx, depth);
  return 0;
}

// The cooperative form's limits for K = k steps per round on the current
// device (preparing the kernel there): the dynamic shared memory of a
// block and the blocks that can be co-resident.
extern "C" int lbm_resident_coop_limits(int k, int* smem_bytes, int* max_blocks) {
  return lbm::status(with_coop_k(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    *smem_bytes = static_cast<int>(Coop<K>::kSmemBytes);
    return coop_prepared<K>(max_blocks);
  }));
}

// The K the cooperative form runs an (ny, nx) grid at.
extern "C" int lbm_resident_coop_k(int ny, int nx) { return coop_k(ny, nx); }

// The co-resident blocks of the cooperative form at K = k on the current
// device, or a negative cudaError_t.
static int coop_max_blocks(int k) {
  int max_blocks = 0;
  const int err = lbm::status(with_coop_k(k, [&](auto kk) {
    return coop_prepared<decltype(kk)::value>(&max_blocks);
  }));
  return err != 0 ? -err : max_blocks;
}

// The segments per band of a cooperative launch of an (ny, nx) grid at K =
// k on the current device; a negative cudaError_t on failure.
extern "C" int lbm_resident_coop_segments(int ny, int nx, int k) {
  const int max_blocks = coop_max_blocks(k);
  if (max_blocks < 0) return max_blocks;
  if (ny < 1 || nx < 1) return -static_cast<int>(cudaErrorInvalidValue);
  return coop_segments(num_bands(ny), coop_windows(nx), max_blocks);
}

// The blocks of a cooperative launch of an (ny, nx) grid at K = k on the
// current device; a negative cudaError_t on failure.
extern "C" int lbm_resident_coop_grid(int ny, int nx, int k) {
  const int segs = lbm_resident_coop_segments(ny, nx, k);
  return segs < 0 ? segs : coop_grid(num_bands(ny) * segs, coop_max_blocks(k));
}

// The scratch of a cooperative launch: its outbox of flags, in 64-bit
// words (one per band and window).
extern "C" int lbm_resident_coop_scratch(int ny, int nx, long long* n_words) {
  if (ny < 1 || nx < 1) return static_cast<int>(cudaErrorInvalidValue);
  *n_words = coop_flag_words(ny, nx);
  return 0;
}

// n_steps steps on the state in `a`: the state ends in `a` for an even
// n_steps, in `b` for an odd one.  partials is (n_steps, tiles) float32,
// tiles = ceil(ny/8) * ceil(nx/32).  `flags` is the scratch that
// lbm_resident_coop_scratch sizes; it is reset on `stream` before the
// launch.  `k` <= 0 takes lbm_resident_coop_k's.  `blocks` is 0 (one block
// per tile, no more than can be co-resident) except in tests: fewer blocks
// own several tiles each, and a grid larger than can be co-resident is
// refused with cudaErrorCooperativeLaunchTooLarge; the tiles are the
// rule's (coop_segments on the co-resident blocks) either way.  Launches
// on `stream`; returns the launch's cudaError_t (0 = launched).
extern "C" int lbm_resident_chunk(float* a, float* b, const uint8_t* mask, float* partials,
                                  void* flags, int ny, int nx, int n_steps, int blocks, int k,
                                  float w0_omega, float w1_omega, float w2_omega,
                                  float one_minus_omega, float accel_w1, float accel_w2,
                                  void* stream) {
  if (ny < 1 || nx < 1 || n_steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 0) k = coop_k(ny, nx);
  const lbm::StepConsts c{w0_omega,        w1_omega, w2_omega,
                          one_minus_omega, accel_w1, accel_w2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lbm::status(with_coop_k(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    int max_blocks = 0;
    cudaError_t err = coop_prepared<K>(&max_blocks);
    if (err != cudaSuccess) return err;
    // the rule's tiles (no segment of its count is left empty)
    const int windows = coop_windows(nx);
    const int segs = coop_segments(num_bands(ny), windows, max_blocks);
    const int seg_windows = (windows + segs - 1) / segs;
    const int grid = blocks > 0 ? blocks : coop_grid(num_bands(ny) * segs, max_blocks);
    err = cudaMemsetAsync(flags, 0, sizeof(Word) * coop_flag_words(ny, nx), st);
    if (err != cudaSuccess) return err;
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const bool vec = nx % 4 == 0 && nx >= Coop<K>::kP && ny >= K && aligned(a) && aligned(b) &&
                     reinterpret_cast<uintptr_t>(mask) % 4 == 0;
    CoopArgs args{a, b, mask, partials, static_cast<Word*>(flags), ny, nx, n_steps,
                  vec ? 1 : 0, segs, seg_windows, c};
    void* kargs[] = {&args};
    return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(resident_kernel<K>), dim3(grid),
                                       dim3(kCoopThreads), kargs, Coop<K>::kSmemBytes, st);
  }));
}

// The banded form of lbm_resident_chunk, for a grid that
// lbm_resident_banded_fits takes; the same state, parity and partials.
// `outbox` is the scratch that lbm_resident_banded_scratch sizes; it is
// reset on `stream` before the launch.  `blocks` is 0 (one block per band
// and segment) except in the test of a refused launch (a grid larger than
// can be co-resident); fewer blocks than that are refused with
// cudaErrorInvalidValue.
extern "C" int lbm_resident_banded_chunk(float* a, float* b, const uint8_t* mask,
                                         float* partials, void* outbox, int ny, int nx,
                                         int n_steps, int blocks, float w0_omega,
                                         float w1_omega, float w2_omega,
                                         float one_minus_omega, float accel_w1,
                                         float accel_w2, void* stream) {
  int sms = 0, seg_w = 0, segs = 0, depth = 0;
  cudaError_t err = num_sms(&sms);
  if (err != cudaSuccess) return lbm::status(err);
  if (nx < 1 || nx > kMaxBandCols || ny < 1 || n_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  banded_geometry(ny, nx, sms, &seg_w, &segs, &depth);
  const int bands = num_bands(ny);
  if (blocks <= 0) blocks = bands * segs;
  if (blocks < bands * segs) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(outbox, 0, sizeof(Word) * 2 * slot_words(bands, segs, nx, depth), st);
  if (err != cudaSuccess) return lbm::status(err);
  Word* box = static_cast<Word*>(outbox);
  lbm::StepConsts c{w0_omega,        w1_omega, w2_omega,
                    one_minus_omega, accel_w1, accel_w2};
  void* args[] = {&a, &b, &mask, &partials, &box, &ny, &nx, &n_steps, &c};
  return lbm::status(with_band(seg_w, [&](auto sw) {
    constexpr int SW = decltype(sw)::value, D = band_depth(SW);
    int per_sm = 0;
    const cudaError_t e = banded_prepared<SW>(&per_sm);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;  // a block does not fit the card
    return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(resident_banded_kernel<D, SW>),
                                       dim3(blocks), dim3(kBandThreads), args,
                                       Band<D, SW>::kSmem, st);
  }));
}
