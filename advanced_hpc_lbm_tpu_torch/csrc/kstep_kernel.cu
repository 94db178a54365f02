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
// * Schedule.  A persistent grid (the blocks that fit on the card at once,
//   from the occupancy query in lbm_kstep_prepare) walks the tiles: block b
//   takes tiles b, b + grid, ...  Each block holds two windows: while one
//   steps, the next tile's window arrives in the other by cp.async, issued
//   before this tile's steps and awaited (cp.async.wait_group, then a
//   barrier) after them.  A tile whose window lies inside the grid (and
//   16-byte aligned) loads with 16-byte copies at plain offsets; only tiles
//   on the grid's edge wrap, by 4-byte copies.
// * Steps.  K steps in place in the window (window_common.cuh): step s
//   computes rows [s, H - s) and the columns [kA - K + s, kA + kTx + K - s)
//   from the values step s-1 left valid, each cell by
//   step_common.cuh:cell_step, so the state agrees with the step kernel's
//   bit for bit.  Two barriers per step, no division by a runtime value.
// * Forcing.  A pull is forced where its source row is an image of row
//   ny-2 (row bits of the window, by ballot), the guard at the source cell;
//   a window holding no image of it steps without the test.
// * Output.  After K steps the tile's own cells are written out of place,
//   and one ||u|| partial per step and tile (own fluid cells, warps summed
//   in warp order) goes to partials[s, tile].
//
// Bound on this card: device memory moves (9 x 4 + 1) B per cell in and
// 36 B out per pass, 24.3 B per cell and step at K = 3 and 18.25 at K = 4
// (121.87 and 91.40 us per step at 4096^2 at 3.35 TB/s).  What binds is
// instruction issue: a cell step is ~145 instructions (94 float32
// operations, an IEEE 1/rho and sqrt, 10 shared-memory loads and 9
// stores; SASS), the ghost ring is stepped redundantly (1844 cell steps
// per 1536 own ones at K = 3, 2680 per 2048 at K = 4), and the kernel
// issues at ~40% of the card's rate.  Registers decide the blocks per SM:
// up to K = 3 a block's staged cells fit 80 registers and 3 blocks run
// per SM; from K = 4 a block takes up to 128 and 2 run (at 80, K = 4
// spilled and ran 11% slower).  Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py 3k): 236.85 us per step at 4096^2 at K = 3 (the earlier
// two-buffer kernel: 303.93 at K = 4), 19.26 at 1024^2; above 4096^2 K = 4 is the
// faster (964 us per step at 8192^2).
//
// The local form (kLocal, `lbm_local_ca`) replaces
// advanced_hpc_lbm_tpu/ops/pallas_local.py `_local_ca_kernel`, behind
// parallel/halo.py's `pallas` shard kernel with ca_steps = K: K steps of one
// shard of a 1-D ring from its (ly+2K, nx) ghost window, whose K ghost rows
// above and below the own rows [K, K+ly) the exchange fills from the ring
// neighbours.  The same schedule, steps and per-cell code, with three
// differences:
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

#include <cstdint>
#include <type_traits>

#include "step_common.cuh"
#include "window_common.cuh"

namespace {

constexpr int kTx = 32;  // tile width (own cells): one warp per window row
constexpr int kTy = 16;  // tile height (own cells)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int K>
struct Shape {
  static constexpr int kA = (K + 3) / 4 * 4;  // ghost columns loaded per side
  static constexpr int kH = kTy + 2 * K;      // window rows
  static constexpr int kW = kTx + 2 * kA;     // window columns = row pitch
  static constexpr int kGroups = kW / 4;      // 16-byte groups per window row
  using Geo = lbm::WinGeo<kH, kW>;
  // two windows: the one that steps and the one being loaded
  static constexpr size_t kSmemBytes = 2 * static_cast<size_t>(Geo::kBytes);
  // blocks per SM the register budget is set for: 3 (80 registers) up to
  // K = 3, where a thread's staged cells fit them without spilling and 3
  // pairs of windows fit in shared memory; else 2 (128 registers)
  static constexpr int kMinBlocks = K <= 3 ? 3 : 2;
};

// The kernel's arguments, a __grid_constant__ parameter: they stay in the
// constant bank (the out-of-line window load and store below read them by
// reference, without a local copy), so the steps keep none of them in
// registers.  kLocal = false: a periodic (rows, nx) grid, src_rows = rows,
// mask nonzero = blocked, forcing on row rows-2.  kLocal = true: the own
// rows [0, rows) of a shard read from its (src_rows = rows+2K, nx) window,
// mask encoded (+1/+2).  `f` / `out` have plane strides f_plane /
// out_plane; `vec`: f, f_plane, nx and mask allow 16-byte window rows.
struct Args {
  const float* f;
  long long f_plane;
  int src_rows;
  float* out;
  long long out_plane;
  const uint8_t* mask;
  float* partials;
  int rows, nx, vec;
  lbm::StepConsts c;
  __device__ __forceinline__ int tiles_x() const { return (nx + kTx - 1) / kTx; }
  __device__ __forceinline__ int tiles() const { return tiles_x() * ((rows + kTy - 1) / kTy); }
  // row and column of tile t's own cell (0, 0)
  __device__ __forceinline__ void origin(int t, int& y0, int& x0) const {
    const int ty = t / tiles_x();
    y0 = ty * kTy;
    x0 = (t - ty * tiles_x()) * kTx;
  }
};

// Issue the copies of tile t's window into `buf` (no wait).  Window cell
// (r, c) is source cell ((yorg + r) mod src_rows, (xorg + c) mod nx): yorg
// K rows above the tile on the periodic grid, or window row y0 of a
// shard's ghost window (whose own rows start K rows down).
template <int K, bool kLocal>
__device__ __noinline__ void load_window(uint8_t* buf, const Args& a, int t, int tid) {
  using S = Shape<K>;
  using G = typename S::Geo;
  int y0, x0;
  a.origin(t, y0, x0);
  const int yorg = kLocal ? y0 : y0 - K, xorg = x0 - S::kA;
  float* const wf = reinterpret_cast<float*>(buf);
  uint8_t* const wm = buf + 4 * G::kFloats;
  const size_t fp = static_cast<size_t>(a.f_plane);
  if (a.vec && yorg >= 0 && yorg + S::kH <= a.src_rows && xorg >= 0 && xorg + S::kW <= a.nx) {
    for (int i = tid; i < S::kH * S::kGroups; i += kThreads) {
      const int r = i / S::kGroups, q = i - r * S::kGroups;
      const size_t g = static_cast<size_t>(yorg + r) * a.nx + xorg + 4 * q;
      const int j = r * S::kW + 4 * q;
#pragma unroll
      for (int k = 0; k < 9; ++k) lbm::cp_async16(wf + k * G::kPlane + j, a.f + k * fp + g);
      lbm::cp_async4(wm + j, a.mask + g);
    }
  } else {
    for (int i = tid; i < G::kPlane; i += kThreads) {
      const int r = i / S::kW, c = i - r * S::kW;
      const size_t g = static_cast<size_t>(lbm::wrap(yorg + r, a.src_rows)) * a.nx +
                       lbm::wrap(xorg + c, a.nx);
#pragma unroll
      for (int k = 0; k < 9; ++k) lbm::cp_async4(wf + k * G::kPlane + i, a.f + k * fp + g);
      wm[i] = a.mask[g];  // read only after the wait and barrier, like the copies
    }
  }
}

// Write tile t's own cells inside the grid from its window `planes` to
// out, and its ||u|| partials (threads s < K, warps summed in warp order).
template <int K>
__device__ __noinline__ void store_tile(const float* planes, float (*wsum)[kWarps],
                                        const Args& a, int t, int tid) {
  using S = Shape<K>;
  int y0, x0;
  a.origin(t, y0, x0);
  const int own_h = min(kTy, a.rows - y0), own_w = min(kTx, a.nx - x0);
  const size_t op = static_cast<size_t>(a.out_plane);
  for (int i = tid; i < kTy * kTx; i += kThreads) {
    const int oy = i / kTx, ox = i % kTx;
    if (oy < own_h && ox < own_w) {
      const int j = (oy + K) * S::kW + ox + S::kA;
      const size_t g = static_cast<size_t>(y0 + oy) * a.nx + x0 + ox;
#pragma unroll
      for (int k = 0; k < 9; ++k) a.out[k * op + g] = planes[k * S::Geo::kPlane + j];
    }
  }
  if (tid < K) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total = total + wsum[tid][w];
    a.partials[static_cast<size_t>(tid) * a.tiles() + t] = total;
  }
}

// Steps s = S..K of one window, in place.
template <int K, int S, bool kLocal, bool kForce, class Counted>
__device__ __forceinline__ void steps(const lbm::Window<Shape<K>::kH, Shape<K>::kW, kForce,
                                                        kLocal>& win,
                                      float* planes, const lbm::StepConsts& c,
                                      Counted counted, float (*wsum)[kWarps], int warp) {
  using Sh = Shape<K>;
  lbm::step<kThreads, S, Sh::kH - 2 * S, Sh::kA - K + S, kTx + 2 * (K - S), true>(
      win, planes, c, counted, [&](float v) { wsum[S - 1][warp] = v; });
  if constexpr (S < K) steps<K, S + 1, kLocal, kForce>(win, planes, c, counted, wsum, warp);
}

template <int K, bool kLocal>
__global__ void __launch_bounds__(kThreads, Shape<K>::kMinBlocks)
    kstep_kernel(const __grid_constant__ Args a) {
  using S = Shape<K>;
  using G = typename S::Geo;
  extern __shared__ float4 smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(smem_raw);
  __shared__ float wsum[K][kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int t = blockIdx.x;  // the grid has at most `tiles` blocks
  load_window<K, kLocal>(smem, a, t, tid);
  lbm::cp_async_commit();
  for (int b = 0; t < a.tiles(); t += gridDim.x, b ^= 1) {
    uint8_t* const buf = smem + b * G::kBytes;
    if (t + static_cast<int>(gridDim.x) < a.tiles()) {
      load_window<K, kLocal>(smem + (b ^ 1) * G::kBytes, a, t + gridDim.x, tid);
    }
    lbm::cp_async_commit();
    lbm::cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();          // ... everyone's

    float* const planes = reinterpret_cast<float*>(buf);
    const uint8_t* const wm = buf + 4 * G::kFloats;
    {
      int y0, x0;
      a.origin(t, y0, x0);
      const int yorg = kLocal ? y0 : y0 - K;
      // own cells inside the grid: rows [K, K + own_h), columns [kA, kA + own_w)
      const unsigned own_h = min(kTy, a.rows - y0), own_w = min(kTx, a.nx - x0);
      auto counted = [own_h, own_w](int r, int col, uint8_t, bool obst) {
        return !obst && static_cast<unsigned>(r - K) < own_h &&
               static_cast<unsigned>(col - S::kA) < own_w;
      };
      lbm::RowBits<(S::kH + 31) / 32> frow;
      if constexpr (kLocal) {
        frow = lbm::forcing_rows<S::kH, S::kW>(wm, lane);
      } else {
        const int n = a.src_rows;
        const bool inside = yorg >= 0 && yorg + S::kH <= n;
        frow = lbm::row_bits<S::kH>(lane, [&](int r) {
          return (inside ? yorg + r : lbm::wrap(yorg + r, n)) == n - 2;
        });
      }
      if (frow.any()) {
        const lbm::Window<S::kH, S::kW, true, kLocal> win{planes, wm, frow};
        steps<K, 1, kLocal, true>(win, planes, a.c, counted, wsum, warp);
      } else {
        const lbm::Window<S::kH, S::kW, false, kLocal> win{planes, wm, frow};
        steps<K, 1, kLocal, false>(win, planes, a.c, counted, wsum, warp);
      }
    }
    store_tile<K>(planes, wsum, a, t, tid);
    __syncthreads();  // this window is free for the tile after next
  }
  lbm::cp_async_wait<0>();
}

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

// Sets the kernel's shared-memory limit on device `dev` (the current
// device) and sizes its persistent grid from the occupancy query.
template <int K, bool kLocal>
cudaError_t prepare_on(int dev) {
  const auto kernel = kstep_kernel<K, kLocal>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Shape<K>::kSmemBytes));
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        Shape<K>::kSmemBytes);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;  // a block does not fit on an SM
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

template <int K, bool kLocal>
cudaError_t launch(const float* f, long long f_plane, int src_rows, float* out,
                   long long out_plane, const uint8_t* mask, float* partials,
                   int rows, int nx, const lbm::StepConsts& c,
                   cudaStream_t stream) {
  int dev = 0;
  const cudaError_t err = prepared<K, kLocal>(&dev);
  if (err != cudaSuccess) return err;
  const int tiles = ((nx + kTx - 1) / kTx) * ((rows + kTy - 1) / kTy);
  const int blocks = g_per_sm[dev][K][kLocal] * g_sms[dev];
  const int grid = tiles < blocks ? tiles : blocks;
  const bool vec = nx % 4 == 0 && f_plane % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  const Args args{f, f_plane, src_rows, out, out_plane, mask, partials, rows, nx,
                  vec ? 1 : 0, c};
  kstep_kernel<K, kLocal><<<grid, kThreads, Shape<K>::kSmemBytes, stream>>>(args);
  return cudaSuccess;
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

// The tile of own cells of one block; the wrapper sizes the partials from it.
extern "C" void lbm_kstep_tile_shape(int* tile_x, int* tile_y) {
  *tile_x = kTx;
  *tile_y = kTy;
}

// Loads the kernel for K (both forms) onto the current device, sets its
// shared-memory limit and sizes its persistent grid, without launching it.
// A launch on a device not yet prepared prepares it first.
extern "C" int lbm_kstep_prepare(int k) {
  return lbm::status(with_k(k, [](auto kk) {
    constexpr int K = decltype(kk)::value;
    int dev = 0;
    const cudaError_t err = prepared<K, false>(&dev);
    return err != cudaSuccess ? err : prepared<K, true>(&dev);
  }));
}

// Blocks per SM of the persistent grid of the kernel for K (form `local`)
// on the current device, preparing it first; 0 if it cannot run there.
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

// K steps: out = step^K(f).  `partials` receives K x tiles floats,
// tiles = ceil(ny/16) * ceil(nx/32), in row-major tile order.  Launches on
// `stream`; returns the launch's cudaError_t (0 = launched).
extern "C" int lbm_kstep(const float* f, float* out, const uint8_t* mask,
                         float* partials, int ny, int nx, int k,
                         float w0_omega, float w1_omega, float w2_omega,
                         float one_minus_omega, float accel_w1,
                         float accel_w2, void* stream) {
  const lbm::StepConsts c{w0_omega,        w1_omega, w2_omega,
                          one_minus_omega, accel_w1, accel_w2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(ny) * nx;
  return lbm::status(with_k(k, [&](auto kk) {
    return launch<decltype(kk)::value, false>(f, plane, ny, out, plane, mask, partials,
                                              ny, nx, c, st);
  }));
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
                           ly, nx, c, st);
  }));
}
