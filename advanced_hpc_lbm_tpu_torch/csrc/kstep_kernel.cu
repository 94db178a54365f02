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
// grid.  Here blocks run in no order, so each owns a 2-D tile and loads
// everything it needs itself:
//
// * Window.  A block owns a kTx x kTy tile and loads the tile plus a ghost
//   ring K deep on all four sides, (kTy+2K) x (kTx+2K) cells of the 9
//   planes and the mask, into dynamic shared memory.  Loads wrap with
//   mod ny and mod nx, so a window is a periodic image of the grid, also
//   on grids smaller than the window (17x23 at K=8 wraps more than once).
// * Steps.  K steps in shared memory, ping-ponging two window buffers.  The
//   valid region shrinks by one cell per side per step: step s computes
//   rows and columns [s, W - s) from the values step s-1 left valid.
// * Forcing.  Each step forces the cells whose global row mod ny is ny-2
//   (every image of it), with the guard evaluated at the source cell: the
//   per-cell step of step_common.cuh, as the step kernel runs it, so the
//   state agrees with the step kernel's bit for bit.
// * Output.  The tile's own cells are written out of place after K steps,
//   and one ||u|| partial per step and tile (own fluid cells) goes to
//   partials[s, tile], tiles in row-major order.
//
// Bound on this card: a pass reads the window (kTy+2K)(kTx+2K)/(kTy kTx)
// times the tile (3x at K = 8) and writes the tile once, so device-memory
// traffic per cell and step falls from the step kernel's 73 B to about
// (36 x 3 + 36 + 1)/8 = 18 B at K = 8; in exchange the ghost ring is
// computed redundantly (1.8x the own cells at K = 8) and every value
// crosses shared memory twice per step.  The x-shifted shared-memory reads
// of a warp that spans two window rows meet 2-way bank conflicts; tile
// shape, TMA loads and clusters are later work.
//
// The local form (kLocal, `lbm_local_ca`) replaces
// advanced_hpc_lbm_tpu/ops/pallas_local.py `_local_ca_kernel`, behind
// parallel/halo.py's `pallas` shard kernel with ca_steps = K: K steps of one
// shard of a 1-D ring from its (ly+2K, nx) ghost window, whose K ghost rows
// above and below the own rows [K, K+ly) the exchange fills from the ring
// neighbours.  The same blocks, steps and per-cell code, with three
// differences:
//
// * Grid.  The tiles cover the own rows only; tile rows y0.. load window
//   rows y0.. (own row y is window row y + K), x wraps mod nx.  A ragged
//   last tile loads rows past the window's end, wrapped mod ly+2K: that
//   garbage lies past window row ly+2K-1 and spreads back one row per
//   step, so after K steps it has reached window row ly+K, the first row
//   past the own rows, and no own row (the TPU kernel's argument for its
//   wrapping rolls over the whole window).
// * Forcing.  From the window's encoded mask (+2), per cell, not from
//   `row == ny-2`: global row ny-2 can appear twice in a window (a shard's
//   own row and, on the last shard, the ghost image of it), and a mask
//   marks both.
// * Partials.  Only own cells of a tile are counted, and a tile's own
//   cells are own rows of the shard, so the ghost rows never enter the
//   ||u|| sums.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC

#include <cstdint>
#include <type_traits>

#include "step_common.cuh"

namespace {

constexpr int kTx = 32;  // tile width (own cells)
constexpr int kTy = 16;  // tile height (own cells)
constexpr int kThreads = 256;

// A window in shared memory: 9 planes of h x w floats and the encoded mask
// (+1 obstacle, +2 forcing cell: an image of row ny-2).
struct Window {
  const float* planes;
  const uint8_t* mask;
  int w;
  int plane;  // h * w
  __device__ __forceinline__ float f(int k, int r, int c) const {
    return planes[k * plane + r * w + c];
  }
  __device__ __forceinline__ bool obst(int r, int c) const {
    return (mask[r * w + c] & 1) != 0;
  }
  __device__ __forceinline__ bool accel(int r, int c) const {
    return (mask[r * w + c] & 2) != 0;
  }
};

template <int K>
struct Shape {
  static constexpr int kW = kTx + 2 * K;  // window width
  static constexpr int kH = kTy + 2 * K;  // window height
  static constexpr int kPlane = kW * kH;
  // two state buffers and the encoded mask
  static constexpr size_t kSmemBytes = 2 * 9 * kPlane * sizeof(float) + kPlane;
};

__device__ __forceinline__ int wrap(int v, int n) {
  const int m = v % n;
  return m < 0 ? m + n : m;
}

// kLocal = false: a periodic (rows, nx) grid, src_rows = rows, mask
// nonzero = blocked, forcing on row rows-2.  kLocal = true: the own rows
// [0, rows) of a shard read from its (src_rows = rows+2K, nx) window, mask
// encoded (+1/+2).  `f` / `out` have plane strides f_plane / out_plane.
template <int K, bool kLocal>
__global__ void __launch_bounds__(kThreads)
    kstep_kernel(const float* __restrict__ f, long long f_plane, int src_rows,
                 float* __restrict__ out, long long out_plane,
                 const uint8_t* __restrict__ mask, float* __restrict__ partials,
                 int rows, int nx, lbm::StepConsts c) {
  using S = Shape<K>;
  extern __shared__ float4 smem_raw[];
  float* buf0 = reinterpret_cast<float*>(smem_raw);
  float* buf1 = buf0 + 9 * S::kPlane;
  uint8_t* wmask = reinterpret_cast<uint8_t*>(buf1 + 9 * S::kPlane);
  __shared__ float red[kThreads];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTx;  // column of own cell (0, 0)
  const int y0 = blockIdx.y * kTy;  // row of own cell (0, 0)
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  // source row of window row 0: K rows above the tile on the periodic
  // grid; window row y0 of a shard's ghost window, whose own rows start K
  // rows down
  const int yorg = kLocal ? y0 : y0 - K;

  // load the window: window cell (r, c) is source cell
  // ((yorg + r) mod src_rows, (x0 - K + c) mod nx)
  for (int i = tid; i < S::kPlane; i += kThreads) {
    const int r = i / S::kW, col = i % S::kW;
    const int sr = wrap(yorg + r, src_rows);
    const size_t g = static_cast<size_t>(sr) * nx + wrap(x0 - K + col, nx);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      buf0[k * S::kPlane + i] = f[k * static_cast<size_t>(f_plane) + g];
    }
    if constexpr (kLocal) {
      wmask[i] = mask[g] & 3;
    } else {
      wmask[i] = (mask[g] != 0 ? 1 : 0) | (sr == src_rows - 2 ? 2 : 0);
    }
  }
  __syncthreads();

  float* cur = buf0;
  float* nxt = buf1;
  for (int s = 1; s <= K; ++s) {
    const Window src{cur, wmask, S::kW, S::kPlane};
    const int lo = s, h = S::kH - 2 * s, cols = S::kW - 2 * s;
    float norm = 0.0f;
    for (int i = tid; i < h * cols; i += kThreads) {
      const int r = lo + i / cols, col = lo + i % cols;
      const bool obst = src.obst(r, col);
      float v[9];
      const float u_sq =
          lbm::cell_step(src, r, col, r - 1, r + 1, col - 1, col + 1, v, obst, c);
      const int j = r * S::kW + col;
#pragma unroll
      for (int k = 0; k < 9; ++k) nxt[k * S::kPlane + j] = v[k];
      // own cells inside the grid count towards this step's ||u||
      const int oy = r - K, ox = col - K;
      if (!obst && oy >= 0 && oy < kTy && ox >= 0 && ox < kTx &&
          y0 + oy < rows && x0 + ox < nx) {
        norm = norm + sqrtf(u_sq);
      }
    }
    // the block sum's barriers also publish `nxt` for the next step
    const float total = lbm::block_sum(norm, red, tid, kThreads);
    if (tid == 0) partials[static_cast<size_t>(s - 1) * tiles + tile] = total;
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // write the own cells that lie inside the grid
  for (int i = tid; i < kTy * kTx; i += kThreads) {
    const int oy = i / kTx, ox = i % kTx;
    const int y = y0 + oy, x = x0 + ox;
    if (y < rows && x < nx) {
      const int j = (oy + K) * S::kW + ox + K;
      const size_t g = static_cast<size_t>(y) * nx + x;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        out[k * static_cast<size_t>(out_plane) + g] = cur[k * S::kPlane + j];
      }
    }
  }
}

template <int K, bool kLocal>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(kstep_kernel<K, kLocal>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Shape<K>::kSmemBytes));
}

template <int K, bool kLocal>
cudaError_t launch(const float* f, long long f_plane, int src_rows, float* out,
                   long long out_plane, const uint8_t* mask, float* partials,
                   int rows, int nx, const lbm::StepConsts& c,
                   cudaStream_t stream) {
  // the shared-memory limit is a property of the function on the current
  // device; setting it is a host-side call, cheap beside a launch
  const cudaError_t err = set_smem<K, kLocal>();
  if (err != cudaSuccess) return err;
  const dim3 grid((nx + kTx - 1) / kTx, (rows + kTy - 1) / kTy);
  kstep_kernel<K, kLocal><<<grid, kThreads, Shape<K>::kSmemBytes, stream>>>(
      f, f_plane, src_rows, out, out_plane, mask, partials, rows, nx, c);
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

// Loads the kernel for K (both forms) onto the current device and sets its
// shared-memory limit, without launching it.
extern "C" int lbm_kstep_prepare(int k) {
  return lbm::status(with_k(k, [](auto kk) {
    const cudaError_t err = set_smem<decltype(kk)::value, false>();
    return err != cudaSuccess ? err : set_smem<decltype(kk)::value, true>();
  }));
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
