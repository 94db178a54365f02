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
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC

#include <cstdint>
#include <type_traits>

#include "step_common.cuh"

namespace {

constexpr int kTx = 32;  // tile width (own cells)
constexpr int kTy = 16;  // tile height (own cells)
constexpr int kThreads = 256;

// A window in shared memory: 9 planes of h x w floats, the mask, and a
// flag per window row that marks the images of row ny-2.
struct Window {
  const float* planes;
  const uint8_t* mask;
  const uint8_t* accel_rows;
  int w;
  int plane;  // h * w
  __device__ __forceinline__ float f(int k, int r, int c) const {
    return planes[k * plane + r * w + c];
  }
  __device__ __forceinline__ bool obst(int r, int c) const {
    return mask[r * w + c] != 0;
  }
  __device__ __forceinline__ bool accel(int r) const {
    return accel_rows[r] != 0;
  }
};

template <int K>
struct Shape {
  static constexpr int kW = kTx + 2 * K;  // window width
  static constexpr int kH = kTy + 2 * K;  // window height
  static constexpr int kPlane = kW * kH;
  // two state buffers, the mask, the forcing-row flags
  static constexpr size_t kSmemBytes =
      2 * 9 * kPlane * sizeof(float) + kPlane + kH;
};

__device__ __forceinline__ int wrap(int v, int n) {
  const int m = v % n;
  return m < 0 ? m + n : m;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    kstep_kernel(const float* __restrict__ f, float* __restrict__ out,
                 const uint8_t* __restrict__ mask, float* __restrict__ partials,
                 int ny, int nx, lbm::StepConsts c) {
  using S = Shape<K>;
  extern __shared__ float4 smem_raw[];
  float* buf0 = reinterpret_cast<float*>(smem_raw);
  float* buf1 = buf0 + 9 * S::kPlane;
  uint8_t* wmask = reinterpret_cast<uint8_t*>(buf1 + 9 * S::kPlane);
  uint8_t* accel_rows = wmask + S::kPlane;
  __shared__ float red[kThreads];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTx;  // global column of own cell (0, 0)
  const int y0 = blockIdx.y * kTy;
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t plane = static_cast<size_t>(ny) * nx;

  // load the window: window cell (r, c) is global cell
  // ((y0 - K + r) mod ny, (x0 - K + c) mod nx)
  for (int i = tid; i < S::kPlane; i += kThreads) {
    const int r = i / S::kW, col = i % S::kW;
    const size_t g = static_cast<size_t>(wrap(y0 - K + r, ny)) * nx +
                     wrap(x0 - K + col, nx);
#pragma unroll
    for (int k = 0; k < 9; ++k) buf0[k * S::kPlane + i] = f[k * plane + g];
    wmask[i] = mask[g];
  }
  for (int r = tid; r < S::kH; r += kThreads) {
    accel_rows[r] = wrap(y0 - K + r, ny) == ny - 2;
  }
  __syncthreads();

  float* cur = buf0;
  float* nxt = buf1;
  for (int s = 1; s <= K; ++s) {
    const Window src{cur, wmask, accel_rows, S::kW, S::kPlane};
    const int lo = s, rows = S::kH - 2 * s, cols = S::kW - 2 * s;
    float norm = 0.0f;
    for (int i = tid; i < rows * cols; i += kThreads) {
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
          y0 + oy < ny && x0 + ox < nx) {
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
    if (y < ny && x < nx) {
      const int j = (oy + K) * S::kW + ox + K;
      const size_t g = static_cast<size_t>(y) * nx + x;
#pragma unroll
      for (int k = 0; k < 9; ++k) out[k * plane + g] = cur[k * S::kPlane + j];
    }
  }
}

template <int K>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(kstep_kernel<K>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Shape<K>::kSmemBytes));
}

template <int K>
cudaError_t launch(const float* f, float* out, const uint8_t* mask,
                   float* partials, int ny, int nx, const lbm::StepConsts& c,
                   cudaStream_t stream) {
  // the shared-memory limit is a property of the function on the current
  // device; setting it is a host-side call, cheap beside a launch
  const cudaError_t err = set_smem<K>();
  if (err != cudaSuccess) return err;
  const dim3 grid((nx + kTx - 1) / kTx, (ny + kTy - 1) / kTy);
  kstep_kernel<K><<<grid, kThreads, Shape<K>::kSmemBytes, stream>>>(
      f, out, mask, partials, ny, nx, c);
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

// Loads the kernel for K onto the current device and sets its
// shared-memory limit, without launching it.
extern "C" int lbm_kstep_prepare(int k) {
  return lbm::status(
      with_k(k, [](auto kk) { return set_smem<decltype(kk)::value>(); }));
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
  return lbm::status(with_k(k, [&](auto kk) {
    return launch<decltype(kk)::value>(f, out, mask, partials, ny, nx, c, st);
  }));
}
