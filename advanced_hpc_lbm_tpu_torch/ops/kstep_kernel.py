"""K timesteps per pass over device memory: the ghost-zone CUDA kernel, its
wrapper and its plain PyTorch version.

The port's counterpart of ``advanced_hpc_lbm_tpu.ops.pallas_k``
(``multi_step``, ``run`` and the kernels ``_kernel_k`` / ``_kernel_k_lean``)
and of ``advanced_hpc_lbm_tpu.ops.pallas_multi`` (``double_step``, ``run``
and ``_kernel2``, the same scheme at K = 2).  :func:`kstep` is the wrapper:
on a CUDA tensor it launches ``csrc/kstep_kernel.cu`` and adds one to
:data:`launches`; on a CPU tensor it runs :func:`plain_multi_step`.  A CUDA
tensor never falls back to the plain version: the launch happens or the
wrapper raises.

The kernel cuts the grid into TILE_X x TILE_Y tiles; a persistent grid of
blocks walks them, each tile loaded with a ghost ring K deep on every side
(periodic wrap) into a window in shared memory, stepped K times in place
while the next tile's window loads; the plain version builds the same
windows with periodic index gathers and runs K calls of
:func:`kernel_common.lean_window_step` on them.  A pass writes the next
state out of place and one ||u|| partial per step and tile,
``partials[s, tile]``, tiles in row-major order.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools

import torch

from advanced_hpc_lbm_tpu_torch.ops import kernel_common, lattice, step_kernel
from advanced_hpc_lbm_tpu_torch.params import LBMParams
from advanced_hpc_lbm_tpu_torch.utils import profiling

# Own cells of one tile (kTx, kTy in csrc/kstep_kernel.cu; _library()
# checks that the two agree).
TILE_X, TILE_Y = 32, 16

# The K the kernel is built for (the JAX kernel's range, pallas_k.py:135).
K_RANGE = range(2, 9)

# Steps of ||u|| partials held before they are summed, as step_kernel.run.
CHUNK = step_kernel.CHUNK

# Kernel launches made by this module since the count was last reset, and
# the same launches by K (K = 2 is the port of pallas_multi's _kernel2).
launches = 0
launches_by_k: collections.Counter = collections.Counter()

prepare_obstacles = step_kernel.prepare_obstacles


def best_k(ny: int, nx: int) -> int:
    """The K of the ``pallask`` backend, from this port's times on an H100
    80GB HBM3 at 700 W (chip_smoke.py, PERF.md, Findings): 5 up to
    512^2, where a pass is paced by the host's launch and more steps per
    launch pay (3.37 us per step at 64^2 against 3.88 at K = 6 and 3.45 at
    K = 4); 3 up to 4096^2, where the kernel is bound by instruction issue
    and K = 3 steps the narrowest ghost ring (1.20 cell steps per own one
    against 1.31 at K = 4) with the staged cells of 3 blocks per SM in
    registers (236.85 us per step at 4096^2 against 246.31 at K = 4; 19.26
    against 20.06 at 1024^2); 4 above, where device memory tells (964 us
    per step at 8192^2 against 1148 at K = 3, 3862 against 4850 at
    16384^2)."""
    cells = ny * nx
    return 5 if cells <= 512 * 512 else 3 if cells <= 4096 * 4096 else 4


def num_tiles(ny: int, nx: int) -> int:
    """Tiles of one pass: one ||u|| partial each per step."""
    return -(-ny // TILE_Y) * -(-nx // TILE_X)


def _windows(ny: int, nx: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Global rows (tiles_y, TILE_Y + 2k) and columns (tiles_x, TILE_X + 2k)
    of every tile's ghosted window, wrapped periodically."""
    ty, tx = -(-ny // TILE_Y), -(-nx // TILE_X)
    rows = (torch.arange(ty, device=device)[:, None] * TILE_Y - k
            + torch.arange(TILE_Y + 2 * k, device=device)) % ny
    cols = (torch.arange(tx, device=device)[:, None] * TILE_X - k
            + torch.arange(TILE_X + 2 * k, device=device)) % nx
    return rows, cols


def plain_multi_step(
    f: torch.Tensor,
    mask: torch.Tensor,
    params: LBMParams,
    k: int,
    *,
    out: torch.Tensor,
    partials: torch.Tensor,
) -> None:
    """The kernel's pass in plain PyTorch, on any device: every tile's
    ghosted window at once, K lean window steps at the window's modulus,
    then each tile's own cells to ``out`` and its own fluid cells' ||u||
    per step to ``partials`` (k, tiles)."""
    _, ny, nx = f.shape
    rows, cols = _windows(ny, nx, k, f.device)
    ty, tx = rows.shape[0], cols.shape[0]
    r, c = rows[:, None, :, None], cols[None, :, None, :]
    src = f[:, r, c]  # (9, ty, tx, TILE_Y + 2k, TILE_X + 2k)
    dst = torch.empty_like(src)
    w_obst = mask[r, c] != 0
    accel = r == ny - 2
    # own cells inside the grid, in window coordinates
    own = (slice(k, k + TILE_Y), slice(k, k + TILE_X))
    inside = ((torch.arange(ty, device=f.device)[:, None, None, None] * TILE_Y
               + torch.arange(TILE_Y, device=f.device)[:, None] < ny)
              & (torch.arange(tx, device=f.device)[None, :, None, None] * TILE_X
                 + torch.arange(TILE_X, device=f.device) < nx))
    counted = inside & ~w_obst[(..., *own)]
    T, W = src.shape[-2:]
    for s in range(k):
        u_sq = kernel_common.lean_window_step(src, dst, w_obst, accel, params, T, W)
        norm = torch.where(counted, torch.sqrt(u_sq[(..., *own)]), 0.0)
        partials[s] = norm.sum(dim=(-2, -1)).reshape(-1)
        src, dst = dst, src
    tiles = src[(..., *own)].permute(0, 1, 3, 2, 4).reshape(
        lattice.NSPEEDS, ty * TILE_Y, tx * TILE_X)
    out.copy_(tiles[:, :ny, :nx])


@functools.cache
def _library() -> ctypes.CDLL:
    lib = step_kernel._library()
    tx, ty = ctypes.c_int(), ctypes.c_int()
    lib.lbm_kstep_tile_shape(ctypes.byref(tx), ctypes.byref(ty))
    if (tx.value, ty.value) != (TILE_X, TILE_Y):
        raise RuntimeError(
            f"kernel tile {tx.value}x{ty.value} != wrapper's {TILE_X}x{TILE_Y}"
        )
    return lib


def _check_k(k: int) -> None:
    if k not in K_RANGE:
        raise ValueError(f"K must be in 2..8, got {k}")


def prepare(device: torch.device | str, k: int) -> None:
    """Build and load the kernel library and load the kernel for K onto
    ``device`` without launching it."""
    _check_k(k)
    device = torch.device(device)
    if device.type != "cuda":
        return
    lib = _library()
    with torch.cuda.device(device):
        torch.zeros(1, device=device)  # create the context first
        step_kernel._raise_on(lib, lib.lbm_kstep_prepare(k), f"loading the K={k} kernel")


def _launcher(f: torch.Tensor, mask: torch.Tensor, params: LBMParams, k: int):
    """A function ``(src, dst, partials) -> None`` that runs one pass on
    tensors shaped like ``f``: the kernel on CUDA, the plain version on the
    CPU.  Arguments are validated by the caller, once."""
    if f.device.type == "cpu":
        def one(src, dst, part):
            plain_multi_step(src, mask, params, k, out=dst, partials=part)
        return one
    if f.device.type != "cuda":
        raise ValueError(f"no K-step kernel for device {f.device}")
    lib = _library()
    _, ny, nx = f.shape
    consts = step_kernel._consts(params)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    mask_ptr = mask.data_ptr()

    def one(src, dst, part):
        global launches
        err = lib.lbm_kstep(src.data_ptr(), dst.data_ptr(), mask_ptr, part.data_ptr(),
                            ny, nx, k, *consts, stream)
        step_kernel._raise_on(lib, err, f"K={k} kernel launch")
        launches += 1
        launches_by_k[k] += 1
    return one


def kstep(
    f: torch.Tensor,
    mask: torch.Tensor,
    params: LBMParams,
    k: int,
    *,
    out: torch.Tensor,
    partials: torch.Tensor,
) -> None:
    """K steps, out of place: ``out`` gets the state K steps on and
    ``partials`` ((k, num_tiles(ny, nx)) float32) the per-step, per-tile
    ||u|| sums.  Launches the kernel for a CUDA tensor, runs
    :func:`plain_multi_step` for a CPU one."""
    _check_k(k)
    step_kernel._validate(f, mask, out, partials)
    _, ny, nx = f.shape
    if out.shape != f.shape or out.dtype != f.dtype or not out.is_contiguous():
        raise ValueError("out must be a contiguous tensor shaped like f")
    if (partials.shape != (k, num_tiles(ny, nx)) or partials.dtype != torch.float32
            or not partials.is_contiguous()):
        raise ValueError(f"partials must be ({k}, {num_tiles(ny, nx)}) float32")
    with torch.cuda.device(f.device) if f.is_cuda else contextlib.nullcontext():
        _launcher(f, mask, params, k)(f, out, partials)


def multi_step(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    n_fluid: torch.Tensor,
    params: LBMParams,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance K timesteps in one pass; returns (f_next, av_k (k,)), like
    the JAX ``pallas_k.multi_step``.  Takes a bool or a prepared uint8
    mask."""
    mask = obstacles if obstacles.dtype == torch.uint8 else prepare_obstacles(obstacles)
    out = torch.empty_like(f)
    partials = torch.empty((k, num_tiles(*f.shape[1:])), dtype=torch.float32,
                           device=f.device)
    kstep(f, mask, params, k, out=out, partials=partials)
    return out, partials.sum(dim=1) / n_fluid


def double_step(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    n_fluid: torch.Tensor,
    params: LBMParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance two timesteps (K = 2); returns (f_next2, av_step1,
    av_step2), like the JAX ``pallas_multi.double_step``."""
    f2, av = multi_step(f, obstacles, n_fluid, params, 2)
    return f2, av[0], av[1]


def run(
    f0: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    *,
    n_iters: int | None = None,
    k: int = 4,
    chunk: int = CHUNK,
    donate: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the main loop at K steps per pass, ping-ponging two state
    buffers; the last ``iters % k`` steps run on the step kernel in the
    same two buffers, as the JAX ``pallas_k.run`` and ``pallas_multi.run``
    run them on the 1-step kernel.  ``f0`` is not modified, unless
    ``donate`` (see :func:`step_kernel.buffers`).

    Returns (f_final, av_vels[(n_iters,)]) on ``f0``'s device.
    """
    _check_k(k)
    iters = params.max_iters if n_iters is None else n_iters
    mask = obstacles if obstacles.dtype == torch.uint8 else prepare_obstacles(obstacles)
    _, ny, nx = f0.shape
    n_fluid = (mask == 0).sum().to(torch.float32)
    bufs = step_kernel.buffers(f0, donate)
    passes, tail = divmod(iters, k)
    rows = max(1, min(chunk // k, passes))  # passes of partials per chunk
    partials = torch.empty((rows, k, num_tiles(ny, nx)), dtype=torch.float32,
                           device=f0.device)
    av = torch.empty(iters, dtype=torch.float32, device=f0.device)
    step_kernel._validate(bufs[0], mask, bufs[1], partials)

    with (profiling.span("lbm.ops.loop") as sp,
          torch.cuda.device(f0.device) if f0.is_cuda else contextlib.nullcontext()):
        before = launches
        one = _launcher(bufs[0], mask, params, k)
        for p in range(passes):
            one(bufs[p % 2], bufs[(p + 1) % 2], partials[p % rows])
            if (p + 1) % rows == 0 or p + 1 == passes:
                p0 = p - p % rows
                torch.sum(partials[: p + 1 - p0], dim=2,
                          out=av[p0 * k:(p + 1) * k].view(-1, k))
        sp.set(launches=launches - before)
    av[: passes * k] /= n_fluid
    f = bufs[passes % 2]
    if tail:
        f, av[passes * k:] = step_kernel.run(f, mask, params, n_iters=tail, donate=True,
                                             spare=bufs[(passes + 1) % 2])
    return f, av
