"""K = 8 timesteps per pass over a state in device memory, in place: the
streaming CUDA kernel, its wrapper and its plain PyTorch version.

The port's counterpart of ``advanced_hpc_lbm_tpu.ops.pallas_stream``
(``multi_step``, ``run``, ``make_padded_runner``, ``encode_masks``,
``mark_reduction_excluded``, ``window_ca_steps``, ``window_ca_steps_2d``
and the kernel ``_kernel``, whose step body is
``kernel_common.lean_window_step_rows``).  The TPU kernel's wrap-row
padded state and its tile-size search work around Mosaic's DMA and tiling
rules and have no counterpart: the CUDA kernel indexes any (ny, nx)
directly, with periodic wrap.

:func:`stream_pass` is the wrapper: on a CUDA tensor it launches
``csrc/stream_kernel.cu`` (a ghost snapshot, counted in
:data:`snapshot_launches`, then the pass, counted in :data:`launches`);
on a CPU tensor it runs :func:`plain_multi_step`.  A CUDA tensor never
falls back to the plain version: the launch happens or the wrapper raises.

The cell mask is encoded as data, one uint8 per cell: +1 obstacle
(:data:`OBSTACLE`), +2 forcing cell (:data:`FORCING`), +4 left out of the
||u|| sums (:data:`EXCLUDED`; the cell keeps its true dynamics).  Every
function here that takes ``obstacles`` reads a uint8 tensor as such an
encoded mask and a bool tensor as the plain obstacle mask of a periodic
grid, forced on row ny - 2 (:func:`prepare_obstacles`).

The kernel cuts the grid into tiles of SLAB rows by SEGMENT columns, each
walked by one block of a persistent grid; a pass writes one ||u|| partial
per step and tile, ``partials[s, slab * segments + segment]``.  In place
the device holds one state, the mask and a side buffer of ghost values
(:func:`side_bytes`, at most a quarter of a state on grids of 80 rows or
more).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from advanced_hpc_lbm_tpu_torch.ops import (
    kernel_common, lattice, library, loop, reference, step_kernel,
)
from advanced_hpc_lbm_tpu_torch.params import LBMParams

K = 8  # steps per pass = ghost depth
# Own rows and columns of a kernel block (kSlab, kSeg in
# csrc/stream_kernel.cu; _library() checks that the two agree).
SLAB, SEGMENT = 80, 1024
_library = library.checked(("lbm_stream_geometry", (K, SLAB, SEGMENT),
                            "kernel geometry (K, slab, segment)"))

OBSTACLE, FORCING, EXCLUDED = 1, 2, 4

CHUNK = loop.CHUNK

# Kernel launches made by this module since the counts were last reset:
# passes, and the ghost snapshots that precede them.
launches = 0
snapshot_launches = 0


def num_slabs(ny: int) -> int:
    return -(-ny // SLAB)


def num_segments(nx: int) -> int:
    return -(-nx // SEGMENT)


def num_tiles(ny: int, nx: int) -> int:
    """Tiles of one pass (kernel blocks): one ||u|| partial each per step."""
    return num_slabs(ny) * num_segments(nx)


def _snapshot_sizes(ny: int, nx: int) -> tuple[int, int]:
    """Floats per plane of the row snapshot (K rows above and below every
    slab) and of the column snapshot (K columns left and right of every
    segment)."""
    return num_slabs(ny) * 2 * K * nx, num_segments(nx) * ny * 2 * K


def side_bytes(ny: int, nx: int) -> int:
    """Device bytes of the ghost snapshot a pass needs beside the state:
    (2K / SLAB + 2K / SEGMENT) of a state, 21.6% on large grids."""
    return 4 * lattice.NSPEEDS * sum(_snapshot_sizes(ny, nx))


def tier_bytes(ny: int, nx: int) -> int:
    """Device bytes of an in-place :func:`run` with no tail: the one state
    buffer, the encoded mask, the ghost snapshot and a chunk of ||u||
    partials."""
    state = 4 * lattice.NSPEEDS * ny * nx
    partials = 4 * (CHUNK // K) * K * num_tiles(ny, nx)
    return state + ny * nx + side_bytes(ny, nx) + partials


def encode_masks(obstacles: torch.Tensor, accel_rows: torch.Tensor) -> torch.Tensor:
    """The kernel's uint8 mask: +1 obstacle, +2 on the rows that
    ``accel_rows`` ((ny,) bool) marks as forcing rows."""
    enc = (obstacles != 0).to(torch.uint8)
    enc |= accel_rows.to(torch.uint8)[:, None] * FORCING
    return enc.contiguous()


def mark_reduction_excluded(enc: torch.Tensor, excl: torch.Tensor) -> torch.Tensor:
    """Set the +4 flag where ``excl``: the cells keep their dynamics (the
    low bits) but leave the ||u|| partial sums."""
    return (enc | excl.to(torch.uint8) * EXCLUDED).contiguous()


def prepare_obstacles(obstacles: torch.Tensor) -> torch.Tensor:
    """The encoded mask of a periodic grid, forced on row ny - 2, on the
    device of ``obstacles`` (nonzero = blocked)."""
    ny = obstacles.shape[0]
    accel_rows = torch.arange(ny, device=obstacles.device) == ny - 2
    return encode_masks(obstacles, accel_rows)


def _encoded(obstacles: torch.Tensor) -> torch.Tensor:
    return obstacles if obstacles.dtype == torch.uint8 else prepare_obstacles(obstacles)


def fluid_cells(mask: torch.Tensor, block_cells: int = 1 << 24) -> torch.Tensor:
    """The cells of an encoded mask without +1, as a float32 scalar on its
    device.  Counted by blocks of rows: a sum over the whole grid would
    first copy the bool plane to int64, 9 bytes a cell beside the state."""
    ny, nx = mask.shape
    rows = max(1, block_cells // max(1, nx))
    n = sum(int(((mask[r:r + rows] & OBSTACLE) == 0).sum()) for r in range(0, ny, rows))
    return torch.tensor(float(n), dtype=torch.float32, device=mask.device)


def plain_multi_step(
    f: torch.Tensor,
    mask: torch.Tensor,
    params: LBMParams,
    *,
    out: torch.Tensor,
    partials: torch.Tensor,
    trapezoid: bool = False,
) -> None:
    """The kernel's pass in plain PyTorch, on any device: every slab's
    window (its SLAB rows and K rows above and below, wrapped, the whole
    width) at once, K steps of :func:`kernel_common.lean_window_step_rows`
    (``trapezoid``) or of :func:`kernel_common.lean_window_step`, then the
    own rows to ``out`` (which may be ``f``) and the per-step, per-tile
    ||u|| sums of own cells with neither +1 nor +4 to ``partials`` (K,
    tiles).  Both step forms compute the own rows bit for bit alike."""
    _, ny, nx = f.shape
    dev = f.device
    ns = num_slabs(ny)
    rows = (torch.arange(ns, device=dev)[:, None] * SLAB - K
            + torch.arange(SLAB + 2 * K, device=dev)) % ny  # (ns, T)
    T = rows.shape[1]
    src = f[:, rows, :]  # (9, ns, T, nx)
    dst = torch.empty_like(src)
    m = mask[rows, :]
    w_obst = (m & OBSTACLE) != 0
    accel = (m & FORCING) != 0
    own = slice(K, K + SLAB)
    inside = (torch.arange(ns, device=dev)[:, None] * SLAB
              + torch.arange(SLAB, device=dev) < ny)[:, :, None]
    counted = inside & ((m[:, own] & (OBSTACLE | EXCLUDED)) == 0)
    segs = num_segments(nx)
    for s in range(K):
        if trapezoid:
            lo, hi = s + 1, T - s - 1
            u_sq = kernel_common.lean_window_step_rows(src, dst, w_obst, accel, params,
                                                       T, nx, lo, hi)
            u_own = u_sq[:, K - lo:K - lo + SLAB]
        else:
            u_sq = kernel_common.lean_window_step(src, dst, w_obst, accel, params, T, nx)
            u_own = u_sq[:, own]
        norm = torch.where(counted, torch.sqrt(u_own), 0.0)
        norm = F.pad(norm, (0, segs * SEGMENT - nx))
        partials[s] = norm.reshape(ns, SLAB, segs, SEGMENT).sum(dim=(1, 3)).reshape(-1)
        src, dst = dst, src
    out.copy_(src[:, :, own].reshape(lattice.NSPEEDS, ns * SLAB, nx)[:, :ny])


def prepare(device: torch.device | str) -> None:
    """Build and load the kernel library and load the snapshot and stream
    kernels onto ``device`` without launching them."""
    library.on_device(device, lambda: _library().lbm_stream_prepare(),
                      "loading the stream kernel")


def _launcher(f: torch.Tensor, mask: torch.Tensor, params: LBMParams):
    """A function ``(src, dst, partials) -> None`` that runs one pass
    (``dst`` may be ``src``) on tensors shaped like ``f``: the snapshot and
    the kernel on CUDA, with a side buffer allocated here once; the plain
    version on the CPU.  Arguments are validated by the caller, once."""
    if f.device.type == "cpu":
        def one(src, dst, part):
            plain_multi_step(src, mask, params, out=dst, partials=part)
        return one
    if f.device.type != "cuda":
        raise ValueError(f"no stream kernel for device {f.device}")
    lib = _library()
    _, ny, nx = f.shape
    rows_n, cols_n = _snapshot_sizes(ny, nx)
    side = torch.empty(lattice.NSPEEDS * (rows_n + cols_n), dtype=torch.float32,
                       device=f.device)
    rows_ptr = side.data_ptr()
    cols_ptr = side[lattice.NSPEEDS * rows_n:].data_ptr()
    consts = library.consts(params)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    mask_ptr = mask.data_ptr()

    def one(src, dst, part):
        global launches, snapshot_launches
        err = lib.lbm_stream_snapshot(src.data_ptr(), rows_ptr, cols_ptr, ny, nx, stream)
        library.check(err, "stream snapshot launch")
        snapshot_launches += 1
        err = lib.lbm_stream(src.data_ptr(), dst.data_ptr(), mask_ptr, rows_ptr, cols_ptr,
                             part.data_ptr(), ny, nx, *consts, stream)
        library.check(err, "stream kernel launch")
        launches += 1
    one.side = side  # the side buffer lives as long as the launcher
    return one


def stream_pass(
    f: torch.Tensor,
    mask: torch.Tensor,
    params: LBMParams,
    *,
    out: torch.Tensor | None = None,
    partials: torch.Tensor,
) -> None:
    """K steps from ``f`` with the encoded ``mask``: in place when ``out``
    is None (or ``f``), else into ``out``; ``partials`` ((K,
    num_tiles(ny, nx)) float32) gets the per-step, per-tile ||u|| sums.
    Launches the kernel for a CUDA tensor, runs :func:`plain_multi_step`
    for a CPU one."""
    library.validate_pass(f, mask, None if out is None or out is f else out, partials,
                          (K, num_tiles(*f.shape[1:])))
    with torch.cuda.device(f.device) if f.is_cuda else contextlib.nullcontext():
        _launcher(f, mask, params)(f, f if out is None else out, partials)


def window_ca_steps(
    window: torch.Tensor,
    enc_ext: torch.Tensor,
    params: LBMParams,
    *,
    out: torch.Tensor,
    partials: torch.Tensor,
) -> torch.Tensor:
    """K steps of one shard of a 1-D ring from its (9, ly+2K, nx) ghost
    window (own rows [K, K+ly), K neighbour rows each side): one pass of
    the kernel out of place into ``out`` (a tensor shaped like the window),
    the window taken as a periodic grid.  Its y-wrap spoils only rows that
    the K steps give up, so the own rows of ``out`` are the shard's next
    state; the function returns them (a view).  ``enc_ext`` is the
    window's encoded mask with the ghost rows +4 (:data:`EXCLUDED`), so
    that ``partials`` ((K, num_tiles(ly+2K, nx))) sums own cells only.
    The counterpart of the JAX ``window_ca_steps``, which returns the
    summed partials where this one fills ``partials`` as every wrapper of
    the port does."""
    stream_pass(window, enc_ext, params, out=out, partials=partials)
    return out[:, K:-K]


def window_ca_steps_2d(
    window: torch.Tensor,
    enc_ext: torch.Tensor,
    params: LBMParams,
    *,
    out: torch.Tensor,
    partials: torch.Tensor,
) -> torch.Tensor:
    """:func:`window_ca_steps` on a shard of a 2-D torus: the (9, ly+2K,
    lx+2K) window also holds K ghost columns each side, which the x-wrap
    spoils only as deep as the steps give up.  On this card the ghost
    columns need no more than K: the JAX kernel's 64 ghost columns
    (``X_GHOST``) keep its window lane-aligned.  The ghost columns carry
    the neighbours' true +1/+2 bits and +4.  Returns the own block of
    ``out``."""
    stream_pass(window, enc_ext, params, out=out, partials=partials)
    return out[:, K:-K, K:-K]


def multi_step(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    n_fluid: torch.Tensor,
    params: LBMParams,
    *,
    inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance K timesteps in one pass; returns (f_next, av_k (K,)), like
    the JAX ``pallas_stream.multi_step``.  With ``inplace`` f_next is
    ``f``, advanced in its own storage."""
    mask = _encoded(obstacles)
    out = f if inplace else torch.empty_like(f)
    partials = torch.empty((K, num_tiles(*f.shape[1:])), dtype=torch.float32,
                           device=f.device)
    stream_pass(f, mask, params, out=out, partials=partials)
    return out, partials.sum(dim=1) / n_fluid


def run(
    f0: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    *,
    n_iters: int | None = None,
    inplace: bool = True,
    donate: bool = False,
    chunk: int = CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the main loop at K steps per pass, in one state buffer
    (``inplace``) or ping-ponging two; the last ``iters % K`` steps run on
    the step kernel, as the JAX ``pallas_stream.run`` runs them on the
    1-step kernel (a second state buffer then exists for those steps).
    ``f0`` is not modified, unless ``donate``: then the run starts in its
    storage (see :func:`.library.buffers`).

    Returns (f_final, av_vels[(n_iters,)]) on ``f0``'s device.
    """
    iters = params.max_iters if n_iters is None else n_iters
    mask = _encoded(obstacles)
    n_fluid = fluid_cells(mask)
    if inplace:
        f = f0 if donate else f0.clone(memory_format=torch.contiguous_format)
        if not f.is_contiguous():
            raise ValueError("a donated f0 must be contiguous")
        bufs = (f, f)
    else:
        bufs = library.buffers(f0, donate)
    library.validate(bufs[0], mask, *(() if inplace else bufs[1:]))
    _, ny, nx = f0.shape

    def tail(f, spare, n):
        return step_kernel.run(f, (mask & OBSTACLE).contiguous(), params, n_iters=n,
                               donate=True, spare=spare)

    return loop.run_passes(bufs, lambda: _launcher(bufs[0], mask, params), iters, n_fluid,
                           tiles=num_tiles(ny, nx),
                           counter=lambda: launches + snapshot_launches, steps=K,
                           chunk=chunk, tail=tail)


def refuse_tail(n_iters: int) -> None:
    """Raise unless ``n_iters`` is a whole number of passes: the step
    kernel's tail needs a second state buffer, which a grid that fits only
    the in-place tier cannot hold (the JAX padded-native tier's refusal)."""
    if n_iters % K:
        raise ValueError(
            f"the in-place single-buffer tier runs K={K} steps per pass and "
            f"needs n_iters % {K} == 0 (got {n_iters}); the 1-step tail kernel "
            "would need a second state buffer, which this grid size cannot "
            "hold beside the in-place one"
        )


def make_inplace_runner(
    obstacles: np.ndarray,
    params: LBMParams,
    *,
    n_iters: int,
    device: torch.device | str = "cuda",
):
    """:func:`run` in place from a state made on the device, with no tail:
    the counterpart of the JAX ``make_padded_runner``.

    Returns ``runner(f_init=None) -> (f, av)``, both on the device; the
    run starts from the equilibrium, or from a copy of ``f_init``, a host
    (9, ny, nx) float32 array.  ``runner.warmup()`` loads the kernel without
    launching it.
    """
    refuse_tail(n_iters)
    device = torch.device(device)
    mask = prepare_obstacles(torch.from_numpy(np.asarray(obstacles, dtype=bool))).to(device)

    def runner(f_init: np.ndarray | None = None):
        if f_init is None:
            f = reference.initial_state(params, device)
        elif f_init.shape != (lattice.NSPEEDS, params.ny, params.nx):
            raise ValueError(f"initial state {f_init.shape} != (9, {params.ny}, {params.nx})")
        else:
            f = torch.from_numpy(np.ascontiguousarray(f_init, np.float32)).to(device, copy=True)
        return run(f, mask, params, n_iters=n_iters, donate=True)

    runner.warmup = lambda: prepare(device)
    return runner
