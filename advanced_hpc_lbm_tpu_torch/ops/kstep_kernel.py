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
one block per SM walks them (:func:`schedule`), each tile loaded with a
ghost ring K deep on every side (periodic wrap) into a ring of windows in
shared memory by a producer warpgroup, by one bulk tensor copy where the
window lies inside the grid (:func:`bulk_tiles`) and by wrapped copies
where it does not, and stepped K times by a team of consumer warps
(:func:`teams` a block); the plain version
builds the same windows with periodic index gathers and runs K calls of
:func:`kernel_common.lean_window_step` on them.  A pass writes the next
state out of place and one ||u|| partial per step and tile,
``partials[s, tile]``, tiles in row-major order.  On a grid of whole tiles,
a few a pass per SM (:func:`walks`), one launch walks a run's chunk of
passes (:func:`item`), each tile's window loading once the tiles it holds
(:func:`deps`) have stored the pass before.
"""

from __future__ import annotations

import collections
import contextlib

import torch

from advanced_hpc_lbm_tpu_torch.ops import kernel_common, lattice, library, loop, step_kernel
from advanced_hpc_lbm_tpu_torch.params import LBMParams

# Own cells of one tile (kTx, kTy in csrc/kstep_kernel.cu; _library()
# checks that the two agree).
TILE_X, TILE_Y = 32, 16
_library = library.checked(("lbm_kstep_tile_shape", (TILE_X, TILE_Y), "kernel tile"))

# The K the kernel is built for (the JAX kernel's range, pallas_k.py:135).
K_RANGE = range(2, 9)

# Kernel launches made by this module since the count was last reset, and
# the same launches by K (K = 2 is the port of pallas_multi's _kernel2).
launches = 0
launches_by_k: collections.Counter = collections.Counter()

prepare_obstacles = step_kernel.prepare_obstacles


def best_k(ny: int, nx: int) -> int:
    """The K of the ``pallask`` backend, from this port's times on an H100
    80GB HBM3 at 700 W (chip_smoke.py 3k, PERF.md, Findings): 4 up to
    256^2, where a pass is paced by its launch and more steps per launch
    pay (3.53 us per step at 64^2 against 3.57 at K = 3 and 3.95 at K = 5;
    3.95 at 128^2 against 5.05 and 3.98); 3 up to 8192^2, where the kernel
    is bound by instruction issue and device memory together and K = 3
    steps the narrowest ghost ring (1.20 cell steps per own one against
    1.31 at K = 4) with 3 teams' staged cells in registers (6.28 us per
    step at 512^2 against 6.79 at K = 4 and 7.54 at K = 5; 15.96 against
    18.81 at 1024^2; 200.02 against 225.91 at 4096^2; 827.3 against 888.8
    at 8192^2); 4 above, where device memory tells (3843.9 against 4732.7
    at 16384^2)."""
    cells = ny * nx
    return 4 if cells <= 256 * 256 else 3 if cells <= 8192 * 8192 else 4


def num_tiles(ny: int, nx: int) -> int:
    """Tiles of one pass: one ||u|| partial each per step."""
    return -(-ny // TILE_Y) * -(-nx // TILE_X)


def teams(k: int) -> int:
    """Consumer teams of 8 warps per block at K (``Shape<K>::kTeams``): 3 up
    to K = 3, where their staged cells fit 80 registers a thread, else 2."""
    return 3 if k <= 3 else 2


def bulk_tiles(ny: int, nx: int, k: int) -> int:
    """Tiles of one pass of the periodic (ny, nx) grid at K that the bulk
    tensor copy feeds: the kernel's rule (``lbm_kstep_bulk_tiles``).  Rows
    must be 16-byte multiples (nx % 4 == 0, buffers aligned as PyTorch
    allocates them), and the tile's window, K rows above and below and K
    rounded up to 4 columns left and right, must lie inside the grid; every
    other tile's window takes wrapped copies."""
    if nx % 4:
        return 0
    a = -(-k // 4) * 4
    h, w = TILE_Y + 2 * k, TILE_X + 2 * a
    rows = sum(1 for y0 in range(0, ny, TILE_Y) if 0 <= y0 - k and y0 - k + h <= ny)
    cols = sum(1 for x0 in range(0, nx, TILE_X) if 0 <= x0 - a and x0 - a + w <= nx)
    return rows * cols


def schedule(ny: int, nx: int, k: int, sms: int) -> list[list[int]]:
    """The tiles each consumer team takes in a pass on a card of ``sms``
    SMs, in order, team j of block b at [b * teams(k) + j]: one block per
    SM (fewer where there are fewer tiles), block b takes tiles b, b + grid,
    ..., and team j the block's n-th tiles for n = j, j + teams(k), ..."""
    tiles = num_tiles(ny, nx)
    grid = min(tiles, sms)
    out = []
    for b in range(grid):
        mine = list(range(b, tiles, grid))
        out += [mine[j::teams(k)] for j in range(teams(k))]
    return out


# A walk pays on grids of at most this many tiles a pass per SM
# (kWalkTilesPerSm in csrc/kstep_kernel.cu).
WALK_TILES_PER_SM = 16


def walks(ny: int, nx: int, sms: int | None = None) -> bool:
    """Whether one launch walks several passes on the (ny, nx) grid (its
    buffers aligned as PyTorch allocates them) on a card of ``sms`` SMs,
    the kernel's rule (``lbm_kstep_walks``): a grid of whole tiles, so that
    every cell a tile's window holds lies in the tile or the 8 around it,
    and at most WALK_TILES_PER_SM tiles a pass per SM, where saving a
    launch's start and tail outweighs what the flags cost each tile.
    Elsewhere a pass is a launch.  ``sms`` None: the grid's
    rule alone (the CPU's plain version has no SMs)."""
    whole = ny % TILE_Y == 0 and nx % TILE_X == 0
    return whole and (sms is None or num_tiles(ny, nx) <= WALK_TILES_PER_SM * sms)


def card_sms(device) -> int | None:
    """The SMs of a CUDA ``device``, None for another device."""
    device = torch.device(device)
    return (torch.cuda.get_device_properties(device).multi_processor_count
            if device.type == "cuda" else None)


def item(ny: int, nx: int, j: int) -> tuple[int, int]:
    """(pass, tile) of item j of a launch that walks its passes
    (``lbm_kstep_item``): pass i = j // tiles takes its tiles row-major
    from tile row i mod tiles_y on, so that pass i + 1 begins with tiles
    whose windows hold only tiles that pass i stored early.  Block b of
    the launch takes items b, b + grid, ... (:func:`schedule`)."""
    tx, ty = -(-nx // TILE_X), -(-ny // TILE_Y)
    i, pos = divmod(j, tx * ty)
    r, c = divmod(pos, tx)
    return i, (r + i) % ty * tx + c


def deps(ny: int, nx: int, t: int) -> list[int]:
    """The tiles whose flags tile t's window waits for in a walk (the
    kernel's ``wait_stored``): t and the 8 around it, wrapped (repeats on
    a grid under 3 tiles wide).  The relation is symmetric: they are also
    the tiles whose windows hold t's cells."""
    tx, ty = -(-nx // TILE_X), -(-ny // TILE_Y)
    r, c = divmod(t, tx)
    return [(r + dy) % ty * tx + (c + dx) % tx for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


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


def check_k(k: int) -> None:
    """Raise unless the kernel is built for K = ``k``."""
    if k not in K_RANGE:
        raise ValueError(f"K must be in 2..8, got {k}")


def prepare(device: torch.device | str, k: int) -> None:
    """Build and load the kernel library and load the kernel for K onto
    ``device`` without launching it."""
    check_k(k)
    library.on_device(device, lambda: _library().lbm_kstep_prepare(k),
                      f"loading the K={k} kernel")


def _launcher(f: torch.Tensor, mask: torch.Tensor, params: LBMParams, k: int):
    """A function ``(src, dst, partials) -> None`` that runs the next
    ``len(partials)`` passes of a run on tensors shaped like ``f``, ``src``
    into ``dst`` and back (``partials`` (n, k, tiles)): the kernel on CUDA,
    in one launch where the grid walks (:func:`walks`), else one a pass;
    the plain version pass by pass on the CPU.  Arguments are validated by
    the caller, once."""
    if f.device.type == "cpu":
        def one(src, dst, part):
            for i in range(part.shape[0]):
                plain_multi_step(src, mask, params, k, out=dst, partials=part[i])
                src, dst = dst, src
        return one
    if f.device.type != "cuda":
        raise ValueError(f"no K-step kernel for device {f.device}")
    lib = _library()
    _, ny, nx = f.shape
    consts = library.consts(params)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    mask_ptr = mask.data_ptr()
    # each tile's last stored pass of the run, counted from 1: a launch
    # walks its passes on from the run's passes before it
    flags = torch.zeros(num_tiles(ny, nx), dtype=torch.int32, device=f.device)
    done = 0
    walk_grid = walks(ny, nx, card_sms(f.device))

    def one(src, dst, part):
        global launches
        nonlocal done
        n = part.shape[0]
        err = lib.lbm_kstep(src.data_ptr(), dst.data_ptr(), mask_ptr, part.data_ptr(),
                            flags.data_ptr(), ny, nx, k, n, done, *consts, stream)
        library.check(err, f"K={k} kernel launch")
        walk = (walk_grid and src.data_ptr() % 16 == 0 and dst.data_ptr() % 16 == 0
                and mask_ptr % 4 == 0)
        done += n
        launches += 1 if walk else n
        launches_by_k[k] += 1 if walk else n
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
    ||u|| sums.  Launches the kernel (one pass) for a CUDA tensor, runs
    :func:`plain_multi_step` for a CPU one."""
    check_k(k)
    library.validate_pass(f, mask, out, partials, (k, num_tiles(*f.shape[1:])))
    with torch.cuda.device(f.device) if f.is_cuda else contextlib.nullcontext():
        _launcher(f, mask, params, k)(f, out, partials[None])


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
    mask = prepare_obstacles(obstacles)
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
    chunk: int = loop.CHUNK,
    donate: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the main loop at K steps per pass, ping-ponging two state
    buffers, a chunk of passes a launch where the grid walks
    (:func:`walks`); the last ``iters % k`` steps run on the step kernel in
    the same two buffers, as the JAX ``pallas_k.run`` and
    ``pallas_multi.run`` run them on the 1-step kernel.  ``f0`` is not
    modified, unless ``donate`` (see :func:`.library.buffers`).

    Returns (f_final, av_vels[(n_iters,)]) on ``f0``'s device; the span
    carries the passes a launch and counts the tiles fed by the bulk copy
    and by wrapped copies.
    """
    check_k(k)
    iters = params.max_iters if n_iters is None else n_iters
    mask = prepare_obstacles(obstacles)
    _, ny, nx = f0.shape
    bufs = library.buffers(f0, donate)
    library.validate(bufs[0], mask, bufs[1])
    passes = iters // k
    aligned = all(b.data_ptr() % 16 == 0 for b in bufs) and mask.data_ptr() % 4 == 0
    bulk = bulk_tiles(ny, nx, k) if aligned else 0
    walk = walks(ny, nx, card_sms(f0.device)) and aligned
    per = loop.chunk_passes(passes, k, chunk) if walk else 1
    return loop.run_passes(
        bufs, lambda: _launcher(bufs[0], mask, params, k), iters,
        (mask == 0).sum().to(torch.float32), tiles=num_tiles(ny, nx), counter=lambda: launches,
        steps=k, whole=True, chunk=chunk,
        tail=lambda f, spare, n: step_kernel.run(f, mask, params, n_iters=n, donate=True,
                                                 spare=spare),
        passes_per_launch=per,
        tiles_bulk=passes * bulk, tiles_wrap=passes * (num_tiles(ny, nx) - bulk))
