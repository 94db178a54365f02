"""The whole run in one launch per chunk: the banded and the cooperative
CUDA kernels, their wrapper and their plain PyTorch version.

The port's counterpart of ``advanced_hpc_lbm_tpu.ops.resident``
(``resident_run`` and its kernel ``_chunk_kernel``).  :func:`resident_run`
is the wrapper: under :func:`.loop.run_passes`, on a CUDA tensor it
launches ``csrc/resident_kernel.cu`` once per chunk of at most ``chunk``
steps; on a CPU tensor it runs :func:`plain_run`, a loop of
``step_kernel.plain_step``.  The kernel has
two forms, chosen by the grid's shape before the launch (:func:`form_of`:
:func:`banded_fits` with the card's limits):

* the banded form, for the small decks (:func:`banded_fits`): blocks of a
  band's segment of columns keep their cells in shared memory for the
  whole chunk, with a ring of ghost cells D deep (:func:`banded_depth`),
  and meet only their neighbours, once every D steps, through edge values
  that carry their step, instead of a grid barrier; each launch adds one
  to :data:`banded_launches`;
* the cooperative form, for every other grid: a block owns tiles, segments
  of a band's windows of 128 columns (:func:`coop_segments` cuts bands
  only where there are fewer bands than co-resident blocks, so that a
  grid of few bands still fills the card), and steps them K steps per
  round (:func:`coop_k`) window by window in shared memory, on ghost cells
  that it reads from the neighbouring windows' state in the round's buffer
  once their step-tagged flags say it is there, again without a grid
  barrier; each launch adds one to :data:`launches`.  K = 3: 25.08 us per
  step at 1024^2, 6.96 at 512^2, 13.58 at 640x1024, 3.83 at 8x4096 on an
  H100 80GB HBM3 at 700 W (chip_smoke.py 3r; PERF.md, Findings), where a
  retired grid-barrier form took 40.65, 7.90, 23.37 and 3.98.

A CUDA tensor never falls back to another form or to the plain version:
the launch happens or the wrapper raises (a device without cooperative
launches, a grid too large to be co-resident, a failed launch).

Each step runs the step kernel's per-cell code and writes the step
kernel's per-tile ||u|| partials (32x8 tiles, row-major), so the state and
the av history equal the ``step`` backend's bit for bit in either form.
The JAX kernel keeps the state in VMEM and clamps a chunk to 1500 steps
for its SMEM budget; here the chunk only bounds the (chunk, tiles)
partials buffer.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from advanced_hpc_lbm_tpu_torch.ops import library, loop, step_kernel
from advanced_hpc_lbm_tpu_torch.params import LBMParams

# Steps per launch: bounds the partials buffer (16 MB at 1024x1024).
CHUNK = loop.CHUNK

# Kernel launches made by this module since the count was last reset: of
# the cooperative form and of the banded form.
launches = 0
banded_launches = 0

# The K (steps per round) the cooperative form is built for (with_coop_k in
# csrc/resident_kernel.cu).
COOP_K = (1, 2, 3, 4)
# Own columns of the cooperative form's window: 4 tiles.
COOP_WINDOW_COLS = 4 * step_kernel.BLOCK_X

# A band of the banded form is one row of the step kernel's tiles.
BAND_ROWS = step_kernel.BLOCK_Y
# The widest grid the banded form takes (kMaxBandCols in
# csrc/resident_kernel.cu).
BAND_MAX_COLS = 320
# A banded block: a segment of at most 2 tiles (64 columns) of a band,
# stepped with its ring by 512 threads (kMaxSegTiles, kBandThreads).
BAND_MAX_SEG_COLS = 2 * step_kernel.BLOCK_X
BAND_THREADS = BAND_MAX_SEG_COLS * BAND_ROWS

prepare_obstacles = step_kernel.prepare_obstacles
# both forms write the step kernel's partials, one per 32x8 tile
_library = library.checked(("lbm_step_block_shape", (step_kernel.BLOCK_X, step_kernel.BLOCK_Y),
                            "kernel tile"))


def prepare(device: torch.device | str) -> None:
    """Build and load the kernel library and load every form of the
    resident kernel onto ``device`` without launching them (setting their
    shared-memory limits); raises if the device takes no cooperative
    launches."""
    library.on_device(device, lambda: _library().lbm_resident_prepare(),
                      "loading the resident kernel")


def num_bands(ny: int) -> int:
    return -(-ny // BAND_ROWS)


def band_partition(ny: int) -> list[tuple[int, int, int, int]]:
    """The banded form's bands of an ny-row grid, as the kernel computes
    them: (first row, rows, band above, band below) each, the last band
    ragged when ny % 8 != 0, the neighbours wrapping periodically."""
    n = num_bands(ny)
    return [(b * BAND_ROWS, min(BAND_ROWS, ny - b * BAND_ROWS), (b - 1) % n, (b + 1) % n)
            for b in range(n)]


def band_depth(seg_w: int) -> int:
    """The exchange depth D of a banded block seg_w columns wide (32 or 64;
    ``band_depth`` in csrc/resident_kernel.cu, which builds one kernel for
    each): the steps between two exchanges with the neighbours, 4 for 32
    columns, 2 for 64, of D = 1 .. 6 the fastest, or within 1% of it, at
    64^2, 128^2 and 256x128 (32-column blocks: 1.33 us per step against
    1.77 at D = 1) and at 256^2 (64-column ones: 1.74 against 2.05) on an
    H100 80GB HBM3 at 700 W (scripts/torch_resident_variants.py; PERF.md,
    Findings)."""
    return 4 if seg_w == step_kernel.BLOCK_X else 2


def banded_geometry(ny: int, nx: int, sms: int) -> tuple[int, int, int]:
    """(seg_w, segs, D) of a banded launch on a card of ``sms`` SMs
    (``banded_geometry`` in csrc/resident_kernel.cu): a band's width cut
    into ``segs`` segments of ``seg_w`` columns (whole tiles, at most 2,
    the last segment ragged), as many as give each SM one block, and their
    exchange depth D, :func:`band_depth`.  On 132 SMs: 64^2 2 segments of
    32 columns, 128^2 and 256x128 4 of 32, 256^2 4 of 64."""
    tiles = -(-nx // step_kernel.BLOCK_X)
    least = -(-tiles // (BAND_MAX_SEG_COLS // step_kernel.BLOCK_X))
    target = max(min(sms // num_bands(ny), tiles), least)
    seg_tiles = -(-tiles // target)
    seg_w = seg_tiles * step_kernel.BLOCK_X
    return seg_w, -(-tiles // seg_tiles), band_depth(seg_w)


def banded_depth(ny: int, nx: int, sms: int) -> int:
    """The banded form's exchange depth D for an (ny, nx) grid on a card of
    ``sms`` SMs: a block meets its neighbours once every D steps (the C
    query ``lbm_resident_banded_depth`` is the same rule on the current
    device)."""
    return banded_geometry(ny, nx, sms)[2]


def band_seg_cols(nx: int) -> int:
    """The widest block of a band nx wide: its whole tiles, at most 64
    columns (``widest_segment`` in csrc/resident_kernel.cu)."""
    return min(-(-nx // step_kernel.BLOCK_X) * step_kernel.BLOCK_X, BAND_MAX_SEG_COLS)


def band_gather(depth: int, seg_w: int) -> int:
    """Ring values each thread of a banded block seg_w columns wide gathers
    a round, at most: 9 planes of the ring's D rows above and below (the
    corners included) and D columns either side, over 512 threads."""
    ring = 2 * depth * (seg_w + 2 * depth) + 2 * BAND_ROWS * depth
    return -(-9 * ring // BAND_THREADS)


def band_smem_bytes(nx: int) -> int:
    """The shape rule's shared memory: that of the widest block of a band
    nx wide, at its exchange depth D = :func:`band_depth`
    (``lbm_resident_banded_smem``): the ||u|| of two rounds of D steps of
    its 8 x seg_w cells (float32), the table of its threads' ring values
    (two int32 a value), two ping-pong copies of its 9 planes over its
    cells and ring, (8 + 2D) x (seg_w + 2D) float32, and the mask of the
    same cells (uint8).  A block of a narrower segment, which a launch runs
    only where it has an SM to each block, is smaller."""
    seg_w = band_seg_cols(nx)
    depth = band_depth(seg_w)
    cells = (BAND_ROWS + 2 * depth) * (seg_w + 2 * depth)
    return (4 * (2 * depth * BAND_ROWS * seg_w + 2 * 9 * cells)
            + 4 * 2 * band_gather(depth, seg_w) * BAND_THREADS + cells)


def banded_rounds(n_steps: int, depth: int) -> int:
    """Rounds (exchanges) of a banded launch of n_steps steps at depth D:
    rounds of D steps and a last one of n mod D."""
    return -(-n_steps // depth)


def banded_fits(ny: int, nx: int, smem_bytes: int, max_bands: int) -> bool:
    """Whether the banded form takes an (ny, nx) grid on a card with
    ``smem_bytes`` of opt-in shared memory per block, where ``max_bands``
    bands nx wide can be co-resident (the banded kernel's occupancy x SMs,
    over the blocks a band needs at least: one per 64 columns): a block of
    the widest segment fits the card, and every band is co-resident; the
    C query ``lbm_resident_banded_fits`` is the same rule."""
    return (1 <= nx <= BAND_MAX_COLS and ny >= 1
            and band_smem_bytes(nx) <= smem_bytes
            and num_bands(ny) <= max_bands)


@functools.cache
def _banded_limits(device_index: int, nx: int) -> tuple[int, int]:
    """(opt-in shared memory per block, bands nx wide that can be
    co-resident) on a CUDA device, from the kernel library."""
    smem, bands = ctypes.c_int(), ctypes.c_int()
    library.on_device(f"cuda:{device_index}", lambda: _library().lbm_resident_banded_limits(
        nx, ctypes.byref(smem), ctypes.byref(bands)), "querying the banded kernel")
    return smem.value, bands.value


def takes_banded(ny: int, nx: int, device: torch.device | str) -> bool:
    """Whether a CUDA device runs an (ny, nx) grid on the banded form (the
    cooperative form otherwise).  False off CUDA, where the plain version
    runs."""
    device = torch.device(device)
    if device.type != "cuda":
        return False
    index = device.index if device.index is not None else torch.cuda.current_device()
    return banded_fits(ny, nx, *_banded_limits(index, nx))


def coop_k(ny: int, nx: int) -> int:
    """The cooperative form's steps per round for an (ny, nx) grid (the C
    query ``lbm_resident_coop_k`` is the same rule): 3 on every grid, from
    this port's times on an H100 80GB HBM3 at 700 W (chip_smoke.py 3r,
    PERF.md, Findings): at 768^2, 1024^2, 2048^2 and 4096^2 K = 3 is the
    fastest of 1..4 (25.43 us per step at 1024^2 against 39.27, 28.99 and
    26.75), at 512^2 as fast as K = 4."""
    return 3


def form_of(ny: int, nx: int, device: torch.device | str) -> str:
    """The form a CUDA device runs an (ny, nx) grid in: "banded" or
    "cooperative"; "plain" off CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return "plain"
    return "banded" if takes_banded(ny, nx, device) else "cooperative"


def coop_smem_bytes(k: int) -> int:
    """Dynamic shared memory of a cooperative block at K = k: two windows
    (9 float32 planes and the mask bytes, rounded up to 16, of 8 + 2K rows
    by 128 own columns and 4 ghost columns a side) and the ||u|| of K steps
    of the own cells."""
    rows, pitch = BAND_ROWS + 2 * k, COOP_WINDOW_COLS + 8
    window = 4 * 9 * rows * pitch + -(-rows * pitch // 16) * 16
    return 2 * window + 4 * k * BAND_ROWS * COOP_WINDOW_COLS


def coop_windows(nx: int) -> int:
    """Windows of 128 columns across a grid nx wide, the last one ragged."""
    return -(-nx // COOP_WINDOW_COLS)


def coop_flag_words(ny: int, nx: int) -> int:
    """64-bit words of the cooperative form's outbox: one flag per band
    and window of 128 columns, carrying the step whose state the band's
    window holds in the round's buffer."""
    return num_bands(ny) * coop_windows(nx)


def coop_rounds(n_steps: int, k: int) -> list[int]:
    """The steps of each round of a chunk at K = k: rounds of K and a last
    one of n mod K, with one round split in two where that makes the
    number of rounds as even as n_steps, so that the state ends in the
    buffer the caller expects (coop_round_steps in
    csrc/resident_kernel.cu)."""
    if n_steps == 0:
        return []
    rounds = -(-n_steps // k)
    tail = n_steps - k * (rounds - 1)
    steps = [k] * (rounds - 1) + [tail]
    if rounds % 2 != n_steps % 2:
        if tail >= 2:
            steps[-1:] = [tail - 1, 1]
        else:
            steps[-2:] = [k - 1, 1, 1]
    return steps


def coop_segments(ny: int, nx: int, blocks: int) -> int:
    """Segments per band of the cooperative form on ``blocks`` co-resident
    blocks (the C query ``lbm_resident_coop_segments`` is the same rule).
    A tile, the unit a block owns, is a segment: a run of ceil(windows /
    segs) consecutive windows of a band, the last one ragged.  Where there
    are at least as many bands as blocks, one segment: every block has a
    band.  Else the count that makes the most windows a block steps per
    round, ceil(bands * segs / blocks) * ceil(windows / segs), least; on a
    tie the fewest segments, whose edges make windows wait for column
    neighbours.  On 132 blocks: 1 at 1024^2 (128 bands), 2048^2 and 4096^2;
    2 at 512^2 (2 windows a block), 8 at 640x1024 (5), 3 at 672x1024 (6)."""
    bands, windows = num_bands(ny), coop_windows(nx)
    if bands >= blocks:
        return 1
    best, most = 1, windows
    for segs in range(2, windows + 1):
        m = -(-bands * segs // blocks) * -(-windows // segs)
        if m < most:
            best, most = segs, m
    return best


def coop_tiles(ny: int, nx: int, segs: int) -> list[tuple[int, int, int]]:
    """The tiles of a cooperative launch in band-major order: (band, first
    window, end window) each, ``segs`` segments of ceil(windows / segs)
    windows per band, the last one ragged."""
    windows = coop_windows(nx)
    width = -(-windows // segs)
    return [(q, c, min(c + width, windows))
            for q in range(num_bands(ny)) for c in range(0, windows, width)]


def coop_blocks(ny: int, nx: int, max_blocks: int) -> int:
    """The blocks of a cooperative launch: one per tile, no more than
    ``max_blocks`` (those that can be co-resident)."""
    return min(num_bands(ny) * coop_segments(ny, nx, max_blocks), max_blocks)


def coop_assignment(ny: int, nx: int, segs: int,
                    blocks: int) -> list[list[tuple[int, int, int]]]:
    """The tiles (see :func:`coop_tiles`) each block of a cooperative launch
    of ``blocks`` blocks owns: block b takes tiles b, b + blocks, ... (a
    block past the last tile owns none and returns at once)."""
    return [coop_tiles(ny, nx, segs)[b::blocks] for b in range(blocks)]


@functools.cache
def _coop_limits(device_index: int, k: int) -> tuple[int, int]:
    """(dynamic shared memory of a block, blocks that can be co-resident)
    of the cooperative form at K = k on a CUDA device, from the kernel
    library."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    library.on_device(f"cuda:{device_index}", lambda: _library().lbm_resident_coop_limits(
        k, ctypes.byref(smem), ctypes.byref(blocks)), f"preparing the K={k} resident kernel")
    return smem.value, blocks.value


def plain_run(
    bufs: tuple[torch.Tensor, torch.Tensor],
    mask: torch.Tensor,
    params: LBMParams,
    n_steps: int,
    partials: torch.Tensor,
) -> None:
    """One chunk in plain PyTorch: ``n_steps`` plain steps on the state in
    ``bufs[0]``, ping-ponging with ``bufs[1]`` (the state ends in
    ``bufs[n_steps % 2]``), partials row t for step t, as the kernel."""
    for t in range(n_steps):
        step_kernel.plain_step(bufs[t % 2], mask, params,
                               out=bufs[(t + 1) % 2], partials=partials[t])


def _chunk_launcher(f: torch.Tensor, mask: torch.Tensor, params: LBMParams,
                    blocks: int = 0, form: str | None = None, k: int | None = None):
    """A function ``(bufs, n_steps, partials) -> None`` that runs one chunk
    on tensors shaped like ``f``: the kernel on CUDA (the form the shape
    takes, :func:`form_of`), the plain version on the CPU.  Test
    hooks, which ``resident_run`` never passes: ``blocks`` > 0 sets the
    grid size (otherwise one block per band and segment, or per tile, no
    more than can be co-resident): fewer cooperative blocks own several
    tiles each, and a grid too large to be co-resident is the only way to
    make the card refuse a launch; ``form`` ("banded" or "cooperative")
    runs that form on any grid the kernel takes; ``k`` sets the
    cooperative form's steps per round."""
    if f.device.type == "cpu":
        return lambda bufs, n, part: plain_run(bufs, mask, params, n, part)
    if f.device.type != "cuda":
        raise ValueError(f"no resident kernel for device {f.device}")
    if form not in (None, "banded", "cooperative"):
        raise ValueError(f"unknown form {form!r}")
    lib = _library()
    _, ny, nx = f.shape
    consts = library.consts(params)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    mask_ptr = mask.data_ptr()

    form = form or form_of(ny, nx, f.device)
    if form == "banded":
        words = ctypes.c_longlong()
        library.check(lib.lbm_resident_banded_scratch(ny, nx, ctypes.byref(words)),
                      "sizing the banded kernel's outbox")
        # the blocks' edge values of two steps, each with its step (the
        # launch resets it)
        outbox = torch.empty(words.value, dtype=torch.int64, device=f.device)

        def banded(bufs, n, part):
            global banded_launches
            err = lib.lbm_resident_banded_chunk(
                bufs[0].data_ptr(), bufs[1].data_ptr(), mask_ptr, part.data_ptr(),
                outbox.data_ptr(), ny, nx, n, blocks, *consts, stream)
            library.check(err, "resident kernel launch")
            banded_launches += 1
        return banded

    k = coop_k(ny, nx) if k is None else k
    if k not in COOP_K:
        raise ValueError(f"K must be one of {COOP_K}, got {k}")
    # a flag per band and window: the step its state in the round's buffer
    # belongs to (the launch resets them)
    flags = torch.empty(coop_flag_words(ny, nx), dtype=torch.int64, device=f.device)

    def chunk(bufs, n, part):
        global launches
        err = lib.lbm_resident_chunk(bufs[0].data_ptr(), bufs[1].data_ptr(), mask_ptr,
                                     part.data_ptr(), flags.data_ptr(), ny, nx, n, blocks, k,
                                     *consts, stream)
        library.check(err, "resident kernel launch")
        launches += 1
    return chunk


def resident_run(
    f0: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    *,
    n_iters: int | None = None,
    chunk: int = CHUNK,
    donate: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the whole main loop, one launch per chunk of at most ``chunk``
    steps.  ``f0`` is not modified, unless ``donate`` (see
    :func:`.library.buffers`).

    Returns (f_final, av_vels[(n_iters,)]) on ``f0``'s device, like the
    JAX ``resident_run``.  The ``lbm.ops.loop`` span carries the form the
    grid runs in (:func:`form_of`), its bands, its ``nx`` and ``ny``, the
    steps between two exchanges with the neighbours (``depth``: the banded
    form's D, the cooperative form's K, 1 for the plain version's steps)
    and the exchanges of the run (``rounds``).
    """
    iters = params.max_iters if n_iters is None else n_iters
    mask = prepare_obstacles(obstacles)
    _, ny, nx = f0.shape
    bufs = library.buffers(f0, donate)
    library.validate(bufs[0], mask, bufs[1])

    form = form_of(ny, nx, f0.device)
    rows = max(1, min(chunk, iters))
    chunks = [min(rows, iters - t0) for t0 in range(0, iters, rows)]
    if form == "cooperative":
        depth = coop_k(ny, nx)
        rounds = sum(len(coop_rounds(n, depth)) for n in chunks)
    else:
        depth = 1 if form == "plain" else banded_depth(
            ny, nx, torch.cuda.get_device_properties(f0.device).multi_processor_count)
        rounds = sum(banded_rounds(n, depth) for n in chunks)

    def launcher():
        run_chunk = _chunk_launcher(bufs[0], mask, params)
        return lambda src, dst, part: run_chunk((src, dst), len(part), part)

    return loop.run_passes(bufs, launcher, iters, (mask == 0).sum().to(torch.float32),
                           tiles=step_kernel.num_partials(ny, nx),
                           counter=lambda: launches + banded_launches, whole=True, chunk=chunk,
                           form=form, bands=num_bands(ny), nx=nx, ny=ny, depth=depth,
                           rounds=rounds)
