"""The whole run in one launch per chunk: the banded and the cooperative
CUDA kernels, their wrapper and their plain PyTorch version.

The port's counterpart of ``advanced_hpc_lbm_tpu.ops.resident``
(``resident_run`` and its kernel ``_chunk_kernel``).  :func:`resident_run`
is the wrapper: on a CUDA tensor it launches ``csrc/resident_kernel.cu``
once per chunk of at most ``chunk`` steps; on a CPU tensor it runs
:func:`plain_run`, a loop of ``step_kernel.plain_step``.  The kernel has
two forms, chosen by the grid's shape before the launch (:func:`form_of`:
:func:`banded_fits` with the card's limits):

* the banded form, for grids whose band of 8 rows fits in shared memory
  (the small decks): blocks of a band's segment of columns keep their
  cells in shared memory for the whole chunk and meet only their
  neighbours, through edge values that carry their step, instead of a
  grid barrier; each launch adds one to :data:`banded_launches`;
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

import contextlib
import ctypes
import functools

import torch

from advanced_hpc_lbm_tpu_torch.ops import step_kernel
from advanced_hpc_lbm_tpu_torch.params import LBMParams
from advanced_hpc_lbm_tpu_torch.utils import profiling

# Steps per launch: bounds the partials buffer (16 MB at 1024x1024).
CHUNK = 1000

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
# csrc/resident_kernel.cu); the shared-memory rule bounds nx below it on an
# H100 (318 columns at 232 448 B).
BAND_MAX_COLS = 320

prepare_obstacles = step_kernel.prepare_obstacles


def prepare(device: torch.device | str) -> None:
    """Build and load the kernel library and load every form of the
    resident kernel onto ``device`` without launching them (setting their
    shared-memory limits); raises if the device takes no cooperative
    launches."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    lib = step_kernel._library()
    with torch.cuda.device(device):
        torch.zeros(1, device=device)  # create the context first
        step_kernel._raise_on(lib, lib.lbm_resident_prepare(), "loading the resident kernel")


def num_bands(ny: int) -> int:
    return -(-ny // BAND_ROWS)


def band_partition(ny: int) -> list[tuple[int, int, int, int]]:
    """The banded form's bands of an ny-row grid, as the kernel computes
    them: (first row, rows, band above, band below) each, the last band
    ragged when ny % 8 != 0, the neighbours wrapping periodically."""
    n = num_bands(ny)
    return [(b * BAND_ROWS, min(BAND_ROWS, ny - b * BAND_ROWS), (b - 1) % n, (b + 1) % n)
            for b in range(n)]


def band_smem_bytes(nx: int) -> int:
    """The shape rule's shared memory of one band: two ping-pong copies of
    its 9 planes over its 8 rows and 2 ghost rows (float32), and its 10
    mask rows (uint8).  A block of the kernel holds less: a segment of the
    band, at most 64 columns wide."""
    rows = BAND_ROWS + 2
    return 2 * 9 * rows * nx * 4 + rows * nx


def banded_fits(ny: int, nx: int, smem_bytes: int, max_bands: int) -> bool:
    """Whether the banded form takes an (ny, nx) grid on a card with
    ``smem_bytes`` of opt-in shared memory per block, where ``max_bands``
    bands nx wide can be co-resident (the banded kernel's occupancy x SMs,
    over the blocks a band needs at least: one per 64 columns); the C
    query ``lbm_resident_banded_fits`` is the same rule."""
    return (1 <= nx <= BAND_MAX_COLS and ny >= 1 and band_smem_bytes(nx) <= smem_bytes
            and num_bands(ny) <= max_bands)


@functools.cache
def _banded_limits(device_index: int, nx: int) -> tuple[int, int]:
    """(opt-in shared memory per block, bands nx wide that can be
    co-resident) on a CUDA device, from the kernel library."""
    lib = step_kernel._library()
    smem, bands = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        torch.zeros(1, device=f"cuda:{device_index}")  # create the context first
        step_kernel._raise_on(lib, lib.lbm_resident_banded_limits(
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
    lib = step_kernel._library()
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        torch.zeros(1, device=f"cuda:{device_index}")  # create the context first
        step_kernel._raise_on(lib, lib.lbm_resident_coop_limits(
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
    lib = step_kernel._library()
    _, ny, nx = f.shape
    consts = step_kernel._consts(params)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    mask_ptr = mask.data_ptr()

    form = form or form_of(ny, nx, f.device)
    if form == "banded":
        words = ctypes.c_longlong()
        step_kernel._raise_on(lib, lib.lbm_resident_banded_scratch(
            ny, nx, ctypes.byref(words)), "sizing the banded kernel's outbox")
        # the blocks' edge values of two steps, each with its step (the
        # launch resets it)
        outbox = torch.empty(words.value, dtype=torch.int64, device=f.device)

        def banded(bufs, n, part):
            global banded_launches
            err = lib.lbm_resident_banded_chunk(
                bufs[0].data_ptr(), bufs[1].data_ptr(), mask_ptr, part.data_ptr(),
                outbox.data_ptr(), ny, nx, n, blocks, *consts, stream)
            step_kernel._raise_on(lib, err, "resident kernel launch")
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
        step_kernel._raise_on(lib, err, "resident kernel launch")
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
    :func:`step_kernel.buffers`).

    Returns (f_final, av_vels[(n_iters,)]) on ``f0``'s device, like the
    JAX ``resident_run``.  The ``lbm.ops.loop`` span carries the form the
    grid runs in (:func:`form_of`), its bands and its ``nx`` and ``ny``.
    """
    iters = params.max_iters if n_iters is None else n_iters
    mask = obstacles if obstacles.dtype == torch.uint8 else prepare_obstacles(obstacles)
    _, ny, nx = f0.shape
    n_fluid = (mask == 0).sum().to(torch.float32)
    bufs = step_kernel.buffers(f0, donate)
    rows = max(1, min(chunk, iters))
    partials = torch.empty((rows, step_kernel.num_partials(ny, nx)),
                           dtype=torch.float32, device=f0.device)
    av = torch.empty(iters, dtype=torch.float32, device=f0.device)
    step_kernel._validate(bufs[0], mask, bufs[1], partials)

    form = form_of(ny, nx, f0.device)
    with (profiling.span("lbm.ops.loop", form=form, bands=num_bands(ny), nx=nx, ny=ny) as sp,
          torch.cuda.device(f0.device) if f0.is_cuda else contextlib.nullcontext()):
        before = launches + banded_launches
        run_chunk = _chunk_launcher(bufs[0], mask, params)
        for t0 in range(0, iters, rows):
            n = min(rows, iters - t0)
            # the chunk starts on the buffer that holds step t0's state
            run_chunk((bufs[t0 % 2], bufs[(t0 + 1) % 2]), n, partials)
            torch.sum(partials[:n], dim=1, out=av[t0:t0 + n])
        sp.set(launches=launches + banded_launches - before)
    av /= n_fluid
    return bufs[iters % 2], av
