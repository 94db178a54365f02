"""The resident kernel's wrapper on the CPU (its plain PyTorch version, a
loop of the step kernel's plain step) against the JAX package's
VMEM-resident whole-run kernel in interpret mode, and against the port's
own step run.

Tolerances: f within rtol 1e-5 / atol 1e-7 and av within rtol 1e-5 against
the JAX kernel (both reduce ||u|| over the pre-collision moments, in
another summation order).  From rest, u is a difference of nearly equal
values, which turns the last-place differences of XLA's CPU arithmetic
into ~2e-5 of av: there av is held to rtol 1e-4, the trajectory tolerance
of tests/test_pallas.py.  Bitwise against the port's step run, whose
per-cell math and per-tile partials the resident kernel shares.  The card
itself is covered by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_hpc_lbm_tpu.ops import reference as jref
from advanced_hpc_lbm_tpu.ops import resident as jresident
from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu_torch.ops import resident, step_kernel
from advanced_hpc_lbm_tpu_torch.params import LBMParams

F_TOL = dict(rtol=1e-5, atol=1e-7)
AV_RTOL = 1e-5


def make_deck(ny=32, nx=128, seed=5, perturb=False, guard_fail=False):
    """tests/test_resident.py's 32x128 deck (from rest), or any shape with
    a state perturbed in numpy: equilibrium x uniform(0.8, 1.2)."""
    jp = JaxParams(nx=nx, ny=ny, max_iters=17, reynolds_dim=10,
                   density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[ny // 3: ny // 3 + 2, nx // 3: nx // 2] = True
    for _ in range(4):
        mask[rng.randint(1, ny - 1), rng.randint(0, nx)] = True
    f0 = np.asarray(jref.initial_state(jp))
    if perturb:
        f0 = f0 * rng.uniform(0.8, 1.2, (9, ny, nx)).astype(np.float32)
    if guard_fail:
        f0[3, ny - 2, : nx // 2] = jp.accel_w1 * np.float32(0.5)
    return jp, mask, f0


def port_run(jp, mask, f0, n, **kw):
    f, av = resident.resident_run(torch.from_numpy(f0.copy()), torch.from_numpy(mask),
                                  LBMParams.from_jax(jp), n_iters=n, **kw)
    return f.numpy(), av.numpy()


@pytest.mark.parametrize("n,chunk", [(17, 6), (8, 8)], ids=["chunks-odd-tail", "one-chunk"])
@pytest.mark.parametrize("perturb", [False, True], ids=["from-rest", "perturbed"])
def test_matches_jax_resident_kernel(n, chunk, perturb):
    jp, mask, f0 = make_deck(perturb=perturb)
    fa, ava = jresident.resident_run(jnp.asarray(f0), jnp.asarray(mask), jp, n_iters=n,
                                     chunk=chunk, interpret=True)
    fb, avb = port_run(jp, mask, f0, n, chunk=chunk)
    assert avb.shape == (n,)
    np.testing.assert_allclose(fb, np.asarray(fa), **F_TOL)
    np.testing.assert_allclose(avb, np.asarray(ava), rtol=AV_RTOL if perturb else 1e-4)


@pytest.mark.parametrize("ny,nx", [(17, 23), (100, 130), (8, 32)])
@pytest.mark.parametrize("n,chunk", [(17, 6), (5, 1000)])
def test_any_shape_matches_step_run_bitwise(ny, nx, n, chunk):
    """Shapes the JAX kernel refuses: f and the av history equal the step
    run's bit for bit (same per-cell code, same per-tile partials, summed
    per chunk of the same length)."""
    jp, mask, f0 = make_deck(ny, nx, seed=ny, perturb=True, guard_fail=True)
    fb, avb = port_run(jp, mask, f0, n, chunk=chunk)
    fs, avs = step_kernel.run(torch.from_numpy(f0), torch.from_numpy(mask),
                              LBMParams.from_jax(jp), n_iters=n, chunk=chunk)
    np.testing.assert_array_equal(fb, fs.numpy())
    np.testing.assert_array_equal(avb, avs.numpy())


def test_plain_run_ping_pongs_and_writes_step_partials():
    jp, mask, f0 = make_deck(17, 23, perturb=True)
    p = LBMParams.from_jax(jp)
    m = step_kernel.prepare_obstacles(torch.from_numpy(mask))
    bufs = (torch.from_numpy(f0.copy()), torch.empty(f0.shape))
    part = torch.empty(3, step_kernel.num_partials(17, 23))
    resident.plain_run(bufs, m, p, 3, part)
    f, want = torch.from_numpy(f0.copy()), []
    for _ in range(3):
        out, sp = torch.empty(f0.shape), torch.empty(step_kernel.num_partials(17, 23))
        step_kernel.plain_step(f, m, p, out=out, partials=sp)
        f = out
        want.append(sp)
    np.testing.assert_array_equal(bufs[1].numpy(), f.numpy())  # 3 steps end in bufs[1]
    np.testing.assert_array_equal(part.numpy(), torch.stack(want).numpy())


def test_zero_steps_and_f0_untouched():
    jp, mask, f0 = make_deck(16, 32, perturb=True)
    f_in = torch.from_numpy(f0.copy())
    f, av = resident.resident_run(f_in, torch.from_numpy(mask), LBMParams.from_jax(jp),
                                  n_iters=0)
    assert av.shape == (0,)
    np.testing.assert_array_equal(f.numpy(), f0)
    port_run(jp, mask, f0, 4)
    np.testing.assert_array_equal(f_in.numpy(), f0)


def test_cpu_run_counts_no_launch():
    """On the CPU the plain version runs: no form of the kernel launches."""
    assert not resident.takes_banded(16, 32, "cpu")
    assert resident.form_of(1024, 1024, "cpu") == "plain"
    jp, mask, f0 = make_deck(16, 32)
    before = (resident.launches, resident.banded_launches)
    port_run(jp, mask, f0, 3)
    assert (resident.launches, resident.banded_launches) == before


def test_prepare_builds_nothing_on_cpu(monkeypatch):
    from advanced_hpc_lbm_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "build", lambda: pytest.fail("built on the CPU"))
    resident.prepare("cpu")


# ---- the banded form's shape rule and band partition ---------------------------

H100_SMEM = 232_448  # opt-in shared memory per block
H100_BANDS = 132  # bands that can be co-resident: 132 SMs x 1 block each


def h100_bands(nx: int) -> int:
    """Bands nx wide that an H100 holds at once: one block an SM, a band
    needing a block per 64 columns (lbm_resident_banded_limits)."""
    return H100_BANDS // -(-nx // resident.BAND_MAX_SEG_COLS)


@pytest.mark.parametrize("ny,nx,banded", [
    (64, 64, True), (128, 128, True), (128, 256, True), (256, 128, True), (256, 256, True),
    (8, 32, True), (17, 23, True), (512, 512, False), (1024, 1024, False), (64, 320, True),
    (256, 318, False), (256, 319, False), (208, 320, True), (216, 320, False), (64, 321, False),
])
def test_banded_rule_at_h100_limits(ny, nx, banded):
    """The reference's small decks and the mini deck go to the banded form;
    512^2, 1024^2 and any grid wider than 320 columns do not, nor one with
    more bands than the card holds at once (26 bands of 257-320 columns,
    each cut into 5 blocks).  A block holds at most 64 columns of its band,
    so its shared memory bounds no width."""
    assert resident.banded_fits(ny, nx, H100_SMEM, h100_bands(nx)) is banded


@pytest.mark.parametrize("ny,max_bands,banded", [
    (1056, H100_BANDS, True), (1057, H100_BANDS, False), (64, 8, True), (65, 8, False),
    (8, 1, True), (9, 1, False), (1, 0, False),
])
def test_banded_rule_needs_every_band_co_resident(ny, max_bands, banded):
    assert resident.banded_fits(ny, 64, H100_SMEM, max_bands) is banded


def test_band_smem_bytes():
    """The widest block of a band, at its depth.  64 columns at D = 2: two
    rounds' ||u|| (2 x 2 x 8 x 64 floats), the ring table (6 values a
    thread, two ints each, 512 threads), two copies of 9 planes over 12 x
    68 cells, their mask.  32 columns at D = 4: 2 x 4 x 8 x 32 floats, 7
    values a thread, 16 x 40 cells.  The narrower block is the smaller, and
    both fit an H100."""
    assert resident.band_smem_bytes(64) == (4 * 2 * 2 * 8 * 64 + 4 * 2 * 9 * 12 * 68
                                            + 4 * 2 * 6 * 512 + 12 * 68) == 92_336
    assert resident.band_smem_bytes(32) == (4 * 2 * 4 * 8 * 32 + 4 * 2 * 9 * 16 * 40
                                            + 4 * 2 * 7 * 512 + 16 * 40) == 83_584
    assert resident.band_smem_bytes(256) == resident.band_smem_bytes(320) == 92_336
    assert resident.band_smem_bytes(23) == resident.band_smem_bytes(32)
    assert resident.band_smem_bytes(32) < resident.band_smem_bytes(64) <= H100_SMEM


@pytest.mark.parametrize("seg_w,depth", [(32, 4), (64, 2)])
def test_band_depth(seg_w, depth):
    """The exchange depth of each banded kernel: 4 steps a round for blocks
    of 32 columns, 2 for blocks of 64."""
    assert resident.band_depth(seg_w) == depth


@pytest.mark.parametrize("depth,seg_w,values", [
    (1, 32, 2), (1, 64, 3), (2, 64, 6), (3, 64, 9), (4, 32, 7), (4, 64, 12),
])
def test_band_gather(depth, seg_w, values):
    """Ring values a thread gathers a round: 9 x (2D (seg_w + 2D) + 16 D)
    over 512 threads, rounded up."""
    assert resident.band_gather(depth, seg_w) == values


@pytest.mark.parametrize("ny,nx,geometry", [
    (64, 64, (32, 2, 4)), (128, 128, (32, 4, 4)), (256, 128, (32, 4, 4)),
    (256, 256, (64, 4, 2)), (8, 32, (32, 1, 4)), (17, 23, (32, 1, 4)), (19, 99, (32, 4, 4)),
    (1001, 50, (64, 1, 2)), (1056, 64, (64, 1, 2)), (208, 320, (64, 5, 2)),
])
def test_banded_geometry_and_depth_rule(ny, nx, geometry):
    """(segment columns, segments, D) on an H100's 132 SMs: one block an
    SM where the grid leaves SMs to spare, blocks of 32 columns stepping
    4 steps a round and blocks of 64 columns 2; the reference's small
    decks and the mini deck meet their neighbours less often than once a
    step."""
    assert resident.banded_geometry(ny, nx, H100_BANDS) == geometry
    assert resident.banded_depth(ny, nx, H100_BANDS) == geometry[2] == resident.band_depth(
        geometry[0])
    seg_w, segs, _ = geometry
    assert seg_w <= resident.band_seg_cols(nx) and (segs - 1) * seg_w < nx <= segs * seg_w


@pytest.mark.parametrize("n,depth,rounds", [
    (1000, 4, 250), (1000, 3, 334), (17, 4, 5), (3, 4, 1), (0, 4, 0), (5, 1, 5),
])
def test_banded_rounds(n, depth, rounds):
    """Rounds of D steps and a last one of n mod D: one exchange each."""
    assert resident.banded_rounds(n, depth) == rounds


@pytest.mark.parametrize("ny,bands", [
    (17, [(0, 8, 2, 1), (8, 8, 0, 2), (16, 1, 1, 0)]),  # ragged last band
    (8, [(0, 8, 0, 0)]),  # one band: its own neighbour both ways
    (5, [(0, 5, 0, 0)]),
    (16, [(0, 8, 1, 1), (8, 8, 0, 0)]),  # two bands: each the other's neighbour
    (32, [(0, 8, 3, 1), (8, 8, 0, 2), (16, 8, 1, 3), (24, 8, 2, 0)]),
])
def test_band_partition(ny, bands):
    """(first row, rows, band above, band below): the step kernel's tile
    rows, wrapping periodically."""
    assert resident.band_partition(ny) == bands
    assert resident.num_bands(ny) == len(bands)
    assert sum(h for _, h, _, _ in bands) == ny


# ---- the cooperative form's rules ------------------------------------------------


@pytest.mark.parametrize("ny,nx", [(512, 512), (768, 768), (1024, 1024), (2048, 2048),
                                   (4096, 4096), (17, 23), (100, 130)])
def test_coop_k_rule(ny, nx):
    """One K per shape, decided before the launch, among those built."""
    k = resident.coop_k(ny, nx)
    assert k in resident.COOP_K and k == 3


@pytest.mark.parametrize("k,smem", [(1, 104_736), (2, 128_960), (3, 153_184), (4, 177_408)])
def test_coop_smem_bytes_fit_an_h100(k, smem):
    """Two windows of 8 + 2K rows by 128 own columns and 4 ghost columns a
    side (9 float32 planes and the mask rounded up to 16) and K x 8 x 128
    ||u|| values: within the H100's 232 448 B of opt-in shared memory at
    every built K."""
    assert resident.coop_smem_bytes(k) == smem <= H100_SMEM


@pytest.mark.parametrize("ny,nx,words", [
    (1024, 1024, 128 * 8), (4096, 4096, 512 * 32), (17, 23, 3 * 1), (8, 32, 1),
    (100, 130, 13 * 2), (256, 512, 32 * 4),
])
def test_coop_flag_words(ny, nx, words):
    """The outbox: one 64-bit flag per band (a ragged one too) and window
    of 128 columns (a ragged one too)."""
    assert resident.coop_flag_words(ny, nx) == words


@pytest.mark.parametrize("n,k,steps", [
    (17, 4, [4, 4, 4, 4, 1]), (6, 4, [4, 2]), (5, 4, [3, 1, 1]), (6, 2, [2, 2, 1, 1]),
    (1000, 3, [3] * 332 + [3, 1]), (1000, 2, [2] * 500), (3, 2, [1, 1, 1]), (1, 3, [1]),
    (0, 2, []), (7, 1, [1] * 7),
])
def test_coop_rounds(n, k, steps):
    """Rounds of K steps and a last one of n mod K, one round split in two
    where the count's parity differs from n's: the state ends in the
    buffer of the caller's contract (a for an even n, b for an odd one)."""
    assert resident.coop_rounds(n, k) == steps


@pytest.mark.parametrize("k", resident.COOP_K)
def test_coop_rounds_keep_the_parity(k):
    for n in range(200):
        steps = resident.coop_rounds(n, k)
        assert sum(steps) == n and all(1 <= s <= k for s in steps)
        assert len(steps) % 2 == n % 2 and len(steps) <= -(-n // k) + 1


@pytest.mark.parametrize("ny,nx,segs,blocks,owned", [
    (8, 64, 1, 132, [[(0, 0, 1)]] + [[]] * 131),  # one band: its own neighbour both ways
    (5, 64, 1, 1, [[(0, 0, 1)]]),
    (16, 64, 1, 132, [[(0, 0, 1)], [(1, 0, 1)]] + [[]] * 130),  # two bands
    (17, 64, 1, 132, [[(0, 0, 1)], [(1, 0, 1)], [(2, 0, 1)]] + [[]] * 129),  # the last one row
    (64, 64, 1, 3, [[(0, 0, 1), (3, 0, 1), (6, 0, 1)], [(1, 0, 1), (4, 0, 1), (7, 0, 1)],
                    [(2, 0, 1), (5, 0, 1)]]),  # a block owns several bands
    (64, 64, 1, 1, [[(q, 0, 1) for q in range(8)]]),
    (4096, 4096, 1, 132, [[(q, 0, 32) for q in range(b, 512, 132)] for b in range(132)]),
    (512, 512, 2, 128, [[(b // 2, 2 * (b % 2), 2 * (b % 2) + 2)] for b in range(128)]),
    (16, 640, 2, 3, [[(0, 0, 3), (1, 3, 5)], [(0, 3, 5)], [(1, 0, 3)]]),  # a ragged segment
    (8, 4096, 32, 5, [[(0, c, c + 1) for c in range(b, 32, 5)] for b in range(5)]),
    (672, 1024, 3, 132, [[(t // 3, 3 * (t % 3), min(3 * (t % 3) + 3, 8))
                          for t in range(b, 252, 132)] for b in range(132)]),
])
def test_coop_assignment(ny, nx, segs, blocks, owned):
    """Block b owns tiles b, b + blocks, ... in band-major order (a tile is
    a segment of a band's windows, the last one ragged); every tile has
    one owner, and every band's windows are cut into its tiles without a
    gap or an overlap."""
    got = resident.coop_assignment(ny, nx, segs, blocks)
    assert got == owned
    tiles = sorted(t for ts in got for t in ts)
    assert tiles == sorted(resident.coop_tiles(ny, nx, segs))
    assert len(set(tiles)) == len(tiles) == resident.num_bands(ny) * len(
        resident.coop_tiles(1, nx, segs))
    for q in range(resident.num_bands(ny)):
        cuts = [(c0, c1) for p, c0, c1 in tiles if p == q]
        assert [c for c0, c1 in cuts for c in range(c0, c1)] == list(
            range(resident.coop_windows(nx)))


@pytest.mark.parametrize("ny,nx,max_blocks,blocks", [
    (1024, 64, 132, 128), (2048, 64, 132, 132), (8, 64, 132, 1), (17, 64, 132, 3),
    (512, 64, 264, 64),  # one window: a block per band
    (1024, 1024, 132, 128), (2048, 2048, 132, 132), (4096, 4096, 132, 132),
    (512, 512, 132, 128), (256, 512, 132, 128), (640, 1024, 132, 132), (8, 4096, 132, 32),
    (17, 23, 132, 3), (100, 130, 132, 26),
])
def test_coop_blocks(ny, nx, max_blocks, blocks):
    """One block per tile, no more than can be co-resident."""
    assert resident.coop_blocks(ny, nx, max_blocks) == blocks


@pytest.mark.parametrize("ny,nx,blocks,segs", [
    (1024, 1024, 132, 1), (2048, 2048, 132, 1), (4096, 4096, 132, 1),  # bands spread evenly
    (1048, 1024, 132, 1),  # 131 bands: 8 windows a block either way
    (512, 512, 132, 2), (640, 1024, 132, 8), (656, 1024, 132, 8), (672, 1024, 132, 3),
    (256, 512, 132, 4), (256, 1024, 132, 4), (8, 4096, 132, 32), (800, 1024, 132, 8),
    (100, 130, 132, 2), (17, 23, 132, 1), (512, 512, 264, 4), (2048, 512, 132, 1),
])
def test_coop_segments_rule(ny, nx, blocks, segs):
    """Segments per band: one where the bands alone give every block one;
    else the count whose tiles make the most windows a block steps per
    round least (512^2: 2 windows a block; 640x1024: 5; 672x1024: 6, not
    8), the fewest on a tie (1024^2: 8 windows a block for 1, 2, 4 or 8)."""
    assert resident.coop_segments(ny, nx, blocks) == segs


@pytest.mark.parametrize("blocks", [1, 3, 132, 264])
def test_coop_segments_leave_no_segment_empty(blocks):
    """Whatever the rule picks, every segment holds at least one window and
    the count is the one that its width gives: the kernel's tiles are the
    rule's."""
    for ny in (8, 64, 512, 1000, 1100):
        for windows in range(1, 40):
            nx = windows * resident.COOP_WINDOW_COLS - 5
            segs = resident.coop_segments(ny, nx, blocks)
            width = -(-windows // segs)
            assert 1 <= segs <= windows and -(-windows // width) == segs
            assert len(resident.coop_tiles(ny, nx, segs)) == resident.num_bands(ny) * segs


def _owner(nx, segs, blocks):
    """Block owning window c of band p (csrc/resident_kernel.cu coop_owns)."""
    width = -(-resident.coop_windows(nx) // segs)
    return lambda p, c: (p * segs + c // width) % blocks


def _flags_waited(ny, nx, k, q, c, owner):
    """The (band, window) flags a window of band q at window c waits for
    (csrc/resident_kernel.cu coop_flag, restated): the bands of rows y0 -
    K, y0 - 1, y0, y0 + h, y0 + h + K - 1 by the windows of columns x0 - K,
    x0 - 1, x0, x0 + w, x0 + w + K - 1, wrapped, but those that the
    window's own block owns."""
    y0, x0 = q * resident.BAND_ROWS, c * resident.COOP_WINDOW_COLS
    h, w = min(resident.BAND_ROWS, ny - y0), min(resident.COOP_WINDOW_COLS, nx - x0)
    me = owner(q, c)
    return {(((y0 + dy) % ny) // resident.BAND_ROWS, ((x0 + dx) % nx) // resident.COOP_WINDOW_COLS)
            for dy in (-k, -1, 0, h, h + k - 1) for dx in (-k, -1, 0, w, w + k - 1)} - {
        (p, cw) for p in range(resident.num_bands(ny))
        for cw in range(resident.coop_windows(nx)) if owner(p, cw) == me}


@pytest.mark.parametrize("k", resident.COOP_K)
@pytest.mark.parametrize("ny", [1, 2, 3, 5, 8, 9, 10, 16, 17, 19, 24, 27, 33, 100])
@pytest.mark.parametrize("nx", [3, 130, 300, 385, 1000])
def test_coop_ghost_cells_are_flagged(ny, nx, k):
    """Every ghost cell a window needs (K rows above and below, K columns
    either side, the corners, wrapped) lies in a window that the window's
    own block owns (it wrote it in the previous round: read from the
    state, no wait) or in a (band, window) whose flag the window waits for,
    and the window waits for no other; and the waits are symmetric: a
    window whose cells another reads waits, at that window, for the
    reader's flag (so it cannot overwrite them before they are read).
    Over 1 to 4 segments per band, a block per tile and a third as many
    blocks; one band, two, three, ragged bands and windows (385: a last
    window of one column, narrower than K), grids smaller than K."""
    bands, windows = resident.num_bands(ny), resident.coop_windows(nx)
    for segs in range(1, min(4, windows) + 1):
        tiles = len(resident.coop_tiles(ny, nx, segs))
        for blocks in sorted({tiles, max(1, tiles // 3)}):
            owner = _owner(nx, segs, blocks)
            waited = {(q, c): _flags_waited(ny, nx, k, q, c, owner)
                      for q in range(bands) for c in range(windows)}
            for (q, c), flags in waited.items():
                y0, x0 = q * resident.BAND_ROWS, c * resident.COOP_WINDOW_COLS
                h = min(resident.BAND_ROWS, ny - y0)
                w = min(resident.COOP_WINDOW_COLS, nx - x0)
                row_bands = {((y0 + dy) % ny) // resident.BAND_ROWS for dy in range(-k, h + k)}
                col_windows = {((x0 + dx) % nx) // resident.COOP_WINDOW_COLS
                               for dx in range(-k, w + k)}
                needed = {(p, cw) for p in row_bands for cw in col_windows
                          if owner(p, cw) != owner(q, c)}
                assert flags == needed, (segs, blocks, q, c, flags ^ needed)
                for p, cw in needed:
                    assert (q, c) in waited[(p, cw)], (segs, blocks, q, c, p, cw)
