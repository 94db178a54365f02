"""The stream kernel's wrapper on the CPU (its plain PyTorch version, the
port's lean window steps on ghosted row slabs) against the JAX package's
streaming Pallas kernel in interpret mode, and against the port's own step
run.

The JAX kernel tiles rows by ``LBM_STREAM_TY``; 16 on the 32- and 48-row
decks here gives it several tiles, as tests/test_stream.py runs it.
Tolerances: f within rtol 1e-5 / atol 1e-8 and av within rtol 1e-5 against
the JAX kernel (both reduce ||u|| over the pre-collision moments, in
another summation order); bitwise against the port's step run and between
the two step forms, which run the same float32 operations per cell.  The
card itself is covered by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from advanced_hpc_lbm_tpu.ops import kernel_common as jkc
from advanced_hpc_lbm_tpu.ops import pallas_stream
from advanced_hpc_lbm_tpu.ops import reference as jref
from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu_torch.ops import kernel_common, step_kernel, stream_kernel
from advanced_hpc_lbm_tpu_torch.params import LBMParams

F_TOL = dict(rtol=1e-5, atol=1e-8)
AV_RTOL = 1e-5
K = stream_kernel.K


def make_case(ny, nx, seed=31, guard_fail=False):
    """As tests/test_stream.py's deck, with a perturbed state made in
    numpy: equilibrium x uniform(0.8, 1.2)."""
    jp = JaxParams(nx=nx, ny=ny, max_iters=16, reynolds_dim=10,
                   density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[ny // 3: ny // 3 + 3, nx // 4: nx // 2] = True
    for _ in range(6):
        mask[rng.randint(1, ny - 1), rng.randint(0, nx)] = True
    f0 = np.asarray(jref.initial_state(jp)) * rng.uniform(
        0.8, 1.2, (9, ny, nx)).astype(np.float32)
    if guard_fail:
        f0[3, ny - 2, : nx // 2] = jp.accel_w1 * np.float32(0.5)
    return jp, mask, f0


def jax_pad_mask(enc):
    """A (ny, nx) encoded mask as the JAX kernel takes it: float32, with K
    wrap rows on each side."""
    m = jnp.asarray(enc, jnp.float32)
    return jnp.concatenate([m[-K:], m, m[:K]], axis=0)


def jax_pass(jp, f0, enc_pad, *, inplace=False, trapezoid=False):
    """One JAX streaming pass: (f_next, per-step ||u|| sums (K,))."""
    f_pad, av = pallas_stream.multi_step_padded(
        pallas_stream.pad_state(jnp.asarray(f0)), enc_pad, jnp.float32(1.0), jp,
        interpret=True, inplace=inplace, trapezoid=trapezoid)
    return np.asarray(pallas_stream.unpad_state(f_pad)), np.asarray(av)


def port_pass(jp, f0, enc, *, inplace=False, trapezoid=False):
    """One port pass from the plain version: (f_next, per-step sums (K,))."""
    f = torch.from_numpy(f0.copy())
    out = f if inplace else torch.empty_like(f)
    part = torch.empty(K, stream_kernel.num_tiles(*f0.shape[1:]))
    stream_kernel.plain_multi_step(f, torch.as_tensor(np.asarray(enc, np.uint8)),
                                   LBMParams.from_jax(jp), out=out, partials=part,
                                   trapezoid=trapezoid)
    return out.numpy(), part.sum(dim=1).numpy()


# ---- the pass against the JAX kernel ------------------------------------------------

@pytest.fixture(scope="module")
def deck32():
    return make_case(32, 128, guard_fail=True)


@pytest.mark.parametrize("trapezoid", [False, True], ids=["full", "trapezoid"])
@pytest.mark.parametrize("inplace", [False, True], ids=["out", "inplace"])
def test_pass_matches_jax_kernel(deck32, monkeypatch, inplace, trapezoid):
    jp, mask, f0 = deck32
    monkeypatch.setenv("LBM_STREAM_TY", "16")
    fa, ava = jax_pass(jp, f0, pallas_stream.prepare_obstacles(jnp.asarray(mask)),
                       inplace=inplace, trapezoid=trapezoid)
    enc = stream_kernel.prepare_obstacles(torch.from_numpy(mask))
    fb, avb = port_pass(jp, f0, enc, inplace=inplace, trapezoid=trapezoid)
    np.testing.assert_allclose(fb, fa, **F_TOL)
    np.testing.assert_allclose(avb, ava, rtol=AV_RTOL)


def test_three_tiles_in_place_match_jax(monkeypatch):
    """48 rows at LBM_STREAM_TY=16: the JAX kernel's middle tile has both
    neighbours; the port's slab covers all three."""
    jp, mask, f0 = make_case(48, 128, seed=7)
    monkeypatch.setenv("LBM_STREAM_TY", "16")
    fa, ava = jax_pass(jp, f0, pallas_stream.prepare_obstacles(jnp.asarray(mask)),
                       inplace=True)
    fb, avb = port_pass(jp, f0, stream_kernel.prepare_obstacles(torch.from_numpy(mask)),
                        inplace=True)
    np.testing.assert_allclose(fb, fa, **F_TOL)
    np.testing.assert_allclose(avb, ava, rtol=AV_RTOL)


def test_forcing_row_in_ghost_image():
    """ny = 24 with forcing row 22: the row lies K deep in the wrap ghost of
    the first window, and must be forced there too (one JAX tile)."""
    jp, mask, f0 = make_case(24, 128, seed=3)
    fa, ava = jax_pass(jp, f0, pallas_stream.prepare_obstacles(jnp.asarray(mask)))
    fb, avb = stream_kernel.multi_step(torch.from_numpy(f0.copy()), torch.from_numpy(mask),
                                       torch.tensor(1.0), LBMParams.from_jax(jp))
    np.testing.assert_allclose(fb.numpy(), fa, **F_TOL)
    np.testing.assert_allclose(avb.numpy(), ava, rtol=AV_RTOL)


def _custom_masks(mask, ny, nx):
    """Forcing on row 5 and row ny-2, and +4 on a block of cells and on
    column 3: the JAX and the port encodings of the same mask."""
    accel = np.zeros(ny, bool)
    accel[[5, ny - 2]] = True
    excl = np.zeros((ny, nx), bool)
    excl[8:14, 20:60] = True
    excl[:, 3] = True
    jenc = pallas_stream.mark_reduction_excluded(
        pallas_stream.encode_masks(jnp.asarray(mask), jnp.asarray(accel)), jnp.asarray(excl))
    penc = stream_kernel.mark_reduction_excluded(
        stream_kernel.encode_masks(torch.from_numpy(mask), torch.from_numpy(accel)),
        torch.from_numpy(excl))
    return jenc, penc, excl


def test_encoded_values_match_jax(deck32):
    jp, mask, _ = deck32
    jenc, penc, _ = _custom_masks(mask, 32, 128)
    assert penc.dtype == torch.uint8
    np.testing.assert_array_equal(penc.numpy(), np.asarray(jenc).astype(np.uint8))
    np.testing.assert_array_equal(
        stream_kernel.prepare_obstacles(torch.from_numpy(mask)).numpy(),
        np.asarray(pallas_stream.prepare_obstacles(jnp.asarray(mask)))[K:-K].astype(np.uint8))


@pytest.mark.parametrize("inplace", [False, True], ids=["out", "inplace"])
def test_excluded_cells_and_a_second_forcing_row_match_jax(deck32, monkeypatch, inplace):
    """+4 cells keep their dynamics and leave the partials; a +2 row other
    than ny-2 is forced: the same state and sums as the JAX kernel."""
    jp, mask, f0 = deck32
    monkeypatch.setenv("LBM_STREAM_TY", "16")
    jenc, penc, excl = _custom_masks(mask, 32, 128)
    fa, ava = jax_pass(jp, f0, jax_pad_mask(jenc), inplace=inplace)
    fb, avb = port_pass(jp, f0, penc, inplace=inplace)
    np.testing.assert_allclose(fb, fa, **F_TOL)
    np.testing.assert_allclose(avb, ava, rtol=AV_RTOL)
    # the +4 cells are missing from the sums, and their dynamics are kept
    f_all, av_all = port_pass(jp, f0, penc & 3, inplace=inplace)
    assert np.all(avb < av_all)
    np.testing.assert_array_equal(fb, f_all)


# ---- the step forms ----------------------------------------------------------------

def jax_lean_window_step_rows(jp, f, obst, accel, lo, hi):
    """JAX ``lean_window_step_rows`` on a whole (T, nx) window, in a Pallas
    call run in interpret mode."""
    _, T, nx = f.shape

    def kernel(f_ref, o_ref, a_ref, out_ref, usq_ref):
        out_ref[...] = f_ref[...]
        usq_ref[...] = jkc.lean_window_step_rows(
            f_ref, out_ref, o_ref[...] != 0.0, a_ref[...] != 0.0, jp, T, nx, lo, hi)

    out, u_sq = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((9, T, nx), jnp.float32),
                   jax.ShapeDtypeStruct((hi - lo, nx), jnp.float32)],
        interpret=True,
    )(jnp.asarray(f), jnp.asarray(obst, jnp.float32), jnp.asarray(accel, jnp.float32))
    return np.asarray(out), np.asarray(u_sq)


@pytest.mark.parametrize("lo,hi", [(1, 23), (3, 20), (8, 16)])
def test_lean_window_step_rows_matches_jax_and_full_window(lo, hi):
    jp, mask, f = make_case(24, 40, seed=2)
    accel = np.zeros((24, 40), dtype=bool)
    accel[[4, 15]] = True
    f[3, 15, :13] = jp.accel_w1 * np.float32(0.5)  # some cells fail the guard
    p = LBMParams.from_jax(jp)
    want, want_usq = jax_lean_window_step_rows(jp, f, mask, accel, lo, hi)
    src = torch.from_numpy(f)
    dst = src.clone()
    u_sq = kernel_common.lean_window_step_rows(src, dst, torch.from_numpy(mask),
                                               torch.from_numpy(accel), p, 24, 40, lo, hi)
    np.testing.assert_allclose(dst.numpy()[:, lo:hi], want[:, lo:hi], **F_TOL)
    np.testing.assert_allclose(u_sq.numpy(), want_usq, **F_TOL)
    # rows outside [lo, hi) are left as they were
    np.testing.assert_array_equal(dst.numpy()[:, :lo], f[:, :lo])
    # bitwise the full-window step on its rows [lo, hi)
    full = torch.empty_like(src)
    full_usq = kernel_common.lean_window_step(src, full, torch.from_numpy(mask),
                                              torch.from_numpy(accel), p, 24, 40)
    np.testing.assert_array_equal(dst.numpy()[:, lo:hi], full.numpy()[:, lo:hi])
    np.testing.assert_array_equal(u_sq.numpy(), full_usq.numpy()[lo:hi])


def test_lean_window_step_rows_rejects_bad_bounds():
    src = torch.zeros(9, 8, 8)
    with pytest.raises(ValueError):
        kernel_common.lean_window_step_rows(src, src.clone(), torch.zeros(8, 8, dtype=bool),
                                            torch.zeros(8, 8, dtype=bool),
                                            LBMParams.from_jax(make_case(8, 8)[0]), 8, 8, 0, 7)


# ---- whole runs --------------------------------------------------------------------

@pytest.mark.parametrize("n_iters", [27, 43])
def test_run_with_tail_matches_jax(monkeypatch, n_iters):
    jp, mask, f0 = make_case(32, 128, seed=9)
    monkeypatch.setenv("LBM_STREAM_TY", "16")
    fa, ava = pallas_stream.run(jnp.asarray(f0), jnp.asarray(mask), jp, n_iters=n_iters,
                                interpret=True, inplace=True)
    fb, avb = stream_kernel.run(torch.from_numpy(f0.copy()), torch.from_numpy(mask),
                                LBMParams.from_jax(jp), n_iters=n_iters)
    np.testing.assert_allclose(fb.numpy(), np.asarray(fa), **F_TOL)
    np.testing.assert_allclose(avb.numpy(), np.asarray(ava), rtol=AV_RTOL)


@pytest.mark.parametrize("inplace", [False, True], ids=["out", "inplace"])
@pytest.mark.parametrize("ny,nx", [(17, 23), (100, 130), (5, 3), (170, 1100), (24, 2100)])
def test_odd_shapes_match_step_run_bitwise(ny, nx, inplace):
    """Windows wrap more than once at 17x23 and 5x3, slabs are ragged at
    100 and 170 rows, 1100 columns make two segments and 2100 three (the
    last one 52 columns: 4 chunks, the last ragged); the state equals the
    step run's bit for bit, av within the summation-order tolerance."""
    jp, mask, f0 = make_case(ny, nx, seed=ny, guard_fail=ny > 2)
    p = LBMParams.from_jax(jp)
    n = 2 * K + 3
    fb, avb = stream_kernel.run(torch.from_numpy(f0.copy()), torch.from_numpy(mask), p,
                                n_iters=n, inplace=inplace)
    fs, avs = step_kernel.run(torch.from_numpy(f0), torch.from_numpy(mask), p, n_iters=n)
    np.testing.assert_array_equal(fb.numpy(), fs.numpy())
    np.testing.assert_allclose(avb.numpy(), avs.numpy(), rtol=AV_RTOL)


@pytest.mark.parametrize("donate", [False, True])
def test_run_donation(donate):
    jp, mask, f0 = make_case(17, 23)
    f_in = torch.from_numpy(f0.copy())
    fb, _ = stream_kernel.run(f_in, torch.from_numpy(mask), LBMParams.from_jax(jp),
                              n_iters=K, donate=donate)
    assert (fb.data_ptr() == f_in.data_ptr()) == donate
    if not donate:
        np.testing.assert_array_equal(f_in.numpy(), f0)


def test_inplace_runner_matches_run():
    jp, mask, _ = make_case(40, 70, seed=4)
    p = LBMParams.from_jax(jp)
    runner = stream_kernel.make_inplace_runner(mask, p, n_iters=16, device="cpu")
    runner.warmup()
    fr, avr = runner()
    f0 = torch.from_numpy(np.array(jref.initial_state(jp)))
    fs, avs = step_kernel.run(f0, torch.from_numpy(mask), p, n_iters=16)
    np.testing.assert_array_equal(fr.numpy(), fs.numpy())
    np.testing.assert_allclose(avr.numpy(), avs.numpy(), rtol=AV_RTOL)
    # from a host state
    f_init = np.asarray(make_case(40, 70, seed=5)[2])
    fr2, _ = runner(f_init)
    fs2, _ = step_kernel.run(torch.from_numpy(f_init), torch.from_numpy(mask), p, n_iters=16)
    np.testing.assert_array_equal(fr2.numpy(), fs2.numpy())
    with pytest.raises(ValueError, match="initial state"):
        runner(f_init[:, :-1])


def test_inplace_runner_refuses_a_tail():
    jp, mask, _ = make_case(16, 32)
    with pytest.raises(ValueError, match="n_iters % 8"):
        stream_kernel.make_inplace_runner(mask, LBMParams.from_jax(jp), n_iters=17, device="cpu")


# ---- the wrapper's own contract ----------------------------------------------------

def test_cpu_run_counts_no_launch():
    jp, mask, f0 = make_case(16, 32)
    before = (stream_kernel.launches, stream_kernel.snapshot_launches, step_kernel.launches)
    stream_kernel.run(torch.from_numpy(f0), torch.from_numpy(mask), LBMParams.from_jax(jp),
                      n_iters=K + 1)
    assert (stream_kernel.launches, stream_kernel.snapshot_launches,
            step_kernel.launches) == before


@pytest.mark.parametrize("bad", ["partials_shape", "out_shape", "mask_dtype"])
def test_stream_pass_rejects_bad_arguments(bad):
    jp, mask, f0 = make_case(16, 32)
    f = torch.from_numpy(f0)
    enc = stream_kernel.prepare_obstacles(torch.from_numpy(mask))
    args = dict(out=None, partials=torch.empty(K, stream_kernel.num_tiles(16, 32)))
    if bad == "partials_shape":
        args["partials"] = torch.empty(K - 1, 1)
    elif bad == "out_shape":
        args["out"] = torch.empty(9, 16, 31)
    else:
        enc = enc.to(torch.float32)
    with pytest.raises(ValueError):
        stream_kernel.stream_pass(f, enc, LBMParams.from_jax(jp), **args)


@pytest.mark.parametrize("block_cells", [1, 23, 5 * 23 + 7, 1 << 24])
def test_fluid_cells_counted_by_blocks(block_cells):
    _, mask, _ = make_case(17, 23)
    enc = stream_kernel.mark_reduction_excluded(
        stream_kernel.prepare_obstacles(torch.from_numpy(mask)),
        torch.ones(17, 23, dtype=torch.bool))
    got = stream_kernel.fluid_cells(enc, block_cells)
    assert got.dtype == torch.float32 and got.item() == np.count_nonzero(~mask)


@pytest.mark.parametrize("n", [4096, 8192, 16384, 36864])
def test_side_buffer_keeps_its_share_of_the_state(n):
    """2K/SLAB + 2K/SEGMENT of a state (21.5625%, plus a ragged last slab's
    and segment's share): the geometry the in-place tier was sized with."""
    share = stream_kernel.side_bytes(n, n) / (4 * 9 * n * n)
    full = 2 * K / stream_kernel.SLAB + 2 * K / stream_kernel.SEGMENT
    assert full <= 0.215625
    assert share == pytest.approx(
        2 * K * (stream_kernel.num_slabs(n) / n + stream_kernel.num_segments(n) / n))


@pytest.mark.parametrize("n", [8192, 16384, 36864])
def test_side_buffer_is_at_most_a_quarter_state(n):
    state = 4 * 9 * n * n
    assert stream_kernel.side_bytes(n, n) <= 0.25 * state
    # the tier: one state, the mask, the side buffer and the partials
    assert stream_kernel.tier_bytes(n, n) <= 1.25 * state + n * n
