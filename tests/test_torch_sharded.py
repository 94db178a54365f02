"""The port's sharded path on the CPU against the JAX package's.

The same seeded numpy inputs go through ``advanced_hpc_lbm_tpu.parallel.halo``
on the suite's 8 virtual CPU devices (its ``pallas`` and ``stream`` kernels
in interpret mode, as tests/test_dist.py runs them) and through the port's
``parallel.halo`` with every shard on the CPU, where the port's kernels run
their plain versions.  The local kernels (``ops/local_kernel.py``) are also
held to the JAX kernels directly; the stream kernel on windows meets the
JAX window kernel through the ``stream`` runs.

Tolerances: f within rtol 1e-5 / atol 1e-7 and av within rtol 1e-5 against
the same JAX path (the same float32 operations per cell, ||u|| summed in
another order).  Two comparisons cross formulas and say so: the port runs
the tail of a ``stream`` run and a ``--debug`` run of ``pallas`` or
``stream`` on its 1-step local kernel where the JAX package runs its
``jnp`` step (equilibrium of ``reference``, ||u|| from the post-collision
moments): the states then agree to float32 rounding of the two formulas,
and av to the rounding of pre- against post-collision moments, both within
the same bounds.  Against the port's single-device step the kernel paths
are bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_hpc_lbm_tpu.ops import pallas_local as jpl
from advanced_hpc_lbm_tpu.ops import reference as jref
from advanced_hpc_lbm_tpu.parallel import halo as jhalo
from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu_torch import Simulation, cli
from advanced_hpc_lbm_tpu_torch.ops import lattice, local_kernel, step_kernel, stream_kernel
from advanced_hpc_lbm_tpu_torch.parallel import halo, mesh
from advanced_hpc_lbm_tpu_torch.params import LBMParams
from advanced_hpc_lbm_tpu_torch.utils import check

F_TOL = dict(rtol=1e-5, atol=1e-7)
AV_RTOL = 1e-5
MINI = ("decks/mini_64x64.params", "decks/mini_64x64.obstacles.dat")
MINI_GOLDEN = "decks/mini_64x64.golden_av_vels.dat"


def make_case(ny, nx, seed=7):
    """Walls on rows 0 and ny-1, a block, random obstacles; equilibrium x
    uniform(0.8, 1.2), with W starved on half of row ny-2 so that the
    forcing guard fails there."""
    jp = JaxParams(nx=nx, ny=ny, max_iters=40, reynolds_dim=10,
                   density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[ny // 3: ny // 3 + 2, nx // 4: nx // 2] = True
    for _ in range(8):
        mask[rng.randint(1, ny - 1), rng.randint(0, nx)] = True
    f0 = np.asarray(jref.initial_state(jp)) * rng.uniform(
        0.8, 1.2, (9, ny, nx)).astype(np.float32)
    f0[3, ny - 2, : nx // 2] = jp.accel_w1 * np.float32(0.5)
    return jp, mask, f0


def jax_run(jp, mask, f0, shape, iters, **kw):
    """The JAX sharded run on a ring of ``shape`` devices (an int) or a
    torus (a pair); numpy outputs."""
    args = (jnp.asarray(f0), jnp.asarray(mask), jp)
    if isinstance(shape, tuple):
        out = jhalo.run_sharded_2d(*args, shape, n_iters=iters, **kw)
    else:
        out = jhalo.run_sharded(*args, n_iters=iters, n_devices=shape, **kw)
    return tuple(np.asarray(o) for o in out)


def port_run(jp, mask, f0, shape, iters, **kw):
    """The port's sharded run with every shard on the CPU; numpy outputs."""
    params = LBMParams.from_jax(jp)
    if isinstance(shape, tuple):
        out = halo.run_sharded_2d(f0, mask, params, shape, n_iters=iters,
                                  devices=["cpu"] * (shape[0] * shape[1]), **kw)
    else:
        out = halo.run_sharded(f0, mask, params, n_iters=iters, devices=["cpu"] * shape, **kw)
    return (out[0].numpy(), *(o.numpy() for o in out[1:]))


def assert_same(port, ref):
    assert len(port) == len(ref)
    np.testing.assert_allclose(port[0], ref[0], **F_TOL)
    for got, want in zip(port[1:], ref[1:]):  # av, and densities
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=AV_RTOL)


def single_step_run(jp, mask, f0, iters):
    """The port's single-device step kernel (its plain version here)."""
    f, av = step_kernel.run(torch.from_numpy(f0.copy()), torch.from_numpy(mask),
                            LBMParams.from_jax(jp), n_iters=iters)
    return f.numpy(), av.numpy()


# ---- the jnp shard kernel -------------------------------------------------------

@pytest.mark.parametrize("shape", [1, 2, 4, 8, (2, 2), (2, 4), (4, 2), (1, 8)])
def test_jnp_matches_jax(shape):
    jp, mask, f0 = make_case(64, 32)
    assert_same(port_run(jp, mask, f0, shape, 10), jax_run(jp, mask, f0, shape, 10))


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("shape", [4, (2, 2)])
def test_jnp_ca_matches_jax(shape, k):
    """K steps per exchange, with a 1-step tail."""
    jp, mask, f0 = make_case(64, 32, seed=k)
    iters = 2 * k + 1
    assert_same(port_run(jp, mask, f0, shape, iters, ca_steps=k),
                jax_run(jp, mask, f0, shape, iters, ca_steps=k))


@pytest.mark.parametrize("shape", [4, (2, 2)])
def test_debug_densities_match_jax(shape):
    jp, mask, f0 = make_case(64, 32, seed=3)
    ref = jax_run(jp, mask, f0, shape, 6, collect_density=True)
    for kernel in ("jnp", "pallas", "stream"):
        assert_same(port_run(jp, mask, f0, shape, 6, kernel=kernel, collect_density=True), ref)


@pytest.mark.parametrize("shape", [8, (4, 2)])
def test_forcing_row_on_a_halo_row_matches_jax(shape):
    """ly = 2: the bottom halo row of a shard is row ny-2 itself (on the
    torus, one that crosses the x edges), so the local kernel forces pulls
    from a halo row, where the JAX jnp path forces the slab before the
    exchange."""
    ny = 2 * (shape if isinstance(shape, int) else shape[0])
    jp, mask, f0 = make_case(ny, 32, seed=11)
    mask[ny - 2] = False
    mask[ny - 2, 5] = True
    ref = jax_run(jp, mask, f0, shape, 6)
    for kernel in ("jnp", "pallas"):
        assert_same(port_run(jp, mask, f0, shape, 6, kernel=kernel), ref)


# ---- the pallas shard kernel -----------------------------------------------------

@pytest.mark.parametrize("shape", [2, 4, (2, 2), (2, 4)])
def test_pallas_matches_jax(shape):
    my, mx = shape if isinstance(shape, tuple) else (shape, 1)
    jp, mask, f0 = make_case(64 if mx == 1 else 16 * my, 128 * mx, seed=13)
    assert_same(port_run(jp, mask, f0, shape, 8, kernel="pallas"),
                jax_run(jp, mask, f0, shape, 8, kernel="pallas", interpret=True))


@pytest.mark.parametrize("n,k", [(2, 2), (4, 4), (8, 3)])
def test_pallas_ca_matches_jax(n, k):
    """The K-step local form with the 1-step tail; at (8, 3) the forcing
    row is a ghost row of the first shard and an own row of the last."""
    jp, mask, f0 = make_case(64, 128, seed=23)
    iters = 2 * k + 1
    assert_same(port_run(jp, mask, f0, n, iters, kernel="pallas", ca_steps=k),
                jax_run(jp, mask, f0, n, iters, kernel="pallas", ca_steps=k, interpret=True))


@pytest.mark.parametrize("kernel,kw", [("pallas", {}), ("pallas", {"ca_steps": 2}),
                                       ("pallas", {"ca_steps": 5}), ("stream", {})])
@pytest.mark.parametrize("n", [1, 3])
def test_kernel_paths_equal_the_single_device_step(n, kernel, kw):
    """One shard (its own halos; with K = 2 the forcing row is a ghost row
    and an own row of the one window) and three: bitwise the single-device
    step, tails included."""
    jp, mask, f0 = make_case(48, 40, seed=n)
    f, av = port_run(jp, mask, f0, n, 13, kernel=kernel, **kw)
    ref_f, ref_av = single_step_run(jp, mask, f0, 13)
    np.testing.assert_array_equal(f, ref_f)
    np.testing.assert_allclose(av, ref_av, rtol=AV_RTOL)


# ---- the stream shard kernel ------------------------------------------------------

@pytest.mark.parametrize("shape,ny,nx", [(2, 32, 128), ((2, 2), 16, 256)])
def test_stream_matches_jax(shape, ny, nx):
    """One pass of 8 steps and a 1-step tail (the JAX tail runs its jnp
    step, the port's the 1-step local kernel)."""
    jp, mask, f0 = make_case(ny, nx, seed=31)
    assert_same(port_run(jp, mask, f0, shape, 9, kernel="stream"),
                jax_run(jp, mask, f0, shape, 9, kernel="stream", interpret=True))


def test_stream_torus_equals_the_single_device_step():
    jp, mask, f0 = make_case(32, 48, seed=5)
    f, av = port_run(jp, mask, f0, (2, 3), 19, kernel="stream")
    ref_f, ref_av = single_step_run(jp, mask, f0, 19)
    np.testing.assert_array_equal(f, ref_f)
    np.testing.assert_allclose(av, ref_av, rtol=AV_RTOL)


# ---- the kernels against the JAX kernels --------------------------------------------

def window_and_mask(f0, mask, rows, cols, accel_rows):
    """A window of the (9, ny, nx) state: ``rows`` / ``cols`` global
    indices (periodic), its encoded mask forced on ``accel_rows``."""
    w = torch.from_numpy(np.ascontiguousarray(f0[:, rows][:, :, cols]))
    obst = torch.from_numpy(np.ascontiguousarray(mask[np.ix_(rows, cols)]))
    return w, stream_kernel.encode_masks(obst, torch.from_numpy(np.isin(rows, accel_rows)))


def test_local_step_matches_jax_kernel():
    """A 16-row slab of a 64x128 grid, halo rows from rows 31 and 48, the
    forcing row an own row."""
    jp, mask, f0 = make_case(64, 128, seed=41)
    lo, ly, nx = 32, 16, 128
    accel = lo + 10
    rows = np.arange(lo - 1, lo + ly + 1)
    win, enc = window_and_mask(f0, mask, rows, np.arange(nx), [accel])
    out, part = torch.empty(9, ly, nx), torch.empty(local_kernel.num_partials(ly, nx))
    local_kernel.local_step(win, enc, LBMParams.from_jax(jp), out=out, partials=part)
    f_j, tot_j = jpl.local_step(
        jnp.asarray(f0[:, lo:lo + ly]), jnp.asarray(f0[:, lo - 1:lo]),
        jnp.asarray(f0[:, lo + ly:lo + ly + 1]), jnp.asarray(mask[lo:lo + ly]),
        jnp.int32(accel - lo), jp, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(f_j), **F_TOL)
    np.testing.assert_allclose(part.sum().item(), float(tot_j), rtol=AV_RTOL)


def test_local_step_2d_matches_jax_kernel():
    """A 16x128 block of a 64x256 grid on a torus, the forcing row an own
    row crossing both x edges; the JAX kernel takes its six pre-shifted
    halo columns pre-forced, as parallel/halo.py exports them."""
    jp, mask, f0 = make_case(64, 256, seed=43)
    params = LBMParams.from_jax(jp)
    (lo, ly), (xo, lx) = (16, 16), (128, 128)
    accel = lo + 5
    rows, cols = np.arange(lo - 1, lo + ly + 1), np.arange(xo - 1, xo + lx + 1) % 256
    win, enc = window_and_mask(f0, mask, rows, cols, [accel])
    out, part = torch.empty(9, ly, lx), torch.empty(local_kernel.num_partials(ly, lx))
    local_kernel.local_step_2d(win, enc, params, out=out, partials=part)
    # the edge columns as the JAX 2-D path exports them: forced, row-extended
    forced = halo._masked_accelerate(win, (enc & 1) != 0, (enc[:, 0] & 2) != 0,
                                     params.accel_w1, params.accel_w2).numpy()
    halo_cols = np.stack([
        forced[k, 1 - int(lattice.CY[k]):1 - int(lattice.CY[k]) + ly,
               0 if lattice.CX[k] == 1 else lx + 1][:, None]
        for k in jpl._XCOL_PLANES])
    f_j, tot_j = jpl.local_step_2d(
        jnp.asarray(f0[:, lo:lo + ly, xo:xo + lx]), jnp.asarray(f0[:, lo - 1:lo, xo:xo + lx]),
        jnp.asarray(f0[:, lo + ly:lo + ly + 1, xo:xo + lx]), jnp.asarray(halo_cols),
        jnp.asarray(mask[lo:lo + ly, xo:xo + lx]), jnp.int32(accel - lo), jp, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(f_j), **F_TOL)
    np.testing.assert_allclose(part.sum().item(), float(tot_j), rtol=AV_RTOL)


@pytest.mark.parametrize("k", [2])
def test_local_ca_steps_matches_jax_kernel(k):
    """The window of a ring of one shard over a 16-row grid: row ny-2 = 14
    is an own row and, at K >= 2, a ghost row of the same window.  (K = 3,
    4 and 8 run against the JAX kernel through the sharded runs.)"""
    jp, mask, f0 = make_case(16, 32, seed=47 + k)
    ly, nx = 16, 32
    rows = np.arange(-k, ly + k) % 16
    win, enc = window_and_mask(f0, mask, rows, np.arange(nx), [14])
    out, part = torch.empty(9, ly, nx), torch.empty(k, local_kernel.num_tiles(ly, nx))
    local_kernel.local_ca_steps(win, enc, LBMParams.from_jax(jp), k, out=out, partials=part)
    f_j, tots_j = jpl.local_ca_steps(
        jnp.asarray(win.numpy()), jnp.asarray((enc & 1).numpy(), jnp.float32),
        jnp.asarray(((enc & 2) >> 1).numpy(), jnp.float32), jp, k, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(f_j), **F_TOL)
    np.testing.assert_allclose(part.sum(dim=1).numpy(), np.asarray(tots_j), rtol=AV_RTOL)


@pytest.mark.parametrize("ly,lo,k,images", [(2, 13, 2, 1), (2, 13, 4, 1), (2, 5, 8, 2),
                                             (16, 0, 8, 2), (5, 11, 3, 1)])
def test_local_ca_steps_thin_shards_match_jax_kernel(ly, lo, k, images):
    """Shards of ly own rows from row lo of a 16-row grid: at ly = 2 the
    forcing row (14) is an own row (lo = 13) or, at lo = 5 and K = 8, a
    ghost row twice in one window; at ly = 16, K = 8 an own row and a ghost
    row; ly = 5 leaves the tile ragged.  The K-step local form against the
    JAX kernel."""
    jp, mask, f0 = make_case(16, 32, seed=53 + ly + k)
    nx = 32
    rows = np.arange(lo - k, lo + ly + k) % 16
    win, enc = window_and_mask(f0, mask, rows, np.arange(nx), [14])
    assert np.count_nonzero(rows == 14) == images
    out, part = torch.empty(9, ly, nx), torch.empty(k, local_kernel.num_tiles(ly, nx))
    local_kernel.local_ca_steps(win, enc, LBMParams.from_jax(jp), k, out=out, partials=part)
    f_j, tots_j = jpl.local_ca_steps(
        jnp.asarray(win.numpy()), jnp.asarray((enc & 1).numpy(), jnp.float32),
        jnp.asarray(((enc & 2) >> 1).numpy(), jnp.float32), jp, k, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(f_j), **F_TOL)
    np.testing.assert_allclose(part.sum(dim=1).numpy(), np.asarray(tots_j), rtol=AV_RTOL)


# ---- refusals, meshes, the model and the CLI -------------------------------------------

@pytest.mark.parametrize("shape,kw,message", [
    (3, {}, "not divisible"),
    ((3, 2), {}, "not divisible"),
    (8, {"ca_steps": 8}, "too thin"),
    ((4, 4), {"ca_steps": 5}, "too thin"),
    (8, {"kernel": "stream"}, "too thin"),
    (2, {"kernel": "stream", "ca_steps": 4}, "K=8 steps per exchange"),
    ((2, 2), {"kernel": "pallas", "ca_steps": 2}, "not supported on the 2-D torus"),
    (2, {"overlap": True, "kernel": "pallas"}, "1-step jnp"),
    (16, {"overlap": True}, "interior"),
    (2, {"kernel": "cuda"}, "unknown shard kernel"),
])
def test_refusals(shape, kw, message):
    jp, mask, f0 = make_case(32, 32)
    with pytest.raises(ValueError, match=message):
        port_run(jp, mask, f0, shape, 4, **kw)


def test_mesh_takes_the_visible_cards_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 4 devices, only 1 available"):
        mesh.make_y_mesh(4)
    with pytest.raises(ValueError, match="requested 2x2 devices, only 1 available"):
        mesh.make_yx_mesh(2, 2)
    assert mesh.make_y_mesh().devices == (torch.device("cuda", 0),)
    m = mesh.make_yx_mesh(1, 2, ["cpu", "cpu"])
    assert m.shape == (1, 2) and m.torus and m.index(0, 2) == 0


def test_auto_resolution():
    params = LBMParams(nx=128, ny=64, max_iters=1, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    assert halo.resolve_shard_kernel(params, n_devices=4, device_type="cpu") == "jnp"
    assert halo.resolve_shard_kernel(params, n_devices=4, device_type="cuda") == "pallas"
    assert halo.resolve_shard_kernel(params, n_devices=4, ca_steps=4,
                                     device_type="cuda") == "pallas"
    assert halo.resolve_shard_kernel(params, mesh_shape=(2, 2), ca_steps=2,
                                     device_type="cuda") == "jnp"
    assert halo.resolve_shard_kernel(params, n_devices=3, device_type="cuda") == "jnp"
    # shards of 2^24 cells and more run the stream kernel when ca_steps is 1
    for n, shape, want in ((8192, 4, "stream"), (8192, (2, 2), "stream"),
                           (6144, 4, "pallas"), (6144, (2, 2), "pallas")):
        big = LBMParams(nx=n, ny=n, max_iters=1, reynolds_dim=10, density=0.1,
                        accel=0.005, omega=1.85)
        kw = {"mesh_shape": shape} if isinstance(shape, tuple) else {"n_devices": shape}
        assert halo.resolve_shard_kernel(big, device_type="cuda", **kw) == want
    big = LBMParams(nx=8192, ny=8192, max_iters=1, reynolds_dim=10, density=0.1,
                    accel=0.005, omega=1.85)
    assert halo.resolve_shard_kernel(big, n_devices=4, ca_steps=4, device_type="cuda") == "pallas"
    thin = LBMParams(nx=1 << 22, ny=16, max_iters=1, reynolds_dim=10, density=0.1,
                     accel=0.005, omega=1.85)
    assert halo.resolve_shard_kernel(thin, n_devices=4, device_type="cuda") == "pallas"


def test_simulation_sharded_equals_single_device():
    jp, mask, _ = make_case(48, 40, seed=2)
    params = LBMParams.from_jax(jp)
    single = Simulation(params, mask, backend="pallas", device="cpu").run(n_iters=9, debug=True)
    sim = Simulation(params, mask, backend="sharded", device="cpu")
    kw = dict(n_iters=9, debug=True, devices=4, shard_kernel="pallas", ca_steps=2)
    sim.warmup(**kw)
    res = sim.run(fetch=False, **kw)
    assert isinstance(res.f_final, halo.ShardedState)
    res.collate()
    np.testing.assert_array_equal(res.f_final, single.f_final)
    np.testing.assert_allclose(res.av_vels, single.av_vels, rtol=AV_RTOL)
    np.testing.assert_allclose(res.densities, single.densities, rtol=AV_RTOL)
    with pytest.raises(ValueError, match="needs the sharded backend"):
        Simulation(params, mask, device="cpu").run(n_iters=2, ca_steps=2)


@pytest.mark.parametrize("flags", [["--devices", "4"], ["--mesh", "2x2"]])
def test_cli_sharded_mini_deck(flags, tmp_path, capsys):
    rc = cli.main([*MINI, "--device", "cpu", "--backend", "sharded", *flags,
                   "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and out.startswith("==done==")
    assert check.check_av_vels_only(MINI_GOLDEN, str(tmp_path / "av_vels.dat")).passed(1.0)


@pytest.mark.parametrize("flags,message", [
    (["--devices", "3"], "not divisible"),
    (["--devices", "8", "--ca-steps", "8"], "too thin"),
    (["--mesh", "2x2", "--shard-kernel", "pallas", "--ca-steps", "2"], "2-D torus"),
])
def test_cli_bad_decomposition_exits_1(flags, message, tmp_path, capsys):
    rc = cli.main([*MINI, "--device", "cpu", "--backend", "sharded", *flags,
                   "--out-dir", str(tmp_path)])
    captured = capsys.readouterr()
    assert rc == 1 and captured.out == ""
    assert captured.err.startswith("Error:") and message in captured.err
    assert not (tmp_path / "av_vels.dat").exists()


def test_jax_devices_available():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
