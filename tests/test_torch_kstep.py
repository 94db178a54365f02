"""The K-step kernel's wrapper on the CPU (its plain PyTorch version, the
port's ``lean_window_step`` on ghosted windows) against the JAX package's
K-step and 2-step Pallas kernels in interpret mode, and against the port's
own step run.

Tolerances: f within rtol 1e-5 / atol 1e-7 and av within rtol 1e-5 against
the JAX kernels (both reduce ||u|| over the pre-collision moments, in
another summation order); bitwise against the port's step run, which runs
the same float32 operations in the same order on every cell.  The card
itself is covered by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from advanced_hpc_lbm_tpu.ops import kernel_common as jkc
from advanced_hpc_lbm_tpu.ops import pallas_k, pallas_multi
from advanced_hpc_lbm_tpu.ops import reference as jref
from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu_torch.ops import kernel_common, kstep_kernel, step_kernel
from advanced_hpc_lbm_tpu_torch.params import LBMParams

F_TOL = dict(rtol=1e-5, atol=1e-7)
AV_RTOL = 1e-5


def make_case(ny, nx, seed=5, guard_fail=False):
    """As tests/test_pallas_k.py:make_deck, with a perturbed state made in
    numpy: equilibrium x uniform(0.8, 1.2)."""
    jp = JaxParams(nx=nx, ny=ny, max_iters=32, reynolds_dim=10,
                   density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[ny // 2: ny // 2 + 2, nx // 5: nx // 2] = True
    for _ in range(6):
        mask[rng.randint(1, ny - 1), rng.randint(0, nx)] = True
    f0 = np.asarray(jref.initial_state(jp)) * rng.uniform(
        0.8, 1.2, (9, ny, nx)).astype(np.float32)
    if guard_fail:
        f0[3, ny - 2, : nx // 2] = jp.accel_w1 * np.float32(0.5)
    return jp, mask, f0


def port_run(jp, mask, f0, n, k, **kw):
    f, av = kstep_kernel.run(torch.from_numpy(f0.copy()), torch.from_numpy(mask),
                             LBMParams.from_jax(jp), n_iters=n, k=k, **kw)
    return f.numpy(), av.numpy()


# ---- lean_window_step, the plain version's step --------------------------------

def jax_lean_window_step(jp, f, obst, accel):
    """JAX ``lean_window_step`` on whole (T, nx) windows, in a Pallas call
    run in interpret mode (its rolls are Pallas TPU primitives)."""
    _, T, nx = f.shape

    def kernel(f_ref, o_ref, a_ref, out_ref, usq_ref):
        usq_ref[...] = jkc.lean_window_step(
            f_ref, out_ref, o_ref[...] != 0.0, a_ref[...] != 0.0, jp, T, nx)

    out, u_sq = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((9, T, nx), jnp.float32),
                   jax.ShapeDtypeStruct((T, nx), jnp.float32)],
        interpret=True,
    )(jnp.asarray(f), jnp.asarray(obst, jnp.float32), jnp.asarray(accel, jnp.float32))
    return np.asarray(out), np.asarray(u_sq)


@pytest.mark.parametrize("T,nx,accel_rows", [(24, 40, (3, 22)), (16, 128, (14,))])
def test_lean_window_step_matches_jax(T, nx, accel_rows):
    jp, mask, f = make_case(T, nx, seed=2)
    accel = np.zeros((T, nx), dtype=bool)
    for r in accel_rows:
        accel[r] = True
        f[3, r, : nx // 3] = jp.accel_w1 * np.float32(0.5)  # some cells fail the guard
    want, want_usq = jax_lean_window_step(jp, f, mask, accel)
    dst = torch.empty(f.shape)
    u_sq = kernel_common.lean_window_step(
        torch.from_numpy(f), dst, torch.from_numpy(mask), torch.from_numpy(accel),
        LBMParams.from_jax(jp), T, nx)
    np.testing.assert_allclose(dst.numpy(), want, **F_TOL)
    np.testing.assert_allclose(u_sq.numpy(), want_usq, **F_TOL)


def test_lean_window_step_on_the_whole_grid_is_one_plain_step():
    jp, mask, f = make_case(17, 23, seed=3, guard_fail=True)
    p = LBMParams.from_jax(jp)
    accel = (np.arange(17) == 15)[:, None]
    dst = torch.empty(f.shape)
    kernel_common.lean_window_step(torch.from_numpy(f), dst, torch.from_numpy(mask),
                                   torch.from_numpy(accel), p, 17, 23)
    out = torch.empty(f.shape)
    step_kernel.plain_step(torch.from_numpy(f), step_kernel.prepare_obstacles(
        torch.from_numpy(mask)), p, out=out,
        partials=torch.empty(step_kernel.num_partials(17, 23)))
    np.testing.assert_array_equal(dst.numpy(), out.numpy())


# ---- multi_step against the JAX K-step kernel ------------------------------------

@pytest.fixture(scope="module")
def deck64():
    return make_case(64, 128)


@pytest.fixture(scope="module")
def port_passes(deck64):
    """One port pass per K from the 64x128 deck, computed once."""
    jp, mask, f0 = deck64
    obst = torch.from_numpy(mask)
    n_fluid = torch.sum(~obst).to(torch.float32)
    return {k: kstep_kernel.multi_step(torch.from_numpy(f0), obst, n_fluid,
                                       LBMParams.from_jax(jp), k)
            for k in kstep_kernel.K_RANGE}


@pytest.mark.parametrize("lean", [False, True], ids=["naive", "lean"])
@pytest.mark.parametrize("k", [2, 3, 4, 8, 5, 6, 7])
def test_multi_step_matches_jax_kernel(k, lean, deck64, port_passes, monkeypatch):
    jp, mask, f0 = deck64
    monkeypatch.setenv("LBM_PALLASK_TY", "16")
    n_fluid = jnp.sum(~jnp.asarray(mask)).astype(jnp.float32)
    fa, ava = pallas_k.multi_step(jnp.asarray(f0), pallas_k.prepare_obstacles(jnp.asarray(mask)),
                                  n_fluid, jp, k, interpret=True, lean=lean)
    fb, avb = port_passes[k]
    assert avb.shape == (k,)
    np.testing.assert_allclose(fb.numpy(), np.asarray(fa), **F_TOL)
    np.testing.assert_allclose(avb.numpy(), np.asarray(ava), rtol=AV_RTOL)


def test_run_with_tail_matches_jax(monkeypatch):
    """iters = 2k+1: two K-step passes and a 1-step tail on each side."""
    k = 3
    jp, mask, f0 = make_case(32, 128, seed=9)
    monkeypatch.setenv("LBM_PALLASK_TY", "16")
    fa, ava = pallas_k.run(jnp.asarray(f0), jnp.asarray(mask), jp, n_iters=2 * k + 1, k=k,
                           interpret=True)
    fb, avb = port_run(jp, mask, f0, 2 * k + 1, k)
    np.testing.assert_allclose(fb, np.asarray(fa), **F_TOL)
    np.testing.assert_allclose(avb, np.asarray(ava), rtol=AV_RTOL)


@pytest.mark.parametrize("iters", [4, 6, 7])
def test_pallas2_run_matches_jax(iters):
    jp, mask, f0 = make_case(32, 128, seed=1)
    fa, ava = pallas_multi.run(jnp.asarray(f0), jnp.asarray(mask), jp, n_iters=iters,
                               interpret=True)
    fb, avb = port_run(jp, mask, f0, iters, 2)
    np.testing.assert_allclose(fb, np.asarray(fa), **F_TOL)
    np.testing.assert_allclose(avb, np.asarray(ava), rtol=AV_RTOL)


def test_double_step_is_multi_step_at_k2():
    jp, mask, f0 = make_case(32, 64, seed=4)
    obst = torch.from_numpy(mask)
    n_fluid = torch.sum(~obst).to(torch.float32)
    p = LBMParams.from_jax(jp)
    f2, av1, av2 = kstep_kernel.double_step(torch.from_numpy(f0), obst, n_fluid, p)
    fk, avk = kstep_kernel.multi_step(torch.from_numpy(f0), obst, n_fluid, p, 2)
    np.testing.assert_array_equal(f2.numpy(), fk.numpy())
    assert (float(av1), float(av2)) == tuple(avk.tolist())


# ---- shapes the JAX tiles refuse, against the port's step run ----------------------

@pytest.mark.parametrize("ny,nx", [(17, 23), (100, 130), (5, 3)])
@pytest.mark.parametrize("k", [2, 5, 8, 3, 4, 6, 7])
def test_odd_shapes_match_step_run_bitwise(ny, nx, k):
    """Every built K.  Windows wrap more than once at 17x23 (a K=8 window
    is 32x48) and at 5x3, a grid narrower than one window in both
    directions, and tiles are ragged at 100x130; the state equals the step
    run's bit for bit, av within the summation-order tolerance."""
    jp, mask, f0 = make_case(ny, nx, seed=k, guard_fail=True)
    n = 2 * k + 1
    fb, avb = port_run(jp, mask, f0, n, k)
    fs, avs = step_kernel.run(torch.from_numpy(f0), torch.from_numpy(mask),
                              LBMParams.from_jax(jp), n_iters=n)
    np.testing.assert_array_equal(fb, fs.numpy())
    np.testing.assert_allclose(avb, avs.numpy(), rtol=AV_RTOL)


@pytest.mark.parametrize("ny,nx", [(16, 32), (17, 23), (40, 70)])
def test_partials_are_per_tile_sums(ny, nx):
    """partials[s, tile]: own fluid cells of each TILE_X x TILE_Y tile,
    row-major; their total is the step's ||u|| sum."""
    jp, mask, f0 = make_case(ny, nx, seed=6)
    p = LBMParams.from_jax(jp)
    f, m = torch.from_numpy(f0), step_kernel.prepare_obstacles(torch.from_numpy(mask))
    part = torch.empty(3, kstep_kernel.num_tiles(ny, nx))
    kstep_kernel.kstep(f, m, p, 3, out=torch.empty_like(f), partials=part)
    ty, tx = kstep_kernel.TILE_Y, kstep_kernel.TILE_X
    assert part.shape[1] == -(-ny // ty) * -(-nx // tx)
    # step 0's partials against the step kernel's plain version, per tile
    out, sp = torch.empty_like(f), torch.empty(step_kernel.num_partials(ny, nx))
    step_kernel.plain_step(f, m, p, out=out, partials=sp)
    rho = out.sum(0)
    u_x = (out[1] + out[5] + out[8] - out[3] - out[6] - out[7]) / rho
    u_y = (out[2] + out[5] + out[6] - out[4] - out[7] - out[8]) / rho
    norm = torch.where(torch.from_numpy(mask), 0.0, torch.sqrt(u_x * u_x + u_y * u_y)).numpy()
    want = [norm[i * ty:(i + 1) * ty, j * tx:(j + 1) * tx].sum(dtype=np.float64)
            for i in range(-(-ny // ty)) for j in range(-(-nx // tx))]
    np.testing.assert_allclose(part[0].numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(float(part[0].sum()), float(sp.sum()), rtol=1e-6)


# ---- the wrapper's own contract ----------------------------------------------------

def test_cpu_run_counts_no_launch():
    jp, mask, f0 = make_case(16, 32)
    before = (kstep_kernel.launches, step_kernel.launches)
    port_run(jp, mask, f0, 5, 2)
    assert (kstep_kernel.launches, step_kernel.launches) == before


@pytest.mark.parametrize("iters,chunk", [(9, 4), (8, 8), (3, 1000), (0, 1000)])
def test_run_chunks_match_stepwise(iters, chunk):
    """Several chunks of passes, a single one, a run shorter than K and no
    steps at all."""
    jp, mask, f0 = make_case(17, 23, seed=7)
    f_in = torch.from_numpy(f0.copy())
    fb, avb = kstep_kernel.run(f_in, torch.from_numpy(mask), LBMParams.from_jax(jp),
                               n_iters=iters, k=4, chunk=chunk)
    fs, avs = step_kernel.run(torch.from_numpy(f0), torch.from_numpy(mask),
                              LBMParams.from_jax(jp), n_iters=iters)
    assert avb.shape == (iters,)
    np.testing.assert_array_equal(fb.numpy(), fs.numpy())
    np.testing.assert_allclose(avb.numpy(), avs.numpy(), rtol=AV_RTOL)
    np.testing.assert_array_equal(f_in.numpy(), f0)  # f0 is not modified


@pytest.mark.parametrize("bad", ["k1", "k9", "partials_shape", "alias"])
def test_kstep_rejects_bad_arguments(bad):
    jp, mask, f0 = make_case(16, 32)
    f = torch.from_numpy(f0)
    k = {"k1": 1, "k9": 9}.get(bad, 4)
    args = dict(out=torch.empty_like(f), partials=torch.empty(k, kstep_kernel.num_tiles(16, 32)))
    if bad == "partials_shape":
        args["partials"] = torch.empty(3, 1)
    elif bad == "alias":
        args["out"] = f
    with pytest.raises(ValueError):
        kstep_kernel.kstep(f, step_kernel.prepare_obstacles(torch.from_numpy(mask)),
                           LBMParams.from_jax(jp), k, **args)


@pytest.mark.parametrize("ny,nx", [(17, 23), (64, 64), (256, 256), (1024, 1024), (4096, 4096),
                                   (16384, 16384)])
def test_best_k_is_a_built_k(ny, nx):
    assert kstep_kernel.best_k(ny, nx) in kstep_kernel.K_RANGE


# ---- the kernel's feed and schedule (the Python restatement of its rules) ----------

@pytest.mark.parametrize("k", list(kstep_kernel.K_RANGE))
@pytest.mark.parametrize("ny,nx", [(17, 23), (100, 130), (5, 3), (1024, 1024), (4096, 4096)])
def test_schedule_feeds_every_tile_once_and_evenly(ny, nx, k):
    """Every tile of a pass is taken by exactly one team and fed by exactly
    one of the bulk and wrap paths; no team takes more than one tile above
    the mean; 1860 bulk tiles a pass at 1024^2, none at 17x23."""
    tiles = kstep_kernel.num_tiles(ny, nx)
    teams = kstep_kernel.schedule(ny, nx, k, sms=132)
    taken = sorted(t for team in teams for t in team)
    assert taken == list(range(tiles))
    assert len(teams) == min(tiles, 132) * kstep_kernel.teams(k)
    mean = tiles / len(teams)
    assert max(len(team) for team in teams) < mean + 1
    bulk = kstep_kernel.bulk_tiles(ny, nx, k)
    a = -(-k // 4) * 4
    tx = -(-nx // kstep_kernel.TILE_X)
    fed_bulk = [t for t in range(tiles)
                if nx % 4 == 0
                and 0 <= t // tx * kstep_kernel.TILE_Y - k
                and t // tx * kstep_kernel.TILE_Y + kstep_kernel.TILE_Y + k <= ny
                and 0 <= t % tx * kstep_kernel.TILE_X - a
                and t % tx * kstep_kernel.TILE_X + kstep_kernel.TILE_X + a <= nx]
    assert bulk == len(fed_bulk) and 0 <= bulk <= tiles
    want = {(1024, 1024): 1860, (4096, 4096): 32004}.get((ny, nx), 0)
    assert bulk == want


def test_run_sets_the_feed_on_its_loop_span():
    """run() on the CPU puts the tiles of its passes by feed on the
    lbm.ops.loop span: the rule's bulk and wrap counts times the passes."""
    from advanced_hpc_lbm_tpu_torch.utils import profiling

    k, passes = 3, 2
    for ny, nx in ((17, 23), (48, 96)):
        jp, mask, f0 = make_case(ny, nx, seed=8)
        with profiling.recording() as rec:
            port_run(jp, mask, f0, passes * k + 1, k)
        loop = [s for s in rec.named("lbm.ops.loop") if "tiles_bulk" in s.attrs]
        assert len(loop) == 1
        bulk = kstep_kernel.bulk_tiles(ny, nx, k)
        # 48 x 96 walks its 2 passes in one launch, 17 x 23 launches each
        per = passes if kstep_kernel.walks(ny, nx) else 1
        assert loop[0].attrs == {"launches": 0, "passes_per_launch": per,
                                 "tiles_bulk": passes * bulk,
                                 "tiles_wrap": passes * (kstep_kernel.num_tiles(ny, nx) - bulk)}
    assert kstep_kernel.bulk_tiles(48, 96, 3) == 1  # the middle tile of 3 x 3
    assert kstep_kernel.walks(48, 96) and not kstep_kernel.walks(17, 23)


# ---- a launch that walks many passes (the Python restatement of its rules) ---------

# 1024^2; 3 x 3 tiles whose windows wrap in both directions (48 x 96); 2 x 2
# (32 x 64), where a window holds each tile row and column twice over; one
# tile whose window wraps onto itself (16 x 32)
WALK_CASES = [(1024, 1024, 3), (48, 96, 3), (32, 64, 8), (16, 32, 4)]


def _holders(ny, nx, k):
    """For each tile, the tiles whose own cells its window holds (the
    kernel's load_window: K rows and kA = K rounded up to 4 columns around
    the tile, wrapped)."""
    a = -(-k // 4) * 4
    tx, ty = nx // kstep_kernel.TILE_X, ny // kstep_kernel.TILE_Y
    out = []
    for t in range(tx * ty):
        y0, x0 = t // tx * kstep_kernel.TILE_Y, t % tx * kstep_kernel.TILE_X
        rows = {(y0 - k + r) % ny // kstep_kernel.TILE_Y
                for r in range(kstep_kernel.TILE_Y + 2 * k)}
        cols = {(x0 - a + c) % nx // kstep_kernel.TILE_X
                for c in range(kstep_kernel.TILE_X + 2 * a)}
        out.append({r * tx + c for r in rows for c in cols})
    return out


@pytest.mark.parametrize("ny,nx,k", WALK_CASES)
def test_deps_order_every_read_and_every_write(ny, nx, k):
    """deps(t) is exactly the set of tiles whose cells t's window holds, and
    the set of tiles whose windows hold t's cells: waiting for them to
    store pass i orders t's reads at pass i + 1 after their writes (read
    after write) and t's writes at pass i + 1, into the buffer pass i read,
    after their windows' loads of pass i (write after read).  Grids of
    ragged tiles do not walk."""
    assert kstep_kernel.walks(ny, nx)
    holders = _holders(ny, nx, k)
    for t, held in enumerate(holders):
        dep = kstep_kernel.deps(ny, nx, t)
        assert len(dep) == 9 and set(dep) == held
        assert {u for u, h in enumerate(holders) if t in h} == held
    for ny, nx in ((100, 130), (17, 23), (1009, 1024), (1024, 1026), (5, 3)):
        assert not kstep_kernel.walks(ny, nx)


@pytest.mark.parametrize("ny,nx,k", WALK_CASES)
def test_walk_takes_each_item_once_in_pass_order(ny, nx, k):
    """Each pass takes every tile once; a block's items, and so each
    team's, come in increasing order; the first pass is schedule()'s; and a
    tile's deps of the pass before come earlier: at 1024^2 by the tiles of
    a pass less three tile rows plus one (a tile of column 0 waits for the
    last column two rows on), more than 132 blocks' rings of 5 windows
    hold, so the first tiles of a pass need only tiles stored early in the
    pass before."""
    tiles, passes = kstep_kernel.num_tiles(ny, nx), 4
    order = {kstep_kernel.item(ny, nx, j): j for j in range(passes * tiles)}
    assert sorted(order) == [(i, t) for i in range(passes) for t in range(tiles)]
    assert [kstep_kernel.item(ny, nx, j)[1] for j in range(tiles)] == list(range(tiles))
    grid, teams = min(tiles, 132), kstep_kernel.teams(k)
    blocks = [[kstep_kernel.item(ny, nx, j)[1] for j in range(b, tiles, grid)]
              for b in range(grid)]
    assert kstep_kernel.schedule(ny, nx, k, 132) == [
        block[j::teams] for block in blocks for j in range(teams)]
    lag = min(order[(i, t)] - order[(i - 1, d)] for i in range(1, passes)
              for t in range(tiles) for d in kstep_kernel.deps(ny, nx, t))
    assert lag > 0
    if (ny, nx) == (1024, 1024):
        assert lag == tiles - 3 * (nx // kstep_kernel.TILE_X) + 1 > 132 * 5


def _simulate(ny, nx, k, blocks, stages, passes, seed):
    """Every block's producer and teams on a ring of ``stages`` windows, as
    the kernel runs them: the producer loads the block's next item once its
    stage is empty and deps() have flagged the pass before; a team steps
    its next loaded item and stores it, and flags the store before it once
    it has stored the next one, or at once where the next is not loaded
    (it would wait), or at the end.  Each round every actor that can move
    does so with probability 1/2 (drawn from ``seed``), at least one, so
    that blocks drift apart as on the card.  Each load checks that every
    tile it reads has stored the pass before and not yet the pass after
    (read after write), each store that every window holding the tile's
    cells has loaded the pass before, whose source buffer it overwrites
    (write after read).  Raises where no actor can move (a wait cycle)."""
    rng = np.random.RandomState(seed)
    tiles = kstep_kernel.num_tiles(ny, nx)
    grid, J = min(tiles, blocks), kstep_kernel.teams(k)
    holders = _holders(ny, nx, k)
    readers = [[u for u in range(tiles) if t in holders[u]] for t in range(tiles)]
    dep = [set(kstep_kernel.deps(ny, nx, t)) for t in range(tiles)]
    mine = [[kstep_kernel.item(ny, nx, j) for j in range(b, passes * tiles, grid)]
            for b in range(grid)]
    stored = [0] * tiles      # 1 + the last pass stored
    flag = [0] * tiles        # 1 + the last pass flagged
    loaded = [-1] * tiles     # the last pass loaded
    load_n = [0] * grid
    team_n = [list(range(J)) for _ in range(grid)]
    held = [[None] * J for _ in range(grid)]  # a team's store not yet flagged
    state = [[0] * len(m) for m in mine]  # 0 waiting, 1 loaded, 2 stepped

    def say(b, j):
        i, t = mine[b][held[b][j]]
        assert flag[t] == i
        flag[t], held[b][j] = i + 1, None

    def enabled(b, a):
        m, st = mine[b], state[b]
        if a == 0:
            n = load_n[b]
            if n >= len(m):
                return False
            i, t = m[n]
            return (n < stages or st[n - stages] == 2) and all(flag[d] >= i for d in dep[t])
        n = team_n[b][a - 1]
        return (n < len(m) and st[n] == 1) or held[b][a - 1] is not None

    def move(b, a):
        m, st = mine[b], state[b]
        if a == 0:
            n = load_n[b]
            i, t = m[n]
            assert all(stored[d] in (i, i + 1) for d in holders[t])
            assert loaded[t] == i - 1
            loaded[t], st[n], load_n[b] = i, 1, n + 1
            return
        j = a - 1
        n = team_n[b][j]
        if n < len(m) and st[n] == 1:
            i, t = m[n]
            assert all(loaded[u] >= i - 1 for u in readers[t])
            assert stored[t] == i
            stored[t], st[n], team_n[b][j] = i + 1, 2, n + J
            if held[b][j] is not None:
                say(b, j)
            held[b][j] = n
        else:  # the next item is not loaded (or there is none): flag the last
            say(b, j)

    actors = [(b, a) for b in range(grid) for a in range(J + 1)]
    while True:
        ready = [ba for ba in actors if enabled(*ba)]
        if not ready:
            break
        go = [ba for ba in ready if rng.random_sample() < 0.5] or ready[:1]
        for ba in go:
            if enabled(*ba):
                move(*ba)
    assert flag == [passes] * tiles, "no actor can move: a wait cycle"


@pytest.mark.parametrize("ny,nx,k,stages,passes", [
    (1024, 1024, 3, 5, 3), (48, 96, 3, 5, 6), (32, 64, 8, 3, 5), (16, 32, 4, 5, 4)])
def test_simulated_walk_of_132_blocks_never_waits_in_a_cycle(ny, nx, k, stages, passes):
    """132 blocks (fewer where a pass has fewer tiles), each at its own
    random pace, walk a launch of several passes to its end, every read
    after the write it needs and every write after the reads of the pass
    before."""
    _simulate(ny, nx, k, 132, stages, passes, seed=ny + nx + k)
