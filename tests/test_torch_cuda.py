"""The CUDA kernels on the card (step, resident, K-step, stream, and the
sharded path's local kernels), against their plain PyTorch versions and
against each other.  Skipped where PyTorch sees no CUDA device.

This file imports no JAX, so that the card's host, which has none, can run
it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Built with -fmad=false and the plain version's op order, the kernels are
expected to match bit for bit; the stated tolerance is f within rtol 1e-6 /
atol 1e-8, and av within rtol 1e-5 (the kernel sums ||u|| by a block tree,
PyTorch by its own reduction order).  The resident, K-step and stream
kernels run the step kernel's per-cell code, so their state equals the step
kernel's with 0 differing values; so does the state of a sharded run on
four shards of the one card.  A mesh across two or four cards equals the
same mesh laid on cuda:0 alone with 0 differing values, av included (those
cases skip where fewer cards are visible).
"""

import ctypes

import numpy as np
import pytest
import torch

from advanced_hpc_lbm_tpu_torch import Simulation
from advanced_hpc_lbm_tpu_torch.models import d2q9_bgk
from advanced_hpc_lbm_tpu_torch.ops import (
    kstep_kernel, library, local_kernel, reference, resident, step_kernel, stream_kernel,
)
from advanced_hpc_lbm_tpu_torch.parallel import halo
from advanced_hpc_lbm_tpu_torch.params import LBMParams

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]


def make_case(ny, nx, seed=0):
    params = LBMParams(nx=nx, ny=ny, max_iters=20, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[ny // 2: ny // 2 + 2, nx // 3: nx // 2] = True
    for _ in range(6):
        mask[rng.randint(1, ny - 1), rng.randint(0, nx)] = True
    f0 = reference.initial_state(params, "cpu").numpy() * rng.uniform(
        0.8, 1.2, (9, ny, nx)).astype(np.float32)
    f0[3, ny - 2, : nx // 2] = params.accel_w1 * np.float32(0.5)  # guard fails
    return params, mask, f0


@pytest.mark.parametrize("ny,nx", [(64, 64), (100, 130), (17, 23), (256, 512)])
def test_kernel_matches_plain_on_card(ny, nx):
    params, mask_np, f0 = make_case(ny, nx)
    f = torch.from_numpy(f0).cuda()
    mask = step_kernel.prepare_obstacles(torch.from_numpy(mask_np).cuda())
    outs = {}
    for name, fn in (("kernel", step_kernel.step), ("plain", step_kernel.plain_step)):
        out = torch.empty_like(f)
        part = torch.empty(step_kernel.num_partials(ny, nx), device="cuda")
        fn(f, mask, params, out=out, partials=part)
        outs[name] = (out, part.sum())
    torch.cuda.synchronize()
    torch.testing.assert_close(outs["kernel"][0], outs["plain"][0], rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(outs["kernel"][1], outs["plain"][1], rtol=1e-5, atol=0.0)


def test_launches_are_counted_and_run_matches_plain():
    params, mask_np, f0 = make_case(64, 96, seed=1)
    mask = torch.from_numpy(mask_np)
    before = step_kernel.launches
    fk, avk = step_kernel.run(torch.from_numpy(f0).cuda(), mask.cuda(), params, n_iters=7, chunk=3)
    torch.cuda.synchronize()
    assert step_kernel.launches - before == 7
    fp, avp = step_kernel.run(torch.from_numpy(f0), mask, params, n_iters=7, chunk=3)
    torch.testing.assert_close(fk.cpu(), fp, rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(avk.cpu(), avp, rtol=1e-5, atol=0.0)


def test_aliased_output_raises_on_card():
    params, mask_np, f0 = make_case(32, 32)
    f = torch.from_numpy(f0).cuda()
    mask = step_kernel.prepare_obstacles(torch.from_numpy(mask_np).cuda())
    part = torch.empty(step_kernel.num_partials(32, 32), device="cuda")
    with pytest.raises(ValueError, match="aliases"):
        step_kernel.step(f, mask, params, out=f, partials=part)


def test_simulation_on_card_matches_cpu():
    params, mask_np, _ = make_case(48, 80, seed=2)
    gpu = Simulation(params, mask_np, device="cuda").run()
    cpu = Simulation(params, mask_np, device="cpu").run()
    np.testing.assert_allclose(gpu.f_final, cpu.f_final, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gpu.av_vels, cpu.av_vels, rtol=1e-5)


def _on_card(ny, nx, seed):
    params, mask_np, f0 = make_case(ny, nx, seed)
    return params, torch.from_numpy(mask_np).cuda(), torch.from_numpy(f0).cuda()


def _resident_counts():
    return {"cooperative": resident.launches, "banded": resident.banded_launches}


def _moved(before):
    return {form: n - before[form] for form, n in _resident_counts().items()}


@pytest.mark.parametrize("ny,nx", [(64, 64), (100, 130), (17, 23), (256, 512), (1024, 1024)])
def test_resident_matches_step_and_plain_on_card(ny, nx):
    """Whichever form the shape takes: the banded one up to 256 x 318, the
    cooperative one on 256 x 512 (32 bands cut into 4 segments on an H100)
    and 1024 x 1024 (one segment a band)."""
    params, mask, f = _on_card(ny, nx, seed=3)
    form = resident.form_of(ny, nx, "cuda")
    assert form == ("banded" if nx <= 318 else "cooperative")
    before = _resident_counts()
    fr, avr = resident.resident_run(f, mask, params, n_iters=17, chunk=6)
    torch.cuda.synchronize()
    # chunks of 6, 6 and 5 steps
    assert _moved(before) == {name: 3 if name == form else 0 for name in before}
    fs, avs = step_kernel.run(f, mask, params, n_iters=17)
    assert int((fr != fs).sum()) == 0
    torch.testing.assert_close(avr, avs, rtol=1e-5, atol=0.0)
    fp, avp = resident.resident_run(f.cpu(), mask.cpu(), params, n_iters=17, chunk=6)
    torch.testing.assert_close(fr.cpu(), fp, rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(avr.cpu(), avp, rtol=1e-5, atol=0.0)


def _chunked_partials(launcher, f, n, chunk, tiles):
    """Run n steps in chunks through a chunk launcher; (state, partials)."""
    bufs = (f.clone(), torch.empty_like(f))
    part = torch.empty(n, tiles, device=f.device)
    for t0 in range(0, n, chunk):
        m = min(chunk, n - t0)
        launcher((bufs[t0 % 2], bufs[(t0 + 1) % 2]), m, part[t0:t0 + m])
    return bufs[n % 2], part


@pytest.mark.parametrize("n,chunk", [(17, 6), (5, 1), (24, 12)])
@pytest.mark.parametrize("ny,nx", [(8, 32), (16, 32), (17, 23), (64, 64), (128, 256),
                                   (256, 256), (256, 128), (19, 99), (1001, 50)])
def test_banded_resident_matches_step_kernel_bitwise(ny, nx, n, chunk):
    """One band and one segment (8 x 32: a block is its own neighbour both
    ways), two bands, a ragged last band of 1 row and of 3 (17 x 23, 1001 x
    50, 19 x 99: shorter than D), a ragged last segment of 3 columns (19 x
    99), blocks of 64 columns at D = 2 (256 x 256, 1001 x 50, one segment),
    the others of 32 at D = 4, the mini deck and three reference decks: 17
    steps in chunks of 6 (rounds of D and of n mod D, the outbox reset
    between launches), chunks of 1 step (fewer than D) and 24 steps in
    chunks of 12 (multiples of both D); 0 differing values in f and
    bitwise-equal partials against the step kernel, and the cooperative
    form's state on the same input."""
    params, mask, f = _on_card(ny, nx, seed=ny + nx)
    mask = step_kernel.prepare_obstacles(mask)
    assert resident.takes_banded(ny, nx, "cuda")
    tiles = step_kernel.num_partials(ny, nx)
    before = _resident_counts()
    launcher = resident._chunk_launcher(f, mask, params)
    fb, pb = _chunked_partials(launcher, f, n, chunk, tiles)
    torch.cuda.synchronize()
    assert _moved(before) == {"cooperative": 0, "banded": -(-n // chunk)}
    bufs = [f.clone(), torch.empty_like(f)]
    ps = torch.empty(n, tiles, device="cuda")
    for t in range(n):
        step_kernel.step(bufs[t % 2], mask, params, out=bufs[(t + 1) % 2], partials=ps[t])
    assert int((fb != bufs[n % 2]).sum()) == 0
    assert int((pb != ps).sum()) == 0
    if n == 17:
        fc, pc = _chunked_partials(
            resident._chunk_launcher(f, mask, params, form="cooperative"), f, n, chunk, tiles)
        assert int((fb != fc).sum()) == 0 and int((pb != pc).sum()) == 0


def test_reference_128x256_deck_runs_banded_on_card():
    """The reference's 128x256 deck (fluid across the periodic top/bottom
    wrap) on ``auto``: the resident backend, one ``lbm.ops.loop`` span of
    the banded form, 32 bands, nx 128 and ny 256, the rule's depth D > 1
    and its rounds, ceil(1000 / D) + ceil(200 / D); 1200 steps in two
    chunks with 0 differing values against the step kernel, av within the
    file's rtol 1e-5."""
    import os

    from advanced_hpc_lbm_tpu_torch.utils import profiling

    base = os.path.join(os.path.dirname(__file__), "..", "decks", "reference_128x256")
    sim = Simulation.from_decks(base + ".params", base + ".obstacles.dat", device="cuda")
    assert sim.backend == "resident"
    before = _resident_counts()
    with profiling.recording() as rec:
        res = sim.run(n_iters=1200)
    assert _moved(before) == {"cooperative": 0, "banded": 2}
    (run,) = rec.named("lbm.model.run")
    assert run.attrs == {"backend": "resident"}
    (loop,) = rec.named("lbm.ops.loop")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    depth = resident.banded_depth(256, 128, sms)
    assert depth > 1
    assert loop.attrs == {"form": "banded", "bands": 32, "nx": 128, "ny": 256, "depth": depth,
                          "rounds": -(-1000 // depth) + -(-200 // depth), "launches": 2}
    step = Simulation.from_decks(base + ".params", base + ".obstacles.dat", backend="step",
                                 device="cuda").run(n_iters=1200)
    assert int((res.f_final != step.f_final).sum()) == 0
    np.testing.assert_allclose(res.av_vels, step.av_vels, rtol=1e-5)


@pytest.mark.parametrize("ny,nx", [(256, 512), (512, 512), (1024, 1024), (2048, 512),
                                   (640, 1024), (672, 1024), (8, 4096)])
def test_wide_grid_runs_the_cooperative_form(ny, nx):
    """Grids the banded form refuses: resident_run launches, once per
    chunk, the cooperative form, its bands cut into segments where they
    are fewer than the co-resident blocks, and the state and av equal the
    step run's bit for bit."""
    params, mask, f = _on_card(ny, nx, seed=9)
    assert not resident.takes_banded(ny, nx, "cuda")
    assert resident.form_of(ny, nx, "cuda") == "cooperative"
    before = _resident_counts()
    fr, avr = resident.resident_run(f, mask, params, n_iters=17, chunk=6)
    torch.cuda.synchronize()
    assert _moved(before) == {"cooperative": 3, "banded": 0}
    fs, avs = step_kernel.run(f, mask, params, n_iters=17, chunk=6)
    assert int((fr != fs).sum()) == 0
    assert int((avr != avs).sum()) == 0


@pytest.mark.parametrize("k", resident.COOP_K)
@pytest.mark.parametrize("ny,nx,blocks", [
    (256, 512, 0), (512, 512, 0), (1024, 1024, 0),
    (100, 130, 0), (17, 23, 0),  # ny % 8 != 0 and nx % 32 != 0 (the form hook)
    (8, 40, 0), (16, 64, 0), (24, 64, 0),  # one, two and three bands
    (64, 64, 1), (64, 64, 3),  # 8 bands on 1 and 3 blocks: a block owns several
    # bands cut into segments of windows (on an H100: 4, 8, 3 and 32 a band)
    (256, 1024, 0), (640, 1024, 0), (672, 1024, 0), (8, 4096, 0),
    (512, 512, 7), (8, 4096, 5), (640, 1024, 37),  # fewer blocks than tiles
])
def test_cooperative_resident_matches_step_kernel_bitwise(ny, nx, blocks, k):
    """The cooperative form at every built K: 17 steps in chunks of 6 and
    5 (rounds of n mod K steps; at K = 4 rounds of 4 and 2, then 3, 1 and
    1), a guard-failing forcing row, 0 differing values in f and
    bitwise-equal partials against the step kernel; one segment a band and
    several, a block per tile and fewer."""
    params, mask, f = _on_card(ny, nx, seed=ny + nx + k)
    mask = step_kernel.prepare_obstacles(mask)
    tiles = step_kernel.num_partials(ny, nx)
    before = resident.launches
    launcher = resident._chunk_launcher(f, mask, params, blocks=blocks, form="cooperative", k=k)
    fc, pc = _chunked_partials(launcher, f, 17, 6, tiles)
    torch.cuda.synchronize()
    assert resident.launches - before == 3
    bufs = [f.clone(), torch.empty_like(f)]
    ps = torch.empty(17, tiles, device="cuda")
    for t in range(17):
        step_kernel.step(bufs[t % 2], mask, params, out=bufs[(t + 1) % 2], partials=ps[t])
    assert int((fc != bufs[1]).sum()) == 0
    assert int((pc != ps).sum()) == 0


@pytest.mark.parametrize("k", resident.COOP_K)
def test_cooperative_rules_in_c_equal_python(k):
    """The cooperative form's C queries against its Python rules on the
    card: K by shape, the segments a band (one at 1024^2, 2048^2, 4096^2),
    the grid (one block per tile up to the co-resident limit), the
    outbox's flag words, the shared memory of a block."""
    lib = library.load()
    smem, max_blocks = resident._coop_limits(torch.cuda.current_device(), k)
    assert smem == resident.coop_smem_bytes(k)
    assert max_blocks >= torch.cuda.get_device_properties(0).multi_processor_count
    words = ctypes.c_longlong()
    for ny, nx in [(8, 32), (17, 23), (256, 512), (1024, 1024), (4096, 4096), (8192, 64),
                   (512, 512), (256, 1024), (640, 1024), (656, 1024), (672, 1024), (8, 4096),
                   (2048, 2048), (100, 130)]:
        assert lib.lbm_resident_coop_k(ny, nx) == resident.coop_k(ny, nx)
        segs = resident.coop_segments(ny, nx, max_blocks)
        assert lib.lbm_resident_coop_segments(ny, nx, k) == segs
        if ny in (1024, 2048, 4096) and ny == nx:
            assert segs == 1
        assert lib.lbm_resident_coop_grid(ny, nx, k) == resident.coop_blocks(ny, nx, max_blocks)
        assert lib.lbm_resident_coop_scratch(ny, nx, ctypes.byref(words)) == 0
        assert words.value == resident.coop_flag_words(ny, nx)


@pytest.mark.parametrize("ny,nx", [(8, 32), (64, 64), (256, 256), (1056, 64), (1064, 64),
                                   (64, 318), (64, 319), (512, 512), (1024, 1024), (256, 128),
                                   (208, 320), (216, 320)])
def test_banded_rule_in_c_equals_python(ny, nx):
    """The banded form's C queries against its Python rules on the card:
    which grids it takes, the exchange depth, the widest block's shared
    memory."""
    lib = library.load()
    smem, blocks = resident._banded_limits(torch.cuda.current_device(), nx)
    assert smem >= resident.band_smem_bytes(256)
    assert (blocks >= 1) is (nx <= resident.BAND_MAX_COLS)  # 0: the kernel cannot take nx
    assert lib.lbm_resident_banded_fits(ny, nx) == int(resident.banded_fits(ny, nx, smem, blocks))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert lib.lbm_resident_banded_depth(ny, nx) == resident.banded_depth(ny, nx, sms)
    assert lib.lbm_resident_banded_smem(nx) == resident.band_smem_bytes(nx)


@pytest.mark.parametrize("ny,nx", [(64, 64), (512, 512)])
def test_oversized_cooperative_grid_raises(ny, nx):
    """10**6 blocks exceed any card's co-resident limit (132 SMs x at most
    32 blocks): the cooperative launch is refused, of bands in one segment
    and cut into segments alike, and the wrapper raises."""
    params, mask, f = _on_card(ny, nx, seed=4)
    mask = step_kernel.prepare_obstacles(mask)
    part = torch.empty(2, step_kernel.num_partials(ny, nx), device="cuda")
    run_chunk = resident._chunk_launcher(f, mask, params, blocks=10**6, form="cooperative")
    with pytest.raises(RuntimeError, match="resident kernel launch failed"):
        run_chunk((f.clone(), torch.empty_like(f)), 2, part)
    # the refusal is not reported again by the next launch
    step_kernel.run(f, mask, params, n_iters=2)
    torch.cuda.synchronize()


def test_refused_banded_launch_raises():
    """The banded form refused (a grid of 10**6 blocks cannot be
    co-resident): the wrapper raises and counts no launch; the next launch
    runs."""
    params, mask, f = _on_card(64, 64, seed=6)
    mask = step_kernel.prepare_obstacles(mask)
    part = torch.empty(2, step_kernel.num_partials(64, 64), device="cuda")
    run_chunk = resident._chunk_launcher(f, mask, params, blocks=10**6)
    before = _resident_counts()
    with pytest.raises(RuntimeError, match="resident kernel launch failed"):
        run_chunk((f.clone(), torch.empty_like(f)), 2, part)
    assert _resident_counts() == before
    resident.resident_run(f, mask, params, n_iters=2)
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", [2, 4, 6, 8])
@pytest.mark.parametrize("ny,nx", [(64, 64), (64, 128), (100, 130), (17, 23)])
def test_kstep_matches_step_and_plain_on_card(ny, nx, k):
    params, mask, f = _on_card(ny, nx, seed=k)
    n = 3 * k + 1  # three passes and a 1-step tail
    before = (kstep_kernel.launches, step_kernel.launches)
    fk, avk = kstep_kernel.run(f, mask, params, n_iters=n, k=k)
    torch.cuda.synchronize()
    # a grid of whole tiles walks its 3 passes in one launch
    walked = 1 if kstep_kernel.walks(ny, nx, kstep_kernel.card_sms("cuda")) else 3
    assert (kstep_kernel.launches - before[0], step_kernel.launches - before[1]) == (walked, 1)
    fs, avs = step_kernel.run(f, mask, params, n_iters=n)
    assert int((fk != fs).sum()) == 0
    torch.testing.assert_close(avk, avs, rtol=1e-5, atol=0.0)
    fp, avp = kstep_kernel.run(f.cpu(), mask.cpu(), params, n_iters=n, k=k)
    torch.testing.assert_close(fk.cpu(), fp, rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(avk.cpu(), avp, rtol=1e-5, atol=0.0)


def _persistent_blocks(per_sm: int) -> int:
    return per_sm * torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("per", [1, 2, 6])
@pytest.mark.parametrize("ny,nx", [(64, 64), (64, 128), (48, 96), (100, 130), (17, 23),
                                   (1024, 1024)])
def test_kstep_passes_per_launch_match_step_on_card(ny, nx, per, k):
    """6 passes in launches of 1, 2 and 6 passes (a walk where the grid is
    whole tiles, else a launch a pass): the state equals the step kernel's
    with 0 differing values, and every pass's partials are the same bits
    whatever a launch runs; a run of 6 passes and a 1-step tail with a
    chunk of ``per`` passes has the step kernel's state and its av history
    within rtol 1e-5."""
    params, mask, f = _on_card(ny, nx, seed=50 + k)
    m = step_kernel.prepare_obstacles(mask)
    tiles = kstep_kernel.num_tiles(ny, nx)
    launched = 6 // per if kstep_kernel.walks(ny, nx, kstep_kernel.card_sms("cuda")) else 6

    def passes(per):
        bufs = (f.clone(), torch.empty_like(f))
        part = torch.empty(6, k, tiles, device="cuda")
        launch = kstep_kernel._launcher(bufs[0], m, params, k)
        before = kstep_kernel.launches
        for p in range(0, 6, per):
            launch(bufs[p % 2], bufs[(p + 1) % 2], part[p:p + per])
        torch.cuda.synchronize()
        return bufs[0], part, kstep_kernel.launches - before

    fk, pk, n_launches = passes(per)
    f1, p1, _ = passes(1)
    assert n_launches == launched
    fs, avs = step_kernel.run(f, mask, params, n_iters=6 * k)
    assert int((fk != fs).sum()) == 0 and int((f1 != fs).sum()) == 0
    assert int((pk != p1).sum()) == 0
    n = 6 * k + 1
    before = kstep_kernel.launches
    fr, avr = kstep_kernel.run(f, mask, params, n_iters=n, k=k, chunk=per * k)
    torch.cuda.synchronize()
    assert kstep_kernel.launches - before == launched
    fs, avs = step_kernel.run(f, mask, params, n_iters=n)
    assert int((fr != fs).sum()) == 0
    torch.testing.assert_close(avr, avs, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("k", [3, 4, 8])
@pytest.mark.parametrize("ny,nx", [(1024, 1024), (64, 64)])
def test_kstep_persistent_grid_matches_step_on_card(ny, nx, k):
    """The persistent grid walks more tiles than it has blocks (1024^2:
    2048 tiles, several per block, the next window loading while one
    steps) and fewer (64^2: 8 tiles): 0 differing values against the step
    kernel over two passes and a tail."""
    params, mask, f = _on_card(ny, nx, seed=20 + k)
    blocks = _persistent_blocks(library.load().lbm_kstep_blocks_per_sm(k, 0))
    tiles = kstep_kernel.num_tiles(ny, nx)
    assert (tiles > blocks) == (ny == 1024) and blocks >= 132
    n = 2 * k + 1
    fk, avk = kstep_kernel.run(f, mask, params, n_iters=n, k=k)
    fs, avs = step_kernel.run(f, mask, params, n_iters=n)
    torch.cuda.synchronize()
    assert int((fk != fs).sum()) == 0
    torch.testing.assert_close(avk, avs, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_local_ca_persistent_grid_matches_plain_on_card(k):
    """The local form on a 512 x 2048 shard (2048 tiles, more than the
    persistent grid's blocks), forcing row an own row: 0 differing values
    against its plain version."""
    ly, nx = 512, 2048
    params, win, enc = _local_window(ly + 2 * k, nx, 30 + k, (ly + k - 3,))
    assert local_kernel.num_tiles(ly, nx) > _persistent_blocks(
        library.load().lbm_kstep_blocks_per_sm(k, 1))
    outs = []
    for fn in (local_kernel.local_ca_steps, local_kernel.plain_local_ca_steps):
        out = torch.empty(9, ly, nx, device="cuda")
        part = torch.empty(k, local_kernel.num_tiles(ly, nx), device="cuda")
        fn(win, enc, params, k, out=out, partials=part)
        outs.append((out, part.sum(dim=1)))
    torch.cuda.synchronize()
    assert int((outs[0][0] != outs[1][0]).sum()) == 0
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("ny,nx", [(330, 2100), (11000, 1100)])
def test_stream_pipeline_in_place_matches_step_on_card(ny, nx):
    """In place, where a chunk is written only after the next chunk's
    window has loaded: 330 x 2100 has 3 segments of 64, 64 and 4 chunks
    over 5 slabs (fewer items than the persistent grid's blocks), 11000 x
    1100 has 138 slabs of 2 segments, 276 items (more than its blocks,
    several per block).  Two passes: 0 differing values against the step
    kernel."""
    params, mask, f = _on_card(ny, nx, seed=40)
    items = stream_kernel.num_tiles(ny, nx)
    blocks = _persistent_blocks(library.load().lbm_stream_blocks_per_sm())
    assert (items > blocks) == (ny == 11000)
    n = 2 * stream_kernel.K
    fk, avk = stream_kernel.run(f, mask, params, n_iters=n, inplace=True)
    fs, avs = step_kernel.run(f, mask, params, n_iters=n)
    torch.cuda.synchronize()
    assert int((fk != fs).sum()) == 0
    torch.testing.assert_close(avk, avs, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("backend,counts", [
    ("resident", (0, 1, 0)), ("pallas2", (1, 0, 12)), ("pallas", (25, 0, 0)),
    ("pallask", (1, 0, 6)),
])
def test_simulation_launch_counts(backend, counts):
    """Exact launches per kernel module for a 25-step run: (step,
    resident in either form, K-step); warmup launches nothing.  pallask
    runs at best_k(48, 80) = 4: 6 passes and a 1-step tail."""
    params, mask_np, _ = make_case(48, 80, seed=5)
    assert kstep_kernel.best_k(48, 80) == 4
    sim = Simulation(params, mask_np, backend=backend, device="cuda")
    sim.warmup()
    def counts_now():
        return (step_kernel.launches, sum(_resident_counts().values()), kstep_kernel.launches)
    before = counts_now()
    res = sim.run(n_iters=25)
    after = counts_now()
    assert tuple(a - b for a, b in zip(after, before)) == counts
    cpu = Simulation(params, mask_np, backend=backend, device="cpu").run(n_iters=25)
    np.testing.assert_allclose(res.f_final, cpu.f_final, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res.av_vels, cpu.av_vels, rtol=1e-5)


@pytest.mark.parametrize("inplace", [True, False], ids=["inplace", "out"])
@pytest.mark.parametrize("ny,nx", [(64, 64), (100, 130), (17, 23), (170, 1100), (5, 3)])
def test_stream_matches_step_and_plain_on_card(ny, nx, inplace):
    """Two passes and a 3-step tail; 170 x 1100 has a ragged slab and two
    segments, 17 x 23 and 5 x 3 wrap more than once."""
    params, mask, f = _on_card(ny, nx, seed=ny)
    n = 2 * stream_kernel.K + 3
    before = (stream_kernel.launches, stream_kernel.snapshot_launches, step_kernel.launches)
    fk, avk = stream_kernel.run(f, mask, params, n_iters=n, inplace=inplace)
    torch.cuda.synchronize()
    after = (stream_kernel.launches, stream_kernel.snapshot_launches, step_kernel.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 3)
    fs, avs = step_kernel.run(f, mask, params, n_iters=n)
    assert int((fk != fs).sum()) == 0
    torch.testing.assert_close(avk, avs, rtol=1e-5, atol=0.0)
    fp, avp = stream_kernel.run(f.cpu(), mask.cpu(), params, n_iters=n, inplace=inplace)
    torch.testing.assert_close(fk.cpu(), fp, rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(avk.cpu(), avp, rtol=1e-5, atol=0.0)


def test_stream_pass_matches_plain_with_excluded_cells_on_card():
    params, mask, f = _on_card(96, 200, seed=9)
    ny, nx = 96, 200
    accel = torch.zeros(ny, dtype=torch.bool, device="cuda")
    accel[[7, ny - 2]] = True
    excl = torch.zeros(ny, nx, dtype=torch.bool, device="cuda")
    excl[20:40, 50:90] = True
    enc = stream_kernel.mark_reduction_excluded(stream_kernel.encode_masks(mask, accel), excl)
    out = {}
    for dev in ("cuda", "cpu"):
        g = f.to(dev).clone()
        part = torch.empty(stream_kernel.K, stream_kernel.num_tiles(ny, nx), device=dev)
        stream_kernel.stream_pass(g, enc.to(dev), params, partials=part)
        out[dev] = (g.cpu(), part.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5, atol=1e-6)


def test_simulation_stream_launch_counts():
    """25 steps on stream: 3 passes (and 3 snapshots), a 1-step tail."""
    params, mask_np, _ = make_case(48, 80, seed=6)
    sim = Simulation(params, mask_np, backend="stream", device="cuda")
    sim.warmup()
    before = (stream_kernel.launches, stream_kernel.snapshot_launches, step_kernel.launches)
    res = sim.run(n_iters=25)
    after = (stream_kernel.launches, stream_kernel.snapshot_launches, step_kernel.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (3, 3, 1)
    cpu = Simulation(params, mask_np, backend="stream", device="cpu").run(n_iters=25)
    np.testing.assert_allclose(res.f_final, cpu.f_final, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res.av_vels, cpu.av_vels, rtol=1e-5)


def test_kernel_masks_encoded_on_card_equal_the_host_encoding():
    """Simulation encodes the stream tier's and the step kernel's masks on
    the card, byte for byte the host encoding, at a ragged shape."""
    params, mask_np, _ = make_case(1000, 1030, seed=8)
    sim = Simulation(params, mask_np, backend="stream", device="cuda:0")
    host = torch.from_numpy(mask_np)
    for got, want in ((sim._enc, stream_kernel.prepare_obstacles(host)),
                      (sim._mask, step_kernel.prepare_obstacles(host))):
        assert got.device == torch.device("cuda:0") and got.dtype == torch.uint8
        assert got.cpu().numpy().tobytes() == want.numpy().tobytes()


def test_gate_refuses_a_grid_beyond_the_card_before_allocating():
    n = 65536  # one state is 155 GB
    params = LBMParams(nx=n, ny=n, max_iters=8, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    sim = Simulation(params, np.broadcast_to(False, (n, n)), backend="pallask",
                     device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with pytest.raises(ValueError, match="no single-card backend"):
        sim.warmup()
    assert torch.cuda.max_memory_allocated() < 2**20
    assert d2q9_bgk._device_memory_bytes("cuda") > 0


# ---- checkpointed runs -------------------------------------------------------------

@pytest.mark.parametrize("backend,shape,every", [
    ("resident", (64, 64), 15),   # the banded form; segments of 15, 15, 10
    ("resident", (256, 512), 15),  # the cooperative form, 4 segments a band
    ("resident", (1024, 1024), 15),  # the cooperative form
    ("pallask", (100, 130), 13),  # K = 4: 3 passes and a 1-step tail per segment
    ("stream", (170, 1100), 16),  # 2 passes per segment, no tail
])
def test_checkpointed_equals_straight_on_card(tmp_path, backend, shape, every):
    """Segments on the card's kernels: the straight run's state with 0
    differing values, av within rtol 1e-5, the launches the segments
    take, and the state kept on the card between segments."""
    params, mask_np, _ = make_case(*shape, seed=9)
    sim = Simulation(params, mask_np, backend=backend, device="cuda")
    sim.warmup()
    straight = sim.run(n_iters=40)
    counts = (step_kernel.launches, sum(_resident_counts().values()),
              kstep_kernel.launches, stream_kernel.launches)
    ck = sim.run(n_iters=40, checkpoint_every=every, checkpoint_dir=tmp_path)
    after = (step_kernel.launches, sum(_resident_counts().values()),
             kstep_kernel.launches, stream_kernel.launches)
    segs = [every] * (40 // every) + ([40 % every] if 40 % every else [])
    k = kstep_kernel.best_k(*shape)
    want = {"resident": (0, len(segs), 0, 0),
            "pallask": (sum(s % k for s in segs), 0, sum(s // k for s in segs), 0),
            "stream": (sum(s % 8 for s in segs), 0, 0, sum(s // 8 for s in segs))}[backend]
    assert tuple(a - b for a, b in zip(after, counts)) == want
    assert int((torch.from_numpy(ck.f_final) != torch.from_numpy(straight.f_final)).sum()) == 0
    np.testing.assert_allclose(ck.av_vels, straight.av_vels, rtol=1e-5)


def test_resume_on_card_equals_straight(tmp_path):
    params, mask_np, _ = make_case(128, 128, seed=10)
    sim = Simulation(params, mask_np, backend="pallask", device="cuda")
    sim.run(n_iters=23, checkpoint_every=10, checkpoint_dir=tmp_path)
    resumed = sim.run(n_iters=41, checkpoint_every=10, checkpoint_dir=tmp_path, resume=True)
    straight = sim.run(n_iters=41)
    assert int((torch.from_numpy(resumed.f_final) != torch.from_numpy(straight.f_final)).sum()) == 0
    np.testing.assert_allclose(resumed.av_vels, straight.av_vels, rtol=1e-5)


def test_batch_on_card_matches_sequential_fused():
    from advanced_hpc_lbm_tpu_torch.parallel import batch

    params, mask_np, _ = make_case(64, 96, seed=11)
    masks = torch.from_numpy(np.stack([mask_np, mask_np[::-1].copy()]))
    fs, avs = batch.batch_run(batch.batch_initial_state(params, 2, "cuda"), masks, params,
                              devices=["cuda:0", "cuda:0"])
    for b in range(2):
        one = Simulation(params, masks[b].numpy(), backend="fused", device="cuda").run()
        np.testing.assert_allclose(fs[b].cpu().numpy(), one.f_final, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(avs[b].cpu().numpy(), one.av_vels, rtol=1e-6)


# ---- the sharded path -----------------------------------------------------------

def _local_window(h, w, seed, accel_rows):
    params, mask_np, f0 = make_case(h, w, seed)
    accel = torch.zeros(h, dtype=torch.bool)
    accel[list(accel_rows)] = True
    enc = stream_kernel.encode_masks(torch.from_numpy(mask_np), accel)
    return params, torch.from_numpy(f0).cuda(), enc.cuda()


@pytest.mark.parametrize("kind,k,ly,lx,rows", [
    ("1d", 1, 2, 64, (3,)), ("1d", 1, 17, 23, (0,)), ("1d", 1, 100, 130, (50,)),
    ("2d", 1, 2, 3, (3,)), ("2d", 1, 17, 23, (1,)), ("2d", 1, 64, 64, (0, 64)),
    ("ca", 2, 4, 64, (1, 5)), ("ca", 4, 40, 130, (43,)), ("ca", 8, 17, 23, (1, 20)),
])
def test_local_kernels_match_plain_on_card(kind, k, ly, lx, rows):
    """Each local kernel against its plain version: the forcing row on a
    halo row, an own row, and twice in a K-step window."""
    g = k if kind == "ca" else 1
    params, win, enc = _local_window(ly + 2 * g, lx + 2 if kind == "2d" else lx, ly + k, rows)
    outs = []
    for plain in (False, True):
        out = torch.empty(9, ly, lx, device="cuda")
        if kind == "ca":
            part = torch.empty(k, local_kernel.num_tiles(ly, lx), device="cuda")
            fn = local_kernel.plain_local_ca_steps if plain else local_kernel.local_ca_steps
            fn(win, enc, params, k, out=out, partials=part)
        else:
            part = torch.empty(local_kernel.num_partials(ly, lx), device="cuda")
            if plain:
                local_kernel.plain_local_step(win, enc, params, out=out, partials=part,
                                              torus=kind == "2d")
            else:
                fn = local_kernel.local_step_2d if kind == "2d" else local_kernel.local_step
                fn(win, enc, params, out=out, partials=part)
        outs.append((out, part.reshape(k, -1).sum(dim=1)))
    torch.cuda.synchronize()
    assert int((outs[0][0] != outs[1][0]).sum()) == 0
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("shape,kw,counts", [
    (4, {"kernel": "pallas"}, {"local": 4 * 37}),
    (4, {"kernel": "pallas", "ca_steps": 4}, {"ca": 4 * 9, "local": 4}),
    (4, {"kernel": "stream"}, {"stream": 4 * 4, "local": 4 * 5}),
    ((2, 2), {"kernel": "pallas"}, {"local2d": 4 * 37}),
    ((2, 2), {"kernel": "stream"}, {"stream": 4 * 4, "local2d": 4 * 5}),
])
def test_four_shards_of_one_card_equal_pallask(monkeypatch, shape, kw, counts):
    """Four shards on cuda:0, real halo copies between separate
    allocations: the state of single-device pallask with 0 differing
    values, exact launches per kernel, and no plain version reached."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")
    for mod, name in ((local_kernel, "plain_local_step"), (local_kernel, "plain_local_ca_steps"),
                      (stream_kernel, "plain_multi_step")):
        monkeypatch.setattr(mod, name, refuse)
    params, mask_np, f0 = make_case(256, 256, seed=8)
    ref_f, ref_av = kstep_kernel.run(torch.from_numpy(f0).cuda(), torch.from_numpy(mask_np).cuda(),
                                     params, n_iters=37, k=4)
    names = {"local": "launches", "local2d": "launches_2d", "ca": "ca_launches"}
    before = {n: getattr(local_kernel, a) for n, a in names.items()}
    before["stream"] = stream_kernel.launches
    four = ["cuda:0"] * 4
    if isinstance(shape, tuple):
        f, av = halo.run_sharded_2d(f0, mask_np, params, shape, n_iters=37, devices=four, **kw)
    else:
        f, av = halo.run_sharded(f0, mask_np, params, n_iters=37, devices=four, **kw)
    torch.cuda.synchronize()
    after = {n: getattr(local_kernel, a) for n, a in names.items()}
    after["stream"] = stream_kernel.launches
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == counts
    for rows, cols, blk in f.blocks():
        assert int((blk != ref_f[:, rows, cols]).sum()) == 0
    torch.testing.assert_close(av, ref_av, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("debug", [False, True])
def test_overlap_on_card_equals_default(debug):
    """The overlapped ring schedule on four shards of cuda:0 (the exchange
    on a side stream while the interior rows compute): the state, av and
    densities of the default schedule, bitwise."""
    params, mask_np, f0 = make_case(64, 128, seed=9)
    four = ["cuda:0"] * 4
    outs = [halo.run_sharded(f0, mask_np, params, n_iters=11, devices=four, overlap=overlap,
                             collect_density=debug) for overlap in (False, True)]
    torch.cuda.synchronize()
    (f_d, *rest_d), (f_o, *rest_o) = outs
    for (_, _, a), (_, _, b) in zip(f_d.blocks(), f_o.blocks()):
        assert torch.equal(a, b)
    for a, b in zip(rest_d, rest_o):
        assert torch.equal(a, b)


# ---- the sharded path across cards ----------------------------------------------------

two_cards = pytest.mark.skipif("torch.cuda.device_count() < 2", reason="needs two CUDA cards")
four_cards = pytest.mark.skipif("torch.cuda.device_count() < 4", reason="needs four CUDA cards")


def _same_mesh(got, want) -> None:
    """Two sharded results of one mesh shape: every own block with 0
    differing values, the shards of ``got`` on distinct cards."""
    blocks = list(got.blocks())
    assert len({blk.device for _, _, blk in blocks}) == len(blocks)
    for (_, _, a), (_, _, b) in zip(blocks, want.blocks()):
        assert int((a != b.to(a.device)).sum()) == 0


@two_cards
@pytest.mark.parametrize("kw", [{"kernel": "pallas"}, {"kernel": "pallas", "ca_steps": 4},
                                {"kernel": "stream"}], ids=["pallas", "pallas-K4", "stream"])
def test_two_card_ring_equals_the_same_mesh_on_one_card(kw):
    """A ring of two shards on cuda:0 and cuda:1 (copies between the cards)
    against the same ring on cuda:0 alone: the state with 0 differing
    values, av and the densities bitwise (the same sums in the same
    order)."""
    params, mask_np, f0 = make_case(256, 256, seed=12)
    outs = [halo.run_sharded(f0, mask_np, params, n_iters=37, devices=devs, **kw)
            for devs in (["cuda:0", "cuda:1"], ["cuda:0"] * 2)]
    torch.cuda.synchronize()
    (f, av), (ref_f, ref_av) = outs
    _same_mesh(f, ref_f)
    assert torch.equal(av, ref_av)


@two_cards
@pytest.mark.parametrize("debug", [False, True])
def test_overlap_across_two_cards_equals_default(debug):
    """The overlapped jnp ring with its shards on two cards (the exchange on
    each destination card's side stream): the default schedule's state, av
    and densities, bitwise, and those of the same ring on cuda:0 alone."""
    params, mask_np, f0 = make_case(64, 128, seed=13)
    two = ["cuda:0", "cuda:1"]
    outs = [halo.run_sharded(f0, mask_np, params, n_iters=11, devices=devs, overlap=overlap,
                             collect_density=debug)
            for devs, overlap in ((two, False), (two, True), (["cuda:0"] * 2, True))]
    torch.cuda.synchronize()
    (f_d, *rest_d), (f_o, *rest_o), (f_1, *rest_1) = outs
    _same_mesh(f_o, f_d)
    _same_mesh(f_o, f_1)
    for a, b, c in zip(rest_d, rest_o, rest_1):
        assert torch.equal(a, b) and torch.equal(b, c)


@two_cards
def test_simulation_shards_over_every_visible_card():
    """``--backend sharded`` takes the visible cards by default, one shard
    each, and equals the same ring laid on cuda:0 alone."""
    n = torch.cuda.device_count()
    params, mask_np, _ = make_case(32 * n, 96, seed=14)
    sim = Simulation(params, mask_np, backend="sharded", device="cuda")
    res = sim.run(n_iters=21, fetch=False, shard_kernel="pallas")
    ref = sim.run(n_iters=21, fetch=False, shard_kernel="pallas", devices=n,
                  shard_devices=["cuda:0"] * n)
    assert sorted(str(blk.device) for _, _, blk in res.f_final.blocks()) == [
        f"cuda:{i}" for i in range(n)]
    _same_mesh(res.f_final, ref.f_final)
    assert torch.equal(res.av_vels, ref.av_vels)


@four_cards
@pytest.mark.parametrize("kw", [{"kernel": "pallas"}, {"kernel": "stream"}],
                         ids=["pallas", "stream"])
def test_four_card_torus_equals_the_same_mesh_on_one_card(kw):
    """A 2x2 torus over four cards (rows, then the row-extended columns with
    the corners, between the cards) against the same torus on cuda:0."""
    params, mask_np, f0 = make_case(256, 256, seed=15)
    four = ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    outs = [halo.run_sharded_2d(f0, mask_np, params, (2, 2), n_iters=37, devices=devs, **kw)
            for devs in (four, ["cuda:0"] * 4)]
    torch.cuda.synchronize()
    (f, av), (ref_f, ref_av) = outs
    _same_mesh(f, ref_f)
    assert torch.equal(av, ref_av)


def test_collide_flat_refuses_tf32_on_card(monkeypatch):
    """The matrix collide in full float32 on the card matches the vector
    collide; with TF32 allowed (either switch) it raises."""
    from advanced_hpc_lbm_tpu_torch.ops import kernel_common, mxu_collide

    params, mask_np, f0 = make_case(64, 128, seed=10)
    flat = torch.from_numpy(f0.reshape(9, -1)).cuda()
    obst = torch.from_numpy(mask_np.reshape(-1)).cuda()
    out, usq = mxu_collide.collide_flat(flat, obst, params)
    ref, ref_usq = kernel_common.collide(list(flat.reshape(9, 64, 128)), obst.reshape(64, 128),
                                         params)
    torch.testing.assert_close(out.reshape(9, 64, 128), torch.stack(ref), rtol=2e-5, atol=2e-7)
    torch.testing.assert_close(usq.reshape(64, 128), ref_usq, rtol=5e-4, atol=1e-12)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        mxu_collide.collide_flat(flat, obst, params)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch, "get_float32_matmul_precision", lambda: "high")
    with pytest.raises(RuntimeError, match="TF32"):
        mxu_collide.collide_flat(flat, obst, params)
