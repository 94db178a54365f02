"""The CUDA kernels on the card (step, resident, K-step), against their
plain PyTorch versions on the same card and against each other.  Skipped
where PyTorch sees no CUDA device.

This file imports no JAX, so that the card's host, which has none, can run
it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Built with -fmad=false and the plain version's op order, the kernels are
expected to match bit for bit; the stated tolerance is f within rtol 1e-6 /
atol 1e-8, and av within rtol 1e-5 (the kernel sums ||u|| by a block tree,
PyTorch by its own reduction order).  The resident and K-step kernels run
the step kernel's per-cell code, so their state equals the step kernel's
with 0 differing values.
"""

import numpy as np
import pytest
import torch

from advanced_hpc_lbm_tpu_torch import Simulation
from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel, reference, resident, step_kernel
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


@pytest.mark.parametrize("ny,nx", [(64, 64), (100, 130), (17, 23), (256, 512)])
def test_resident_matches_step_and_plain_on_card(ny, nx):
    params, mask, f = _on_card(ny, nx, seed=3)
    before = resident.launches
    fr, avr = resident.resident_run(f, mask, params, n_iters=17, chunk=6)
    torch.cuda.synchronize()
    assert resident.launches - before == 3  # chunks of 6, 6 and 5 steps
    fs, avs = step_kernel.run(f, mask, params, n_iters=17)
    assert int((fr != fs).sum()) == 0
    torch.testing.assert_close(avr, avs, rtol=1e-5, atol=0.0)
    fp, avp = resident.resident_run(f.cpu(), mask.cpu(), params, n_iters=17, chunk=6)
    torch.testing.assert_close(fr.cpu(), fp, rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(avr.cpu(), avp, rtol=1e-5, atol=0.0)


def test_oversized_cooperative_grid_raises():
    """10**6 blocks exceed any card's co-resident limit (132 SMs x at most
    32 blocks): the launch is refused, and the wrapper raises."""
    params, mask, f = _on_card(64, 64, seed=4)
    mask = step_kernel.prepare_obstacles(mask)
    part = torch.empty(2, step_kernel.num_partials(64, 64), device="cuda")
    run_chunk = resident._chunk_launcher(f, mask, params, blocks=10**6)
    with pytest.raises(RuntimeError, match="resident kernel launch failed"):
        run_chunk((f.clone(), torch.empty_like(f)), 2, part)
    # the refusal is not reported again by the next launch
    step_kernel.run(f, mask, params, n_iters=2)
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", [2, 4, 6, 8])
@pytest.mark.parametrize("ny,nx", [(64, 64), (64, 128), (100, 130), (17, 23)])
def test_kstep_matches_step_and_plain_on_card(ny, nx, k):
    params, mask, f = _on_card(ny, nx, seed=k)
    n = 3 * k + 1  # three passes and a 1-step tail
    before = (kstep_kernel.launches, step_kernel.launches)
    fk, avk = kstep_kernel.run(f, mask, params, n_iters=n, k=k)
    torch.cuda.synchronize()
    assert (kstep_kernel.launches - before[0], step_kernel.launches - before[1]) == (3, 1)
    fs, avs = step_kernel.run(f, mask, params, n_iters=n)
    assert int((fk != fs).sum()) == 0
    torch.testing.assert_close(avk, avs, rtol=1e-5, atol=0.0)
    fp, avp = kstep_kernel.run(f.cpu(), mask.cpu(), params, n_iters=n, k=k)
    torch.testing.assert_close(fk.cpu(), fp, rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(avk.cpu(), avp, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("backend,counts", [
    ("resident", (0, 1, 0)), ("pallas2", (1, 0, 12)), ("pallas", (25, 0, 0)),
    ("pallask", (1, 0, 4)),
])
def test_simulation_launch_counts(backend, counts):
    """Exact launches per kernel module for a 25-step run: (step,
    resident, K-step); warmup launches nothing.  pallask runs at
    best_k(48, 80) = 6: 4 passes and a 1-step tail."""
    params, mask_np, _ = make_case(48, 80, seed=5)
    assert kstep_kernel.best_k(48, 80) == 6
    sim = Simulation(params, mask_np, backend=backend, device="cuda")
    sim.warmup()
    before = (step_kernel.launches, resident.launches, kstep_kernel.launches)
    res = sim.run(n_iters=25)
    after = (step_kernel.launches, resident.launches, kstep_kernel.launches)
    assert tuple(a - b for a, b in zip(after, before)) == counts
    cpu = Simulation(params, mask_np, backend=backend, device="cpu").run(n_iters=25)
    np.testing.assert_allclose(res.f_final, cpu.f_final, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res.av_vels, cpu.av_vels, rtol=1e-5)
