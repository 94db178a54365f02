"""The CUDA step kernel on the card, against its plain PyTorch version on
the same card.  Skipped where PyTorch sees no CUDA device.

This file imports no JAX, so that the card's host, which has none, can run
it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Built with -fmad=false and the plain version's op order, the kernel is
expected to match bit for bit; the stated tolerance is f within rtol 1e-6 /
atol 1e-8, and av within rtol 1e-5 (the kernel sums ||u|| by a block tree,
PyTorch by its own reduction order).
"""

import numpy as np
import pytest
import torch

from advanced_hpc_lbm_tpu_torch import Simulation
from advanced_hpc_lbm_tpu_torch.ops import reference, step_kernel
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
