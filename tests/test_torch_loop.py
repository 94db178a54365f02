"""The one run loop (``ops/loop.py``) under the step, K-step, stream and
resident runs, on the CPU (the kernels' plain versions): the state and the
av history are equal bit for bit at every chunk size, and the state equals
the step kernel's run; the resident run's av history does too, as it
writes the step kernel's partials.  The K-step and stream kernels sum
||u|| over other tiles, so their av histories are held to the step run's
elsewhere, within a tolerance (tests/test_torch_{kstep,stream}.py)."""

import numpy as np
import pytest
import torch

from advanced_hpc_lbm_tpu_torch.ops import (
    kstep_kernel, reference, resident, step_kernel, stream_kernel,
)
from advanced_hpc_lbm_tpu_torch.params import LBMParams

ITERS = 11  # a tail on the step kernel after passes of K = 2, 3, 4 and 8


def _case(ny, nx):
    params = LBMParams(nx=nx, ny=ny, max_iters=ITERS, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(ny + nx)
    mask = rng.rand(ny, nx) < 0.1
    mask[0] = mask[-1] = True
    f0 = reference.initial_state(params, "cpu") * torch.from_numpy(
        rng.uniform(0.8, 1.2, (9, ny, nx)).astype(np.float32))
    return params, torch.from_numpy(mask), f0


RUNS = {  # name: (run(f0, mask, params, chunk), steps a pass, av equals step's)
    "step": (lambda f, m, p, c: step_kernel.run(f, m, p, chunk=c), 1, True),
    "kstep2": (lambda f, m, p, c: kstep_kernel.run(f, m, p, k=2, chunk=c), 2, False),
    "kstep3": (lambda f, m, p, c: kstep_kernel.run(f, m, p, k=3, chunk=c), 3, False),
    "kstep4": (lambda f, m, p, c: kstep_kernel.run(f, m, p, k=4, chunk=c), 4, False),
    "stream": (lambda f, m, p, c: stream_kernel.run(f, m, p, chunk=c), stream_kernel.K, False),
    "resident": (lambda f, m, p, c: resident.resident_run(f, m, p, chunk=c), 1, True),
}


@pytest.mark.parametrize("ny,nx", [(17, 23), (100, 130)])
@pytest.mark.parametrize("name", list(RUNS))
def test_loop_is_bitwise_across_chunk_sizes(name, ny, nx):
    run, k, av_as_step = RUNS[name]
    params, mask, f0 = _case(ny, nx)
    want_f, want_av = step_kernel.run(f0, mask, params)
    outs = {c: run(f0, mask, params, c) for c in sorted({1, k, k + 1, 10 * ITERS})}
    f1, av1 = outs[1]
    assert av1.shape == (ITERS,)
    assert torch.equal(f1, want_f)
    if av_as_step:
        assert torch.equal(av1, want_av)
    for c, (f, av) in outs.items():
        assert torch.equal(f, f1), c
        assert torch.equal(av, av1), c
