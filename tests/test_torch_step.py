"""The step kernel's wrapper on the CPU (its plain PyTorch version) against
the JAX package's per-step Pallas kernel and fused step.

On a CPU tensor ``step_kernel.step`` runs ``plain_step``, the same float32
math as ``csrc/step_kernel.cu``; the card itself is covered by
tests/test_torch_cuda.py and chip_smoke.py.  Tolerances are those of
tests/test_pallas.py: f within rtol 1e-5 / atol 1e-7, av within rtol 1e-5
for one step and 1e-4 over a trajectory (the kernels reduce ||u|| over the
pre-collision moments, ``fused_step`` over the post-collision ones).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_hpc_lbm_tpu.ops import fused as jfused
from advanced_hpc_lbm_tpu.ops import pallas_step
from advanced_hpc_lbm_tpu.ops import reference as jref
from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu_torch.ops import _build, step_kernel
from advanced_hpc_lbm_tpu_torch.params import LBMParams

F_TOL = dict(rtol=1e-5, atol=1e-7)


def make_case(ny, nx, seed=0, box=True, guard_fail=False):
    """As tests/test_pallas.py:make_case, in numpy: equilibrium x
    uniform(0.8, 1.2), a box, a block and random obstacles."""
    jp = JaxParams(nx=nx, ny=ny, max_iters=4, reynolds_dim=10,
                   density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = np.zeros((ny, nx), dtype=bool)
    if box:
        mask[0] = mask[-1] = True
        mask[ny // 2: ny // 2 + 2, nx // 3: nx // 2] = True
        for _ in range(6):
            mask[rng.randint(1, ny - 1), rng.randint(0, nx)] = True
    f0 = np.asarray(jref.initial_state(jp)) * rng.uniform(
        0.8, 1.2, (9, ny, nx)).astype(np.float32)
    if guard_fail:
        f0[3, ny - 2, : nx // 2] = jp.accel_w1 * np.float32(0.5)
    return jp, mask, f0


def port_steps(jp, mask, f0, steps):
    """``steps`` calls of the port's kernel-backed ``fused_step``."""
    p = LBMParams.from_jax(jp)
    obst = torch.from_numpy(mask)
    n_fluid = torch.sum(~obst).to(torch.float32)
    f = torch.from_numpy(f0.copy())
    avs = []
    for _ in range(steps):
        f, av = step_kernel.fused_step(f, obst, n_fluid, p)
        avs.append(float(av))
    return f.numpy(), np.array(avs, np.float32)


def jax_steps(step_fn, jp, mask, f0, steps, **kw):
    obst = jnp.asarray(mask)
    if step_fn is pallas_step.pallas_fused_step:
        obst = pallas_step.prepare_obstacles(obst)
    n_fluid = jnp.sum(~jnp.asarray(mask)).astype(jnp.float32)
    f = jnp.asarray(f0)
    avs = []
    for _ in range(steps):
        f, av = step_fn(f, obst, n_fluid, jp, **kw)
        avs.append(av)
    return np.asarray(f), np.asarray(jnp.stack(avs))


@pytest.mark.parametrize("ny,nx", [(32, 128), (64, 128), (64, 256)])
def test_single_step_matches_pallas_kernel(ny, nx):
    jp, mask, f0 = make_case(ny, nx)
    fa, ava = jax_steps(pallas_step.pallas_fused_step, jp, mask, f0, 1, interpret=True)
    fb, avb = port_steps(jp, mask, f0, 1)
    np.testing.assert_allclose(fb, fa, **F_TOL)
    np.testing.assert_allclose(avb, ava, rtol=1e-5)


@pytest.mark.parametrize("ny,nx", [(64, 64), (17, 23)])
def test_single_step_matches_fused(ny, nx):
    jp, mask, f0 = make_case(ny, nx, seed=1)
    fa, ava = jax_steps(jfused.fused_step, jp, mask, f0, 1)
    fb, avb = port_steps(jp, mask, f0, 1)
    np.testing.assert_allclose(fb, fa, **F_TOL)
    np.testing.assert_allclose(avb, ava, rtol=1e-5)


@pytest.mark.parametrize("ny,nx", [(64, 64), (17, 23)])
def test_trajectory_matches_fused(ny, nx):
    jp, mask, f0 = make_case(ny, nx, seed=3)
    fa, ava = jax_steps(jfused.fused_step, jp, mask, f0, 5)
    fb, avb = port_steps(jp, mask, f0, 5)
    np.testing.assert_allclose(fb, fa, **F_TOL)
    np.testing.assert_allclose(avb, ava, rtol=1e-4)


@pytest.mark.parametrize("ny,nx", [(64, 64), (17, 23)])
def test_guard_failing_forcing_row_matches_fused(ny, nx):
    jp, mask, f0 = make_case(ny, nx, seed=4, guard_fail=True)
    row = f0[:, ny - 2]
    starved = ~mask[ny - 2] & ~(row[3] - jp.accel_w1 > 0)
    assert starved.any()  # the case does exercise the guard
    fa, ava = jax_steps(jfused.fused_step, jp, mask, f0, 3)
    fb, avb = port_steps(jp, mask, f0, 3)
    np.testing.assert_allclose(fb, fa, **F_TOL)
    np.testing.assert_allclose(avb, ava, rtol=1e-4)


def test_periodic_wrap_rows_match_pallas():
    jp, mask, f0 = make_case(32, 128, box=False)
    f0[4, 0, :] += 0.5  # south-moving mass in row 0 lands in row ny-1
    f0[2, -1, :] += 0.25  # north-moving mass in row ny-1 lands in row 0
    fa, _ = jax_steps(pallas_step.pallas_fused_step, jp, mask, f0, 1, interpret=True)
    fb, _ = port_steps(jp, mask, f0, 1)
    np.testing.assert_allclose(fb, fa, **F_TOL)


# ---- the wrapper's own contract ---------------------------------------------------

@pytest.mark.parametrize("ny,nx", [(8, 32), (17, 23), (64, 64), (100, 130)])
def test_partials_are_per_block_sums(ny, nx):
    rng = np.random.RandomState(0)
    norm = rng.rand(ny, nx).astype(np.float32)
    got = step_kernel.block_sums(torch.from_numpy(norm)).numpy()
    gy, gx = -(-ny // step_kernel.BLOCK_Y), -(-nx // step_kernel.BLOCK_X)
    assert got.shape == (step_kernel.num_partials(ny, nx),) == (gy * gx,)
    want = [
        norm[by * step_kernel.BLOCK_Y:(by + 1) * step_kernel.BLOCK_Y,
             bx * step_kernel.BLOCK_X:(bx + 1) * step_kernel.BLOCK_X].sum(dtype=np.float64)
        for by in range(gy) for bx in range(gx)
    ]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cpu_step_counts_no_launch():
    jp, mask, f0 = make_case(16, 32)
    before = step_kernel.launches
    port_steps(jp, mask, f0, 2)
    assert step_kernel.launches == before


def _step_args(ny=16, nx=32):
    jp, mask, f0 = make_case(ny, nx)
    f = torch.from_numpy(f0)
    return dict(
        f=f, mask=step_kernel.prepare_obstacles(torch.from_numpy(mask)),
        params=LBMParams.from_jax(jp), out=torch.empty_like(f),
        partials=torch.empty(step_kernel.num_partials(ny, nx)),
    )


@pytest.mark.parametrize("bad", ["alias", "alias_partials", "dtype", "mask_dtype",
                                 "mask_shape", "partials_shape", "noncontig"])
def test_step_rejects_bad_arguments(bad):
    a = _step_args()
    if bad == "alias":
        a["out"] = a["f"]
    elif bad == "alias_partials":
        a["partials"] = a["f"].view(-1)[: a["partials"].numel()]
    elif bad == "dtype":
        a["f"] = a["f"].double()
    elif bad == "mask_dtype":
        a["mask"] = a["mask"].bool()
    elif bad == "mask_shape":
        a["mask"] = a["mask"][:-1]
    elif bad == "partials_shape":
        a["partials"] = torch.empty(3)
    elif bad == "noncontig":
        a["f"] = a["f"].transpose(1, 2).contiguous().transpose(1, 2)
    f = a.pop("f")
    with pytest.raises(ValueError):
        step_kernel.step(f, **a)


@pytest.mark.parametrize("iters,chunk", [(7, 3), (6, 6), (5, 1000), (0, 1000)])
def test_run_chunks_match_stepwise(iters, chunk):
    """Chunked partial sums (several chunks, a short tail, a single chunk,
    no steps) give the per-step av of one fused_step at a time."""
    jp, mask, f0 = make_case(17, 23, seed=5)
    p = LBMParams.from_jax(jp)
    f_in = torch.from_numpy(f0.copy())
    f_run, av_run = step_kernel.run(f_in, torch.from_numpy(mask), p, n_iters=iters, chunk=chunk)
    fb, avb = port_steps(jp, mask, f0, iters)
    assert av_run.shape == (iters,)
    np.testing.assert_array_equal(f_run.numpy(), fb if iters else f0)
    np.testing.assert_allclose(av_run.numpy(), avb, rtol=1e-6)
    np.testing.assert_array_equal(f_in.numpy(), f0)  # f0 is not modified


def test_run_collects_conserved_density():
    jp, mask, f0 = make_case(16, 32, seed=6)
    _, av, dens = step_kernel.run(torch.from_numpy(f0), torch.from_numpy(mask),
                                  LBMParams.from_jax(jp), n_iters=4, collect_density=True)
    assert av.shape == dens.shape == (4,)
    np.testing.assert_allclose(dens.numpy(), f0.sum(dtype=np.float64), rtol=1e-5)


def test_prepare_on_cpu_builds_nothing(monkeypatch):
    monkeypatch.setattr(_build, "build", lambda: pytest.fail("built on the CPU"))
    step_kernel.prepare("cpu")


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build fails with a clear error and writes nothing."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_library_path_keys_on_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path()
    assert {p.name for p in _build._sources()} >= {"step_kernel.cu", "step_common.cuh"}
