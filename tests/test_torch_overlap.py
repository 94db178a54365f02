"""The port's overlapped ring schedule (``overlap=True``), case for case
with tests/test_overlap.py.

The 1-step jnp ring step issues the halo exchange first, computes the
interior rows from the own rows while it is in flight, and computes the
two edge rows last.  The per-row math is the same, so the states, the av
history and the debug densities are bitwise equal to the default schedule
(the JAX test holds its densities to rtol 1e-4 only, because XLA may fuse
the density sum differently; the port sums the same tensor either way).
Against the JAX package's overlapped run on its virtual CPU devices: f
within rtol 1e-5 / atol 1e-7 and av within rtol 1e-5, as
tests/test_torch_sharded.py holds the default schedule.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from advanced_hpc_lbm_tpu.parallel import halo as jhalo
from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu_torch.ops import reference
from advanced_hpc_lbm_tpu_torch.parallel import halo
from advanced_hpc_lbm_tpu_torch.params import LBMParams


def _deck(ny, nx, iters, seed=11):
    """tests/test_overlap.py's deck."""
    params = LBMParams(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = rng.rand(ny, nx) < 0.05
    mask[0] = True
    mask[ny - 2] = False
    return params, mask


def _run(params, mask, n, **kw):
    out = halo.run_sharded(reference.initial_state(params, "cpu"), mask, params,
                           devices=["cpu"] * n, **kw)
    return (out[0].numpy(), *(o.numpy() for o in out[1:]))


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_overlap_bitwise_equals_default(n_devices):
    params, mask = _deck(32, 128, iters=7)
    f_d, av_d = _run(params, mask, n_devices)
    f_o, av_o = _run(params, mask, n_devices, overlap=True)
    np.testing.assert_array_equal(f_o, f_d)
    np.testing.assert_array_equal(av_o, av_d)


def test_overlap_with_debug_densities():
    params, mask = _deck(32, 128, iters=5)
    out_d = _run(params, mask, 4, collect_density=True)
    out_o = _run(params, mask, 4, collect_density=True, overlap=True)
    for got, want in zip(out_o, out_d):  # f, av and the densities, all bitwise
        np.testing.assert_array_equal(got, want)


def test_overlap_rejects_nonjnp_schedules():
    params, _ = _deck(32, 128, iters=4)
    with pytest.raises(ValueError, match="1-step jnp"):
        halo.prepare_sharded(params, 4, n_devices=4, devices=["cpu"] * 4, ca_steps=2,
                             overlap=True)
    with pytest.raises(ValueError, match="1-step jnp"):
        halo.prepare_sharded(params, 4, n_devices=4, devices=["cpu"] * 4, kernel="pallas",
                             overlap=True)


def test_overlap_rejects_two_row_slabs():
    params, _ = _deck(16, 128, iters=4)
    with pytest.raises(ValueError, match="interior"):
        halo.prepare_sharded(params, 4, n_devices=8, devices=["cpu"] * 8, overlap=True)


@pytest.mark.parametrize("n_devices,debug", [(2, False), (4, True), (8, False)])
def test_overlap_matches_jax_overlap(n_devices, debug):
    """From a perturbed equilibrium, where ||u|| is resolved in float32.
    From the rest state of ``_deck`` the first step's ||u|| is mostly the
    rounding of populations near 0.011: there the port's av of step 0
    differs from the JAX package's by 4.4e-5 relative on the default
    schedule as on the overlapped one, and on one shard as on 8 (the
    same float32 formula, which XLA contracts differently)."""
    params, mask = _deck(32, 128, iters=7, seed=n_devices)
    rng = np.random.RandomState(n_devices)
    f0 = (reference.initial_state(params, "cpu").numpy()
          * rng.uniform(0.8, 1.2, (9, 32, 128)).astype(np.float32))
    jp = JaxParams(nx=128, ny=32, max_iters=7, reynolds_dim=10, density=0.1, accel=0.005,
                   omega=1.85)
    ref = jhalo.run_sharded(jnp.asarray(f0), jnp.asarray(mask), jp, n_devices=n_devices,
                            overlap=True, collect_density=debug)
    out = halo.run_sharded(f0, mask, params, devices=["cpu"] * n_devices, overlap=True,
                           collect_density=debug)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-7)
    for got, want in zip(out[1:], ref[1:]):  # av, and the densities
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_overlap_bitwise_from_a_forcing_row_on_an_edge_row():
    """Row ny-2 is the last own row of the last shard (ly = 3): the forcing
    lands on an edge row, which the overlapped step computes after the
    exchange."""
    params, mask = _deck(12, 64, iters=6, seed=3)
    f_d, av_d = _run(params, mask, 4)
    f_o, av_o = _run(params, mask, 4, overlap=True)
    np.testing.assert_array_equal(f_o, f_d)
    np.testing.assert_array_equal(av_o, av_d)
