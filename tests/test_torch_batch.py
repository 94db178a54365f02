"""Batched independent runs in the port against the JAX package's
``batch_run`` and against sequential single runs.

The port runs the batch as the ``fused`` step over a leading batch axis
(batched PyTorch ops), as the JAX package ``vmap``s its jnp fused step.
Against the JAX batch: f within rtol 1e-5 / atol 1e-7; av within rtol 1e-4,
the trajectory tolerance of tests/test_torch_model.py's
test_plain_backends_match_jax, because the two frameworks sum ||u|| over the
grid in another order, and on the small velocities of a run from rest one
deck's av of the two packages' single-deck ``fused`` runs differ by up to
3.3e-5 relative here.  Against sequential port runs of its decks a batch
agrees within rtol 1e-6 (the same arithmetic per deck; a reduction over a
batched tensor may sum in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_hpc_lbm_tpu.parallel import batch as jbatch
from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu_torch import LBMParams, Simulation
from advanced_hpc_lbm_tpu_torch.ops import fused, reference, step_kernel
from advanced_hpc_lbm_tpu_torch.parallel import batch


@pytest.fixture(scope="module")
def decks():
    params = LBMParams(nx=32, ny=40, max_iters=30, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(11)
    masks = []
    for _ in range(4):
        mask = np.zeros((params.ny, params.nx), dtype=bool)
        mask[0] = mask[-1] = True
        for _ in range(6):
            mask[rng.randint(1, params.ny - 1), rng.randint(0, params.nx)] = True
        masks.append(mask)
    return params, np.stack(masks)


@pytest.fixture(scope="module")
def port_batch(decks):
    params, masks = decks
    f0 = batch.batch_initial_state(params, len(masks), "cpu")
    return batch.batch_run(f0, torch.from_numpy(masks), params)


def test_batch_matches_jax_batch(decks, port_batch):
    params, masks = decks
    jparams = JaxParams(**dataclasses.asdict(params))
    fs_j, avs_j = jbatch.batch_run(jbatch.batch_initial_state(jparams, len(masks)),
                                   jnp.asarray(masks), jparams)
    fs, avs = port_batch
    assert fs.shape == (4, 9, params.ny, params.nx) and avs.shape == (4, params.max_iters)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fs_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(avs.numpy(), np.asarray(avs_j), rtol=1e-4)


def test_batch_matches_sequential_port_runs(decks, port_batch):
    params, masks = decks
    fs, avs = port_batch
    for b, mask in enumerate(masks):
        one = Simulation(params, mask, backend="fused", device="cpu").run()
        np.testing.assert_allclose(avs[b].numpy(), one.av_vels, rtol=1e-6)
        np.testing.assert_allclose(fs[b].numpy(), one.f_final, rtol=1e-6, atol=1e-8)


def test_replicated_decks_identical_trajectories(decks):
    params, masks = decks
    _, avs = batch.batch_run(batch.batch_initial_state(params, 5, "cpu"),
                             batch.replicate(masks[0], 5), params)
    for b in range(1, 5):
        np.testing.assert_array_equal(avs[b].numpy(), avs[0].numpy())


def test_batch_helpers(decks):
    params, masks = decks
    f0 = batch.batch_initial_state(params, 3, "cpu")
    assert f0.shape == (3, 9, params.ny, params.nx) and f0.is_contiguous()
    np.testing.assert_array_equal(f0[2].numpy(), reference.initial_state(params, "cpu").numpy())
    for obst in (masks[1], torch.from_numpy(masks[1])):
        rep = batch.replicate(obst, 3)
        assert rep.shape == (3, params.ny, params.nx) and rep.dtype == torch.bool
        assert bool((rep == torch.from_numpy(masks[1])).all())


def test_split_over_two_devices_equals_unsplit(decks, port_batch):
    params, masks = decks
    fs_s, avs_s = batch.batch_run(batch.batch_initial_state(params, 4, "cpu"),
                                  torch.from_numpy(masks), params, devices=["cpu", "cpu"])
    fs, avs = port_batch
    np.testing.assert_array_equal(avs_s.numpy(), avs.numpy())
    np.testing.assert_array_equal(fs_s.numpy(), fs.numpy())


def test_single_deck_fused_step_is_unchanged_by_the_batch_axis(decks):
    """The batch axis leaves one deck's step as it was: a batch of one
    equals the unbatched run."""
    params, masks = decks
    one = fused.run_simulation(reference.initial_state(params, "cpu"),
                               torch.from_numpy(masks[2]), params, n_iters=10)
    fs, avs = batch.batch_run(batch.batch_initial_state(params, 1, "cpu"),
                              torch.from_numpy(masks[2:3]), params, n_iters=10)
    np.testing.assert_array_equal(fs[0].numpy(), one[0].numpy())
    np.testing.assert_allclose(avs[0].numpy(), one[1].numpy(), rtol=1e-6)


def test_batch_shape_validation(decks):
    params, masks = decks
    f0 = batch.batch_initial_state(params, 3, "cpu")
    with pytest.raises(ValueError, match="batched"):
        batch.batch_run(f0, torch.from_numpy(masks), params)  # B 3 against 4
    with pytest.raises(ValueError, match="batched"):
        batch.batch_run(f0[0], torch.from_numpy(masks[0]), params)
    with pytest.raises(ValueError, match="divisible"):
        batch.batch_run(f0, torch.from_numpy(masks[:3]), params, devices=["cpu", "cpu"])


def test_kernel_step_is_refused(decks):
    params, masks = decks
    with pytest.raises(ValueError, match="hand-written kernel"):
        batch.batch_run(batch.batch_initial_state(params, 2, "cpu"),
                        torch.from_numpy(masks[:2]), params, step_fn=step_kernel.fused_step)
