"""The port's matrix-formulated collision (``ops/mxu_collide.py``) against
the JAX package's ``collide_flat`` and against the port's vector collide
(``kernel_common.collide``), at tests/test_mxu_collide.py's tolerances:
planes within rtol 2e-5 / atol 2e-7, u_sq within rtol 5e-4 (the same
moments in another association).  The constants must conserve mass and
momentum in exact arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_hpc_lbm_tpu.ops import mxu_collide as jmxu
from advanced_hpc_lbm_tpu.ops import reference as jref
from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu_torch.ops import kernel_common, lattice, mxu_collide
from advanced_hpc_lbm_tpu_torch.params import LBMParams

PLANES = dict(rtol=2e-5, atol=2e-7)
U_SQ = dict(rtol=5e-4, atol=1e-12)


def _case(omega):
    jp = JaxParams(nx=128, ny=16, max_iters=1, reynolds_dim=10, density=0.1, accel=0.005,
                   omega=omega)
    rng = np.random.RandomState(int(omega * 100))
    f0 = np.asarray(jref.initial_state(jp))
    streamed = np.stack([(f0[k] * rng.uniform(0.7, 1.3, (16, 128))).astype(np.float32)
                         for k in range(9)])
    obst = rng.rand(16, 128) < 0.15
    return jp, LBMParams.from_jax(jp), streamed, obst


@pytest.mark.parametrize("omega", [0.8, 1.0, 1.85, 1.95])
def test_matches_kernel_common(omega):
    _, params, streamed, obst = _case(omega)
    planes = [torch.from_numpy(p) for p in streamed]
    out_ref, usq_ref = kernel_common.collide(planes, torch.from_numpy(obst), params)
    out, usq = mxu_collide.collide_flat(torch.from_numpy(streamed.reshape(9, -1)),
                                        torch.from_numpy(obst.reshape(-1)), params)
    for k in range(9):
        np.testing.assert_allclose(out[k].reshape(16, 128).numpy(), out_ref[k].numpy(),
                                   **PLANES, err_msg=f"plane {k} (omega={omega})")
    np.testing.assert_allclose(usq.reshape(16, 128).numpy(), usq_ref.numpy(), **U_SQ)


@pytest.mark.parametrize("omega", [0.8, 1.0, 1.85, 1.95])
def test_matches_jax_collide_flat(omega):
    jp, params, streamed, obst = _case(omega)
    flat, obst_flat = streamed.reshape(9, -1), obst.reshape(-1)
    want, want_usq = jmxu.collide_flat(jnp.asarray(flat), jnp.asarray(obst_flat), jp)
    out, usq = mxu_collide.collide_flat(torch.from_numpy(flat), torch.from_numpy(obst_flat),
                                        params)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **PLANES)
    np.testing.assert_allclose(usq.numpy(), np.asarray(want_usq), **U_SQ)


@pytest.mark.parametrize("omega", [0.8, 1.85])
def test_constants_equal_jax(omega):
    jp, params, _, _ = _case(omega)
    for got, want in zip(mxu_collide._constants(params), jmxu._constants(jp)):
        np.testing.assert_array_equal(got, want)


def test_mass_momentum_conserved():
    """Columns of the linear block sum to 1 (mass), and its momentum
    projections reproduce the source speed's (momentum)."""
    params = LBMParams(128, 16, 1, 10, 0.1, 0.005, 1.85)
    mat, _, _ = mxu_collide._constants(params)
    a_lin = mat[3:12].astype(np.float64)
    np.testing.assert_allclose(a_lin.sum(axis=0), np.ones(9), atol=1e-12)
    np.testing.assert_allclose((lattice.CX[:, None] * a_lin).sum(axis=0), lattice.CX, atol=1e-12)
    np.testing.assert_allclose((lattice.CY[:, None] * a_lin).sum(axis=0), lattice.CY, atol=1e-12)


def test_cpu_ignores_the_tf32_switch(monkeypatch):
    """TF32 concerns the card's matmuls only: a CPU tensor computes in
    float32 whatever the switch says."""
    _, params, streamed, obst = _case(1.0)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    out, _ = mxu_collide.collide_flat(torch.from_numpy(streamed.reshape(9, -1)),
                                      torch.from_numpy(obst.reshape(-1)), params)
    assert out.dtype == torch.float32 and out.shape == (9, 16 * 128)
