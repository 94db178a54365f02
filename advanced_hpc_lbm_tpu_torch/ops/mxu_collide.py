"""BGK collision as one (21 x 9) matrix product on the flat state.

The counterpart of ``advanced_hpc_lbm_tpu.ops.mxu_collide``.  The
collision's linear algebra (the density and momentum moments, the linear
part of the relaxed populations, and the per-speed momentum projections
the quadratic terms need) folds into one constant (21 x 9) matrix applied
to the speed-major (9, L = ny*nx) state:

    out_linear_k = sum_j [ (1-w) d_kj + w W_k (1 + 3 c_k.c_j) ] s_j
    cm_k         = sum_j (c_k.c_j) s_j          (momentum projections)
    rho, m_x, m_y = the moment rows

leaving the nonlinear work per cell:

    out_k = out_linear_k + (w W_k) (4.5 cm_k^2 - 1.5 |m|^2) / rho

:func:`collide_flat` is held to ``kernel_common.collide`` in the tests.  As
in the JAX package, no backend uses it.  The JAX package computes the
product with a ``dot_general`` outside any Pallas kernel, so here it is a
``torch.matmul``, in full float32: the fp32 invariant forbids TF32, and a
CUDA tensor is refused while TF32 matmuls are allowed.

Its verdict is a TPU finding: on the TPU the matrix form ran 5.2 us per
step of a VMEM-resident 128^2 state against the vector collide's 3.1 (it
lost 1.67x; with M = 21 and K = 9 the systolic array is bound by its N
columns, and the fp32 product takes three bf16 passes).  This port has not
timed the matrix form on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from advanced_hpc_lbm_tpu_torch.ops import lattice
from advanced_hpc_lbm_tpu_torch.params import LBMParams


@functools.lru_cache(maxsize=8)
def _constants(params: LBMParams) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(21, 9) contraction matrix and the per-speed nonlinear weights.

    Rows 0..2: [rho; m_x; m_y]; rows 3..11: linear part of the relaxed
    populations; rows 12..20: cm_k projections."""
    omega = float(params.omega_f32)
    cdot = (lattice.CX[:, None] * lattice.CX[None, :]
            + lattice.CY[:, None] * lattice.CY[None, :]).astype(np.float64)
    top = np.stack([np.ones(9), lattice.CX.astype(np.float64), lattice.CY.astype(np.float64)])
    a_lin = (omega * lattice.W[:, None].astype(np.float64) * (1.0 + 3.0 * cdot)
             + (1.0 - omega) * np.eye(9))
    mat = np.concatenate([top, a_lin, cdot], axis=0).astype(np.float32)
    w_quad = (omega * 4.5 * lattice.W).astype(np.float32)  # * cm^2
    w_msq = (omega * 1.5 * lattice.W).astype(np.float32)  # * |m|^2
    return mat, w_quad, w_msq


def _check_fp32_matmul(x: torch.Tensor) -> None:
    """Refuse a CUDA product that would round its inputs to TF32."""
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "collide_flat needs full float32 matmuls: TF32 is on "
            f"(allow_tf32={torch.backends.cuda.matmul.allow_tf32}, float32 matmul "
            f"precision {torch.get_float32_matmul_precision()!r}); the fp32 invariant "
            "forbids it")


def collide_flat(streamed_flat: torch.Tensor, obst_flat: torch.Tensor,
                 params: LBMParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Matrix-formulated collide + bounce-back on a (9, L) state.

    Args:
      streamed_flat: (9, L) float32 post-streaming populations.
      obst_flat: (L,) bool, True = blocked.
      params: run parameters.

    Returns (out (9, L), u_sq (L,)): the contract of
    ``kernel_common.collide`` in the flat layout.
    """
    _check_fp32_matmul(streamed_flat)
    mat, w_quad, w_msq = (torch.from_numpy(c).to(streamed_flat.device)
                          for c in _constants(params))
    proj = torch.matmul(mat, streamed_flat)  # (21, L)
    rho, m_x, m_y = proj[0], proj[1], proj[2]
    lin, cm = proj[3:12], proj[12:21]
    inv_rho = 1.0 / rho
    msq = m_x * m_x + m_y * m_y
    quad = (w_quad[:, None] * (cm * cm) - w_msq[:, None] * msq[None]) * inv_rho[None]
    out = lin + quad
    reflected = streamed_flat[torch.from_numpy(lattice.OPP).long().to(streamed_flat.device)]
    out = torch.where(obst_flat[None], reflected, out)
    return out, msq * (inv_rho * inv_rho)
