"""The step math of the hand-written kernels, in plain PyTorch.

The counterpart of ``advanced_hpc_lbm_tpu.ops.kernel_common.collide`` and
``forced``, and the plain version of ``csrc/step_common.cuh``: the CUDA
device functions there perform the same float32 operations in the same
order (and are compiled with ``-fmad=false``, so no multiply-add is
contracted), which is what lets the kernel and this code agree bit for bit.
Every scalar constant is rounded once, in numpy float32 on the host —
:func:`step_constants` — and handed to both.

Pairwise equilibria: opposite speeds share the even part of their
equilibrium, and omega is folded into the prefactor,
f' = f + w(feq - f) = (w*t)(even +- odd) + (1-w) f.
"""

from __future__ import annotations

import numpy as np
import torch

from advanced_hpc_lbm_tpu_torch.ops import lattice
from advanced_hpc_lbm_tpu_torch.params import LBMParams

# (speed, sign) of the forcing increment: +w1 to E, +w2 to NE/SE, -w1 from
# W, -w2 from NW/SW
_FORCING = ((1, 1, 1), (5, 1, 2), (8, 1, 2), (3, -1, 1), (6, -1, 2), (7, -1, 2))


def step_constants(params: LBMParams) -> dict[str, np.float32]:
    """The float32 scalars of one step: ``W[k]*omega`` for the rest, axis and
    diagonal speeds, ``1 - omega`` and the forcing increments."""
    omega = params.omega_f32
    return {
        "w0_omega": np.float32(lattice.W[0] * omega),
        "w1_omega": np.float32(lattice.W[1] * omega),
        "w2_omega": np.float32(lattice.W[5] * omega),
        "one_minus_omega": np.float32(np.float32(1.0) - omega),
        "accel_w1": params.accel_w1,
        "accel_w2": params.accel_w2,
    }


def collide(streamed: list[torch.Tensor], obst: torch.Tensor, params: LBMParams):
    """Pairwise BGK relax + bounce-back select.

    Args:
      streamed: 9 post-streaming planes of one shape.
      obst: bool mask of that shape, True = blocked.
      params: run parameters.

    Returns (out_planes, u_sq): u_sq of the streamed (= post-collision)
    moments, for the ||u|| reduction.
    """
    c = {k: float(v) for k, v in step_constants(params).items()}
    om1 = c["one_minus_omega"]

    rho = streamed[0]
    for k in range(1, lattice.NSPEEDS):
        rho = rho + streamed[k]
    inv_rho = torch.reciprocal(rho)
    u_x = (
        streamed[1] + streamed[5] + streamed[8]
        - streamed[3] - streamed[6] - streamed[7]
    ) * inv_rho
    u_y = (
        streamed[2] + streamed[5] + streamed[6]
        - streamed[4] - streamed[7] - streamed[8]
    ) * inv_rho
    u_sq = u_x * u_x + u_y * u_y
    base = 1.0 - u_sq * 1.5

    out = [None] * lattice.NSPEEDS

    def pair(k, cu, w_omega):
        ko = int(lattice.OPP[k])
        t = w_omega * rho
        even = base + (cu * cu) * 4.5
        odd = cu * 3.0
        out[k] = t * (even + odd) + om1 * streamed[k]
        out[ko] = t * (even - odd) + om1 * streamed[ko]

    out[0] = c["w0_omega"] * rho * base + om1 * streamed[0]
    pair(1, u_x, c["w1_omega"])
    pair(2, u_y, c["w1_omega"])
    pair(5, u_x + u_y, c["w2_omega"])
    pair(8, u_x - u_y, c["w2_omega"])

    for k in range(lattice.NSPEEDS):
        out[k] = torch.where(obst, streamed[int(lattice.OPP[k])], out[k])
    return out, u_sq


def forced(planes: list[torch.Tensor], obst: torch.Tensor, row_is_accel: torch.Tensor,
           params: LBMParams) -> list[torch.Tensor]:
    """Masked acceleration forcing over a window; ``row_is_accel`` marks
    global row ny-2.  The guard reads the cell's own (pre-stream) values."""
    w = {1: float(params.accel_w1), 2: float(params.accel_w2)}
    ok = (
        row_is_accel
        & torch.logical_not(obst)
        & (planes[3] - w[1] > 0.0)
        & (planes[6] - w[2] > 0.0)
        & (planes[7] - w[2] > 0.0)
    )
    out = list(planes)
    for k, sign, which in _FORCING:
        out[k] = planes[k] + torch.where(ok, sign * w[which], 0.0)
    return out
