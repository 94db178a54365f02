"""Composable D2Q9-BGK ops in plain PyTorch — the port's test oracle.

Op for op the counterpart of ``advanced_hpc_lbm_tpu.ops.reference``: the
pre-fusion pipeline accelerate_flow -> stream_pull -> apply_bounce_back ->
bgk_collide, each a function over a ``(9, ny, nx)`` float32 tensor that
returns a new tensor and mutates nothing.  The arithmetic keeps the JAX
op order, so the two packages agree to float32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from advanced_hpc_lbm_tpu_torch.ops import lattice
from advanced_hpc_lbm_tpu_torch.params import LBMParams


def rest_populations(params: LBMParams) -> np.ndarray:
    """The 9 float32 values of the equilibrium at rest: 4*rho/9 for the
    rest speed, rho/9 for the axis speeds, rho/36 for the diagonals."""
    d = params.density_f32
    return np.array(
        [d * np.float32(4.0 / 9.0)]
        + [d / np.float32(9.0)] * 4
        + [d / np.float32(36.0)] * 4,
        dtype=np.float32,
    )


def initial_state(params: LBMParams, device: torch.device | str) -> torch.Tensor:
    """Equilibrium-at-rest initial condition (:func:`rest_populations` in
    every cell).  A fresh ``(9, ny, nx)`` float32 tensor on ``device``."""
    return (
        torch.from_numpy(rest_populations(params))
        .to(device)[:, None, None]
        .expand(lattice.NSPEEDS, params.ny, params.nx)
        .contiguous()
    )


def state_from_numpy(f: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """A ``(9, ny, nx)`` float32 numpy state as a contiguous tensor on
    ``device`` (the hand-over point of the differential tests)."""
    return torch.from_numpy(np.ascontiguousarray(f, dtype=np.float32)).to(device)


def accelerate_flow(
    f: torch.Tensor, obstacles: torch.Tensor, w1: np.float32, w2: np.float32
) -> torch.Tensor:
    """Row forcing on ``jj = ny - 2`` of the given (pre-stream) state.

    Adds w1 to E and w2 to NE/SE, subtracts from W/NW/SW, only on fluid
    cells where all three decremented speeds stay strictly positive.

    Args:
      f: (..., 9, ny, nx) distributions (a leading batch axis is optional).
      obstacles: (..., ny, nx) bool mask, True = blocked.
      w1, w2: forcing increments (params.accel_w1 / accel_w2).
    """
    w1, w2 = float(w1), float(w2)
    jj = f.shape[-2] - 2
    row = f[..., jj, :]  # (..., 9, nx)
    ok = (
        (~obstacles[..., jj, :])
        & (row[..., 3, :] - w1 > 0.0)
        & (row[..., 6, :] - w2 > 0.0)
        & (row[..., 7, :] - w2 > 0.0)
    )
    delta = torch.zeros_like(row)
    delta[..., 1, :] = w1
    delta[..., 5, :] = w2
    delta[..., 8, :] = w2
    delta[..., 3, :] = -w1
    delta[..., 6, :] = -w2
    delta[..., 7, :] = -w2
    out = f.clone()
    out[..., jj, :] = torch.where(ok[..., None, :], row + delta, row)
    return out


def stream_pull(f: torch.Tensor) -> torch.Tensor:
    """Pull-scheme periodic streaming:
    out[..., k, jj, ii] = f[..., k, jj - CY[k], ii - CX[k]] with
    wrap-around, one ``torch.roll`` per speed plane."""
    planes = [
        torch.roll(f[..., k, :, :], shifts=(int(lattice.CY[k]), int(lattice.CX[k])),
                   dims=(-2, -1))
        for k in range(lattice.NSPEEDS)
    ]
    return torch.stack(planes, dim=-3)


def apply_bounce_back(f_streamed: torch.Tensor, obstacles: torch.Tensor) -> torch.Tensor:
    """On obstacle cells replace each speed with its opposite; fluid cells
    pass through."""
    reflected = f_streamed[torch.from_numpy(lattice.OPP).long()]
    return torch.where(obstacles[None, :, :], reflected, f_streamed)


def macroscopic(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Density and velocity moments of (..., 9, ny, nx) distributions:
    (rho, u_x, u_y), each (..., ny, nx)."""
    p = [f[..., k, :, :] for k in range(lattice.NSPEEDS)]
    rho = torch.sum(f, dim=-3)
    u_x = (p[1] + p[5] + p[8] - (p[3] + p[6] + p[7])) / rho
    u_y = (p[2] + p[5] + p[6] - (p[4] + p[7] + p[8])) / rho
    return rho, u_x, u_y


def equilibrium(rho: torch.Tensor, u_x: torch.Tensor, u_y: torch.Tensor) -> torch.Tensor:
    """Second-order BGK equilibrium, (..., 9, ny, nx) from (..., ny, nx)
    moments:
    feq_k = w_k * rho * (1 + cu/c_s^2 + cu^2/(2 c_s^4) - u^2/(2 c_s^2))
    with cu = c_k . u.  The scalar denominators are rounded in float32 on
    the host, as numpy does them in the JAX version."""
    c_sq = float(lattice.C_SQ)
    two_c4 = float(np.float32(2.0 * lattice.C_SQ * lattice.C_SQ))
    two_c2 = float(np.float32(2.0 * lattice.C_SQ))
    u_sq = u_x * u_x + u_y * u_y
    cx = torch.from_numpy(lattice.CX).to(rho)[:, None, None]
    cy = torch.from_numpy(lattice.CY).to(rho)[:, None, None]
    w = torch.from_numpy(lattice.W).to(rho)[:, None, None]
    cu = cx * u_x[..., None, :, :] + cy * u_y[..., None, :, :]
    return (
        w
        * rho[..., None, :, :]
        * (1.0 + cu / c_sq + (cu * cu) / two_c4 - u_sq[..., None, :, :] / two_c2)
    )


def bgk_collide(
    f: torch.Tensor, obstacles: torch.Tensor, omega: np.float32
) -> torch.Tensor:
    """BGK relaxation toward equilibrium on fluid cells: f += omega*(feq - f).
    Obstacle cells are left untouched."""
    rho, u_x, u_y = macroscopic(f)
    feq = equilibrium(rho, u_x, u_y)
    relaxed = f + float(omega) * (feq - f)
    return torch.where(obstacles[None, :, :], f, relaxed)


def av_velocity(f: torch.Tensor, obstacles: torch.Tensor) -> torch.Tensor:
    """Mean velocity norm over fluid cells (a float32 0-dim tensor)."""
    _, u_x, u_y = macroscopic(f)
    norm = torch.sqrt(u_x * u_x + u_y * u_y)
    fluid = ~obstacles
    tot_u = torch.sum(torch.where(fluid, norm, 0.0))
    return tot_u / torch.sum(fluid).to(f.dtype)


def total_density(f: torch.Tensor) -> torch.Tensor:
    """Mass-conservation invariant."""
    return torch.sum(f)


def timestep_pipeline(
    f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """One timestep as the 4-op pipeline — accelerate -> stream ->
    bounce-back -> collide — plus the av-velocity of the post-collision
    state.  Returns (f_next, av_vel)."""
    f = accelerate_flow(f, obstacles, params.accel_w1, params.accel_w2)
    f = stream_pull(f)
    f = apply_bounce_back(f, obstacles)
    f = bgk_collide(f, obstacles, params.omega_f32)
    return f, av_velocity(f, obstacles)
