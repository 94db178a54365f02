"""The step math of the hand-written kernels, in plain PyTorch.

The counterpart of ``advanced_hpc_lbm_tpu.ops.kernel_common`` (``collide``,
``forced``, ``_collide_window_inplace``, ``lean_window_step``), and the plain
version of ``csrc/step_common.cuh``: the CUDA device functions there perform
the same float32 operations in the same order (and are compiled with
``-fmad=false``, so no multiply-add is contracted), which is what lets the
kernels and this code agree bit for bit.
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
    out = list(streamed)

    def store(k, v):
        out[k] = v

    u_sq = _collide_window_inplace(streamed.__getitem__, store, obst, params)
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


def _collide_window_inplace(load, store, ob: torch.Tensor, params: LBMParams) -> torch.Tensor:
    """Moments + pairwise BGK + bounce-back through ``load(k)`` /
    ``store(k, v)`` plane accessors, in place: every moment is taken before
    the first store, and each pair loads both its planes before storing
    either.  Returns u_sq of the post-stream moments.  :func:`collide` and
    :func:`lean_window_step` both run it, so their op order is one."""
    c = {k: float(v) for k, v in step_constants(params).items()}
    om1 = c["one_minus_omega"]

    rho = load(0)
    for k in range(1, lattice.NSPEEDS):
        rho = rho + load(k)
    inv_rho = torch.reciprocal(rho)
    u_x = (load(1) + load(5) + load(8) - load(3) - load(6) - load(7)) * inv_rho
    u_y = (load(2) + load(5) + load(6) - load(4) - load(7) - load(8)) * inv_rho
    u_sq = u_x * u_x + u_y * u_y
    base = 1.0 - u_sq * 1.5

    s0 = load(0)
    store(0, torch.where(ob, s0, c["w0_omega"] * rho * base + om1 * s0))

    def pair(k, cu, w_omega):
        ko = int(lattice.OPP[k])
        sk, sko = load(k), load(ko)
        t = w_omega * rho
        even = base + (cu * cu) * 4.5
        odd = cu * 3.0
        # both before either store: a load may be a view of the store's target
        new_k = torch.where(ob, sko, t * (even + odd) + om1 * sk)
        new_ko = torch.where(ob, sk, t * (even - odd) + om1 * sko)
        store(k, new_k)
        store(ko, new_ko)

    pair(1, u_x, c["w1_omega"])
    pair(2, u_y, c["w1_omega"])
    pair(5, u_x + u_y, c["w2_omega"])
    pair(8, u_x - u_y, c["w2_omega"])
    return u_sq


def lean_window_step(src: torch.Tensor, dst: torch.Tensor, w_obst: torch.Tensor,
                     accel_T: torch.Tensor, params: LBMParams, T: int, nx: int) -> torch.Tensor:
    """One force + pull-stream + collide step over whole (T, nx) windows.

    Each plane of ``src`` is forced and ``torch.roll``ed into ``dst`` at the
    window's own moduli T and nx, then moments, pairwise BGK and
    bounce-back run in place on ``dst``.  The rolls wrap at the window
    edge: a ghost-zone caller relies on the wrapped values landing only in
    the ring that its shrinking valid region gives up.  A (T, nx) window
    that is the whole periodic grid is one plain step.

    Args:
      src / dst: (9, ..., T, nx) float32 windows; leading batch dims allowed.
      w_obst: bool obstacle window broadcastable to one plane.
      accel_T: bool, True on every image of global row ny-2.
      T, nx: the window's shape (the roll moduli).

    Returns u_sq of the post-stream moments, the shape of one plane.
    """
    if src.shape[-2:] != (T, nx) or dst.shape != src.shape:
        raise ValueError(f"windows must be (9, ..., {T}, {nx}), got {tuple(src.shape)}")
    for k, plane in enumerate(forced(list(src), w_obst, accel_T, params)):
        shifts = (int(lattice.CY[k]) % T, int(lattice.CX[k]) % nx)
        dst[k] = torch.roll(plane, shifts=shifts, dims=(-2, -1))

    def store(k, v):
        dst[k] = v

    return _collide_window_inplace(dst.__getitem__, store, w_obst, params)
