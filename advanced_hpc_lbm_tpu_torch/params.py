"""Run parameters for the D2Q9-BGK solver.

The PyTorch port's counterpart of ``advanced_hpc_lbm_tpu.params``: the
7-line ``.params`` deck (nx, ny, maxIters, reynolds_dim on integer lines,
then density, accel, omega) as a frozen dataclass, with the derived scalars
computed in numpy float32 exactly as the JAX package computes them, so that
both packages feed their kernels the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LBMParams:
    """Static configuration of one simulation (all fields Python scalars).

    Attributes:
      nx, ny        : grid size in cells (x = fastest-varying axis)
      max_iters     : number of timesteps
      reynolds_dim  : characteristic length for the Reynolds number
      density       : initial (and forcing-reference) fluid density
      accel         : acceleration applied to row ``ny - 2`` each step
      omega         : BGK relaxation parameter
    """

    nx: int
    ny: int
    max_iters: int
    reynolds_dim: int
    density: float
    accel: float
    omega: float

    def __post_init__(self) -> None:
        if self.nx <= 0 or self.ny <= 0:
            raise ValueError(f"grid must be positive, got {self.nx}x{self.ny}")
        if self.max_iters < 0:
            raise ValueError(f"max_iters must be >= 0, got {self.max_iters}")

    @classmethod
    def from_jax(cls, p) -> "LBMParams":
        """Carry a deck across from any object with the seven fields (the
        JAX package's ``LBMParams`` in the differential tests)."""
        return cls(**{f.name: getattr(p, f.name) for f in dataclasses.fields(cls)})

    # -- fp32 helpers -------------------------------------------------------
    # All physics is float32; the derived scalars are rounded in numpy
    # float32 on the host (w1 = density * accel / 9 in float arithmetic).

    @property
    def density_f32(self) -> np.float32:
        return np.float32(self.density)

    @property
    def accel_f32(self) -> np.float32:
        return np.float32(self.accel)

    @property
    def omega_f32(self) -> np.float32:
        return np.float32(self.omega)

    @property
    def accel_w1(self) -> np.float32:
        """Axis-speed forcing increment."""
        return np.float32(self.density_f32 * self.accel_f32 / np.float32(9.0))

    @property
    def accel_w2(self) -> np.float32:
        """Diagonal-speed forcing increment."""
        return np.float32(self.density_f32 * self.accel_f32 / np.float32(36.0))

    @property
    def viscosity(self) -> float:
        """Kinematic viscosity from omega."""
        return float(
            np.float32(1.0 / 6.0)
            * (np.float32(2.0) / self.omega_f32 - np.float32(1.0))
        )

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny
