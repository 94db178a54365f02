"""The work of one deck run, counted from the deck alone, and the card's
published peaks: the yardstick of ``kernels_roofline``.

A deck run's work does not depend on how a program cuts it into launches,
so it is counted once per run: no K-step, fused or resident kernel can
lift the share past 100%.

Operations, float32, per step (the D2Q9-BGK step factored as the
reference solver and the program both write it):

* every fluid cell, 86: density, 8 adds; 1/density, 1; the velocity's two
  components, 5 adds and a multiply each (12); u^2, 3; the equilibrium's
  base 1 - 1.5 u^2, 2; the rest speed, 4 (w*rho, times the base, (1 - omega)
  f, the sum); the two diagonal velocities u_x +- u_y, 2; four pairs of
  opposite speeds, 13 each (w*rho; cu^2, 4.5 times it, plus the base; 3 cu;
  even +- odd, times w*rho, (1 - omega) f and the sum for each of the
  two); the speed's square root, 1; its add into the step's sum, 1;
* every fluid cell of the forced row ``ny - 2``, 9 more: the guard's three
  subtractions and the six forcing adds.

Blocked cells need no arithmetic (bounce-back moves values).  A kernel that
computes everything on every cell does more (94 per cell and step in the
program's kernels), which this count leaves out: it counts what the deck
needs.

Bytes, once per run: every cell's nine float32 values read and written
once and its obstacle byte read once (73 per cell), and the av history
written (4 per step).
"""

from __future__ import annotations

import numpy as np

OPS_PER_FLUID_CELL_STEP = 86
OPS_PER_FORCED_CELL_STEP = 9
BYTES_PER_CELL = 9 * 4 * 2 + 1
BYTES_PER_STEP = 4

# Published peaks by a substring of torch.cuda.get_device_name(): NVIDIA's
# H100 SXM data sheet, float32 outside the tensor cores and HBM3, at the
# full 700 W power limit.
PEAKS = {
    "H100 80GB HBM3": {"flops": 67e12, "bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    """The card's peaks, or None for a card the table does not know."""
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def deck_ops(obstacles: np.ndarray, steps: int) -> int:
    """Float32 operations of ``steps`` steps on the (ny, nx) mask."""
    ny = obstacles.shape[0]
    fluid = int(np.count_nonzero(~obstacles))
    forced = int(np.count_nonzero(~obstacles[ny - 2]))
    return steps * (OPS_PER_FLUID_CELL_STEP * fluid + OPS_PER_FORCED_CELL_STEP * forced)


def deck_bytes(obstacles: np.ndarray, steps: int) -> int:
    """Bytes of a whole run: the state and the mask once, the av history."""
    return BYTES_PER_CELL * obstacles.size + BYTES_PER_STEP * steps


def least_seconds(obstacles: np.ndarray, steps: int, peak: dict) -> tuple[float, str]:
    """(seconds, bound_by): the least time a card of ``peak`` could take
    for the run, the larger of its operations and its bytes over the peak
    rates."""
    t_ops = deck_ops(obstacles, steps) / peak["flops"]
    t_bytes = deck_bytes(obstacles, steps) / peak["bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
