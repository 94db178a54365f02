"""D2Q9 lattice constants (numpy; shared by the plain ops and the kernel
wrappers).

Speed numbering:

        6 2 5
        3 0 1        1=E, 2=N, 3=W, 4=S, 5=NE, 6=NW, 7=SW, 8=SE
        7 4 8

Distribution tensors are ``(9, ny, nx)``: axis 1 is y (north = +1), axis 2
is x (east = +1), the same layout as the JAX package.  The CUDA sources in
``csrc/`` spell out the same numbering plane by plane.
"""

from __future__ import annotations

import numpy as np

NSPEEDS = 9

# Lattice velocities: CX[k], CY[k] = x/y displacement per step of speed k.
CX = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1], dtype=np.int32)
CY = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1], dtype=np.int32)

# Quadrature weights: 4/9 rest, 1/9 axes, 1/36 diagonals.
W = np.array(
    [4.0 / 9.0] + [1.0 / 9.0] * 4 + [1.0 / 36.0] * 4, dtype=np.float32
)

# Opposite-speed permutation for bounce-back: 1<->3, 2<->4, 5<->7, 6<->8.
OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)

# Square of the lattice speed of sound.
C_SQ = np.float32(1.0 / 3.0)

assert all(CX[OPP] == -CX) and all(CY[OPP] == -CY)
assert np.isclose(W.sum(), 1.0)
