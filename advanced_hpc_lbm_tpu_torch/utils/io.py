"""Host-side I/O codecs — byte-compatible with the reference file formats.

The same readers, writers and :class:`DeckError` as
``advanced_hpc_lbm_tpu.utils.io``, on numpy arrays.  The obstacle reader
and both writers go through the port's C codec, ``csrc/fastio.c``
(:mod:`.native`, built by ``cc`` at first use; it formats final_state.dat
on several threads), and take their pure-Python path where it cannot be
built; both paths write the same bytes.  The writers keep the reference's
quirks:

* obstacle cells are written with u = 0 and pressure = density * c_s^2;
* the final column of ``final_state.dat`` prints ``obstacles[ii*nx + jj]``,
  a *transposed* flat index: for square grids the transpose of the mask, for
  nx != ny a different in-bounds cell.  It is reproduced bit for bit behind
  ``emulate_obstacle_column_quirk=True`` (the default); the checker never
  reads that column.
"""

from __future__ import annotations

import os

import numpy as np

from advanced_hpc_lbm_tpu_torch.ops import lattice
from advanced_hpc_lbm_tpu_torch.params import LBMParams
from advanced_hpc_lbm_tpu_torch.utils import native

FINAL_STATE_FILE = "final_state.dat"
AV_VELS_FILE = "av_vels.dat"


class DeckError(ValueError):
    """Malformed input deck."""


def load_params(path: str | os.PathLike) -> LBMParams:
    """Parse a 7-line ``.params`` deck.

    Line order: nx, ny, maxIters, reynolds_dim (ints); density, accel,
    omega (floats).
    """
    names = ["nx", "ny", "maxIters", "reynolds_dim", "density", "accel", "omega"]
    with open(path) as fh:
        lines = [ln.strip() for ln in fh if ln.strip()]
    if len(lines) < len(names):
        raise DeckError(
            f"could not read param file: {names[len(lines)]} ({path})"
        )
    vals = []
    for name, ln in zip(names, lines):
        kind = int if name in ("nx", "ny", "maxIters", "reynolds_dim") else float
        try:
            vals.append(kind(ln.split()[0]))
        except ValueError as e:
            raise DeckError(f"could not read param file: {name} ({path})") from e
    return LBMParams(
        nx=vals[0],
        ny=vals[1],
        max_iters=vals[2],
        reynolds_dim=vals[3],
        density=vals[4],
        accel=vals[5],
        omega=vals[6],
    )


def load_obstacles(path: str | os.PathLike, params: LBMParams) -> np.ndarray:
    """Parse an obstacle deck of ``x y 1`` triples into a (ny, nx) bool mask,
    with the reference's validation: 3 integer fields per line, coords in
    range, blocked == 1.  Uses the C codec when it builds."""
    if native.available():
        try:
            return native.parse_obstacles(path, params.nx, params.ny)
        except ValueError as e:
            raise DeckError(str(e)) from e
    mask = np.zeros((params.ny, params.nx), dtype=bool)
    with open(path) as fh:
        for lineno, raw in enumerate(fh, 1):
            if not raw.strip():
                continue
            fields = raw.split()
            if len(fields) != 3:
                raise DeckError(
                    f"expected 3 values per line in obstacle file ({path}:{lineno})"
                )
            try:
                xx, yy, blocked = (int(v) for v in fields)
            except ValueError:
                raise DeckError(
                    f"expected 3 values per line in obstacle file ({path}:{lineno})"
                ) from None
            if not 0 <= xx <= params.nx - 1:
                raise DeckError(f"obstacle x-coord out of range ({path}:{lineno})")
            if not 0 <= yy <= params.ny - 1:
                raise DeckError(f"obstacle y-coord out of range ({path}:{lineno})")
            if blocked != 1:
                raise DeckError(
                    f"obstacle blocked value should be 1 ({path}:{lineno})"
                )
            mask[yy, xx] = True
    return mask


def _quirk_obstacle_column(obstacles: np.ndarray) -> np.ndarray:
    """The transposed obstacle read, vectorized: for each output row in
    (jj, ii) raster order, ``flat[ii * nx + jj]`` (clipped in-bounds)."""
    ny, nx = obstacles.shape
    flat = obstacles.reshape(-1).astype(np.int64)
    ii = np.tile(np.arange(nx), ny)
    jj = np.repeat(np.arange(ny), nx)
    idx = np.minimum(ii * nx + jj, flat.size - 1)
    return flat[idx]


def final_state_planes(
    f: np.ndarray,
    obstacles: np.ndarray,
    params: LBMParams,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The float32 (ny, nx) planes u_x, u_y, ||u|| and pressure of a
    (9, ny, nx) state, obstacle cells at u = 0 and the rest pressure."""
    f = np.asarray(f, dtype=np.float32)
    obstacles = np.asarray(obstacles, dtype=bool)
    rho = f.sum(axis=0)
    u_x = (f[1] + f[5] + f[8] - (f[3] + f[6] + f[7])) / rho
    u_y = (f[2] + f[5] + f[6] - (f[4] + f[7] + f[8])) / rho
    u = np.sqrt(u_x * u_x + u_y * u_y)
    pressure = rho * lattice.C_SQ

    blocked_pressure = np.float32(params.density_f32 * lattice.C_SQ)
    return (np.where(obstacles, np.float32(0), u_x),
            np.where(obstacles, np.float32(0), u_y),
            np.where(obstacles, np.float32(0), u),
            np.where(obstacles, blocked_pressure, pressure))


def final_state_table(
    f: np.ndarray,
    obstacles: np.ndarray,
    params: LBMParams,
    *,
    emulate_obstacle_column_quirk: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compute the final_state.dat columns from a (9, ny, nx) state.

    Returns (coords[int64 (N,2) as ii,jj], fields[float64 (N,4) as
    u_x,u_y,||u||,pressure], obstacle_col[int64 (N,)]) in raster order
    (jj outer, ii inner).  Field math is float32
    (:func:`final_state_planes`), widened to float64 only for printing.
    """
    obstacles = np.asarray(obstacles, dtype=bool)
    planes = final_state_planes(f, obstacles, params)
    ny, nx = obstacles.shape
    ii = np.tile(np.arange(nx, dtype=np.int64), ny)
    jj = np.repeat(np.arange(ny, dtype=np.int64), nx)
    coords = np.stack([ii, jj], axis=1)
    fields = np.stack([c.reshape(-1).astype(np.float64) for c in planes], axis=1)
    if emulate_obstacle_column_quirk:
        obs_col = _quirk_obstacle_column(obstacles)
    else:
        obs_col = obstacles.reshape(-1).astype(np.int64)
    return coords, fields, obs_col


def write_final_state(
    path: str | os.PathLike,
    f: np.ndarray,
    obstacles: np.ndarray,
    params: LBMParams,
    *,
    emulate_obstacle_column_quirk: bool = True,
    threads: int | None = None,
) -> None:
    """Write final_state.dat: ``%d %d %.12E %.12E %.12E %.12E %d`` per cell.
    The C codec formats on ``threads`` threads (default: the cores this
    process may run on); the bytes are the same for every count, and the
    same on the pure-Python path, which ignores it."""
    if native.available():
        native.write_final_state(path, final_state_planes(f, obstacles, params), obstacles,
                                 quirk=emulate_obstacle_column_quirk, threads=threads)
        return
    coords, fields, obs_col = final_state_table(
        f,
        obstacles,
        params,
        emulate_obstacle_column_quirk=emulate_obstacle_column_quirk,
    )
    with open(path, "w") as fh:
        for (ii, jj), (ux, uy, u, p), ob in zip(
            coords.tolist(), fields.tolist(), obs_col.tolist()
        ):
            fh.write(f"{ii} {jj} {ux:.12E} {uy:.12E} {u:.12E} {p:.12E} {ob}\n")


def write_av_vels(path: str | os.PathLike, av_vels: np.ndarray) -> None:
    """Write av_vels.dat: ``%d:\\t%.12E`` per step."""
    av = np.asarray(av_vels, dtype=np.float64)
    if native.available():
        native.write_av_vels(path, av)
        return
    with open(path, "w") as fh:
        for step, v in enumerate(av.tolist()):
            fh.write(f"{step}:\t{v:.12E}\n")


def read_av_vels(path: str | os.PathLike) -> np.ndarray:
    """Read an av_vels.dat back (column 1, as the checker does)."""
    return np.loadtxt(path, usecols=[1], ndmin=1)
