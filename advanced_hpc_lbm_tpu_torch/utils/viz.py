"""Visualization of a final state: the reference's gnuplot script
(final_state.plt: a heatmap of column 5, ||u||, into final_state.png).

The counterpart of ``advanced_hpc_lbm_tpu.utils.viz``.  It reads a
final_state.dat file, as the gnuplot original does.  Matplotlib is
optional; without it the heatmap is written as a PGM image (viewable
anywhere, no dependencies), byte for byte the JAX module's.

    python -m advanced_hpc_lbm_tpu_torch.utils.viz final_state.dat -o final_state.png
"""

from __future__ import annotations

import os

import numpy as np


def velocity_field_from_dat(path: str | os.PathLike) -> np.ndarray:
    """Load ||u|| (column 5, 1-based as in final_state.plt) into a (ny,
    nx) array by the coordinate columns."""
    data = np.loadtxt(path, usecols=[0, 1, 4])
    ii = data[:, 0].astype(int)
    jj = data[:, 1].astype(int)
    nx, ny = ii.max() + 1, jj.max() + 1
    grid = np.zeros((ny, nx))
    grid[jj, ii] = data[:, 2]
    return grid


def plot_final_state(dat_path: str | os.PathLike,
                     out_path: str | os.PathLike = "final_state.png") -> str:
    """Render the ||u|| heatmap.  Returns the written path (a .pgm beside
    ``out_path`` where matplotlib is unavailable)."""
    grid = velocity_field_from_dat(dat_path)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        pgm = str(out_path).rsplit(".", 1)[0] + ".pgm"
        lo, hi = float(grid.min()), float(grid.max())
        scaled = ((grid - lo) / (hi - lo + 1e-30) * 255).astype(np.uint8)
        with open(pgm, "wb") as fh:
            fh.write(f"P5 {grid.shape[1]} {grid.shape[0]} 255\n".encode())
            fh.write(scaled[::-1].tobytes())
        return pgm
    fig, ax = plt.subplots(figsize=(6, 6 * grid.shape[0] / grid.shape[1]))
    im = ax.imshow(grid, origin="lower", cmap="viridis")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.colorbar(im, ax=ax, label="|u|")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return str(out_path)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="plot the ||u|| heatmap of a final state")
    p.add_argument("dat", nargs="?", default="final_state.dat")
    p.add_argument("-o", "--out", default="final_state.png")
    a = p.parse_args(argv)
    print(plot_final_state(a.dat, a.out))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
