"""Validation checker — the reference's check.py contract, as a library and
a CLI.

Load column 1 of av_vels.dat and columns (0,1,5) = (x, y, pressure) of
final_state.dat for both reference and simulation, require identical
coordinate ordering and step counts, then fail if the largest per-element
percentage difference ``100*diff/(ref-diff)`` exceeds the tolerance
(default 1%) or is non-finite.  The same contract as
``advanced_hpc_lbm_tpu.utils.check``, kept in the port so that a host
without JAX can check a run:
``python -m advanced_hpc_lbm_tpu_torch.utils.check --ref-av-vels-file=...``.
"""

from __future__ import annotations

import argparse
import dataclasses
import lzma
import os
import sys

import numpy as np


@dataclasses.dataclass
class DiffStats:
    max_diff_step: int
    max_diff: float
    max_diff_pcnt: float
    sim_val: float
    ref_val: float
    total: float
    # (jj, ii) of the biggest difference — final_state only
    coord: tuple[int, int] | None = None

    @property
    def finite(self) -> bool:
        return bool(np.isfinite(self.max_diff_pcnt))

    def passed(self, tolerance: float) -> bool:
        return self.finite and abs(self.max_diff_pcnt) <= tolerance


@dataclasses.dataclass
class CheckResult:
    av_vels: DiffStats
    final_state: DiffStats
    tolerance: float

    @property
    def passed(self) -> bool:
        return self.av_vels.passed(self.tolerance) and self.final_state.passed(
            self.tolerance
        )


def diff_values(ref_vals: np.ndarray, sim_vals: np.ndarray) -> DiffStats:
    """Largest percentage difference, as the reference checker computes it."""
    diff = ref_vals - sim_vals
    with np.errstate(divide="ignore", invalid="ignore"):
        diff_pcnt = 100.0 * (diff / (ref_vals - diff))
    i = int(np.argmax(np.abs(diff_pcnt)))
    return DiffStats(
        max_diff_step=i,
        max_diff=float(diff[i]),
        max_diff_pcnt=float(diff_pcnt[i]),
        sim_val=float(sim_vals[i]),
        ref_val=float(ref_vals[i]),
        total=float(np.sum(np.abs(diff))),
    )


def read_final_state(path: str | os.PathLike) -> np.ndarray:
    """A final_state.dat, or its ``.xz`` (``goldens/``), as a float64 (N, 7)
    table: the same values as ``np.loadtxt``, read many times faster (one
    split of the whole file; a 1024x1024 file in about a second)."""
    opener = lzma.open if os.fspath(path).endswith(".xz") else open
    with opener(path, "rb") as fh:
        return np.array(fh.read().split(), dtype=np.float64).reshape(-1, 7)


def check_final_state_only(ref_final_state, final_state) -> DiffStats:
    """The final-state half of :func:`check_files`: equal coordinates, then
    the pressure column's largest percentage difference.  Either argument
    is a path (:func:`read_final_state`) or a table it returned."""
    ref, sim = (t if isinstance(t, np.ndarray) else read_final_state(t)
                for t in (ref_final_state, final_state))
    if ref.shape != sim.shape or np.any(ref[:, 0:2] != sim[:, 0:2]):
        raise ValueError("Final state files coordinates were not the same")
    fs = diff_values(ref[:, 5], sim[:, 5])
    # grid coords of the biggest difference, from the sim table's columns 0/1
    fs.coord = (int(sim[fs.max_diff_step, 0]), int(sim[fs.max_diff_step, 1]))
    return fs


def check_files(
    ref_av_vels: str,
    ref_final_state: str,
    av_vels: str,
    final_state: str,
    tolerance: float = 1.0,
) -> CheckResult:
    fs = check_final_state_only(ref_final_state, final_state)
    av_ref = np.loadtxt(ref_av_vels, usecols=[1], ndmin=1)
    av_sim = np.loadtxt(av_vels, usecols=[1], ndmin=1)
    if av_ref.size != av_sim.size:
        raise ValueError("Different number of steps in av_vels files")
    return CheckResult(
        av_vels=diff_values(av_ref, av_sim),
        final_state=fs,
        tolerance=tolerance,
    )


def check_av_vels_only(
    ref_av_vels: str, av_vels: str, tolerance: float = 1.0
) -> DiffStats:
    """For decks that ship an av_vels golden only (``decks/mini_64x64``);
    :func:`check_final_state_only` for those with a final-state golden only
    (``decks/reference_*`` against ``goldens/``)."""
    av_ref = np.loadtxt(ref_av_vels, usecols=[1], ndmin=1)
    av_sim = np.loadtxt(av_vels, usecols=[1], ndmin=1)
    if av_ref.size != av_sim.size:
        raise ValueError("Different number of steps in av_vels files")
    return diff_values(av_ref, av_sim)


def _main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(
        description="Validation checker (port of the reference check.py)",
        fromfile_prefix_chars="@",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--tolerance", nargs=1, default=[1.0], type=float)
    p.add_argument("--ref-av-vels-file", nargs=1, required=True)
    p.add_argument("--ref-final-state-file", nargs=1, required=True)
    p.add_argument("--av-vels-file", nargs=1, required=True)
    p.add_argument("--final-state-file", nargs=1, required=True)
    a = p.parse_args(argv)

    try:
        res = check_files(
            a.ref_av_vels_file[0],
            a.ref_final_state_file[0],
            a.av_vels_file[0],
            a.final_state_file[0],
            tolerance=a.tolerance[0],
        )
    except ValueError as e:
        print(e)
        return 1

    av, fs = res.av_vels, res.final_state
    print(f"Total difference in av_vels : {av.total:.12E}")
    print(f"Biggest difference (at step {av.max_diff_step:d}) : {av.max_diff:.12E}")
    print(f"  {av.sim_val:.12E} vs. {av.ref_val:.12E} = {av.max_diff_pcnt:.2g}%")
    print()
    jj, ii = fs.coord
    print(f"Total difference in final_state : {fs.total:.12E}")
    print(f"Biggest difference (at coord ({jj:d},{ii:d})) : {fs.max_diff:.12E}")
    print(f"  {fs.sim_val:.12E} vs. {fs.ref_val:.12E} = {fs.max_diff_pcnt:.2g}%")
    print()
    if not fs.passed(res.tolerance):
        print("final state failed check")
    if not av.passed(res.tolerance):
        print("av_vels failed check")
    if res.passed:
        print("Both tests passed!")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
