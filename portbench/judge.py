"""The comparison that decides ``correct``: a solve's outputs against the
plain reference's run of the same deck from the same initial state.

Numbers compared, each against the cell's limit (``limits`` in its
``workloads/<cell>.json``):

* ``layout_errors``: lines of ``final_state.dat`` whose coordinates or
  obstacle column differ from the reference writer's, lines of
  ``av_vels.dat`` whose step differs, missing or extra lines, and lines of
  a seeded sample whose text is not the reference's ``%d %d %.12E ...``
  format.  Exact: limit 0.
* ``pressure_pct``: the reference checker's rule, the largest
  ``100 * diff / (ref - diff)`` over the pressure column.
* ``velocity_gap``: the largest gap of u_x, u_y and ||u|| over all cells,
  over the reference's largest speed.
* ``av_vels_pct``: the checker's rule over the av history.
* ``reynolds_pct``: the Reynolds number's gap, in % of the reference's.
"""

from __future__ import annotations

import re

import numpy as np

from portbench.reference import lbm

_E = rb"-?\d\.\d{12}E[+-]\d{2,3}"
_FINAL_LINE = re.compile(rb"\d+ \d+ " + rb" ".join([_E] * 4) + rb" [01]")
_AV_LINE = re.compile(rb"\d+:\t" + _E)
FORMAT_SAMPLE = 4096


def checker_pct(ref: np.ndarray, sim: np.ndarray) -> float:
    """The reference checker's largest |100 * diff / (ref - diff)|, diff =
    ref - sim (infinite where a value is not finite)."""
    ref = np.asarray(ref, dtype=np.float64)
    sim = np.asarray(sim, dtype=np.float64)
    diff = ref - sim
    with np.errstate(divide="ignore", invalid="ignore"):
        pct = np.abs(100.0 * (diff / (ref - diff)))
    return float(np.max(pct)) if np.all(np.isfinite(pct)) else float("inf")


class Expected:
    """What the reference's run says a solve must give."""

    def __init__(self, deck: lbm.Deck, f_ref: np.ndarray, av_ref: np.ndarray) -> None:
        self.deck = deck
        self.planes = lbm.output_planes(deck, f_ref)
        self.av = np.asarray(av_ref, dtype=np.float64)
        self.reynolds = lbm.reynolds(deck, self.av[-1])
        self.speed = float(np.max(self.planes["u"]))

    def numbers(self, planes: dict, av: np.ndarray, reynolds: float) -> dict[str, float]:
        """The compared numbers but ``layout_errors``, from a solve's
        output columns (``u_x``, ``u_y``, ``u``, ``pressure``, flat raster
        order), av history and Reynolds number."""
        gap = max(float(np.max(np.abs(np.asarray(planes[k], np.float64) - self.planes[k])))
                  for k in ("u_x", "u_y", "u"))
        av = np.asarray(av, dtype=np.float64)
        return {
            "pressure_pct": checker_pct(self.planes["pressure"], planes["pressure"]),
            "velocity_gap": gap / self.speed if np.isfinite(gap) else float("inf"),
            "av_vels_pct": (checker_pct(self.av, av) if av.shape == self.av.shape
                            else float("inf")),
            "reynolds_pct": (100.0 * abs(reynolds - self.reynolds) / abs(self.reynolds)
                             if np.isfinite(reynolds) else float("inf")),
        }

    def state_numbers(self, f: np.ndarray, av: np.ndarray, reynolds: float) -> dict[str, float]:
        """:meth:`numbers` of a solve's final state, whose output columns
        the reference works out."""
        return {"layout_errors": 0, **self.numbers(lbm.output_planes(self.deck, f), av, reynolds)}

    def file_numbers(self, final_state_path, av_vels_path, reynolds: float,
                     rng: np.random.Generator) -> dict[str, float]:
        """Every compared number, from the two files a solve wrote."""
        deck = self.deck
        n = deck.nx * deck.ny
        with open(final_state_path, "rb") as fh:
            fs_data = fh.read()
        with open(av_vels_path, "rb") as fh:
            av_data = fh.read()
        fs_lines, av_lines = fs_data.split(b"\n"), av_data.split(b"\n")
        errors = 0
        for lines in (fs_lines, av_lines):
            if lines and lines[-1] == b"":
                lines.pop()
            else:
                errors += 1  # no final newline
        errors += abs(len(fs_lines) - n) + abs(len(av_lines) - deck.max_iters)
        for lines, pattern in ((fs_lines, _FINAL_LINE), (av_lines, _AV_LINE)):
            if lines:
                picks = rng.choice(len(lines), size=min(FORMAT_SAMPLE, len(lines)), replace=False)
                errors += sum(pattern.fullmatch(lines[i]) is None for i in picks)
        try:
            table = np.array(fs_data.split(), dtype=np.float64).reshape(n, 7)
            steps, av = np.array(av_data.replace(b":", b" ").split(),
                                 dtype=np.float64).reshape(deck.max_iters, 2).T
        except ValueError:  # a token that is no number, or a wrong count
            return {"layout_errors": errors + 1, "pressure_pct": float("inf"),
                    "velocity_gap": float("inf"), "av_vels_pct": float("inf"),
                    "reynolds_pct": float("inf")}
        ii = np.tile(np.arange(deck.nx), deck.ny)
        jj = np.repeat(np.arange(deck.ny), deck.nx)
        errors += int(np.count_nonzero((table[:, 0] != ii) | (table[:, 1] != jj)
                                       | (table[:, 6] != lbm.obstacle_column(deck))))
        errors += int(np.count_nonzero(steps != np.arange(deck.max_iters)))
        planes = dict(zip(("u_x", "u_y", "u", "pressure"), table[:, 2:6].T))
        return {"layout_errors": errors, **self.numbers(planes, av, reynolds)}


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Whether every number is within its limit (a missing number fails)."""
    return all(name in numbers and numbers[name] <= limits[name] for name in limits)


def worst(readings: list[dict[str, float]]) -> dict[str, float]:
    """The largest reading of each number over several solves."""
    return {name: max(r[name] for r in readings) for name in readings[0]}
