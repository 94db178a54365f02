"""A throwaway benchmark tree for the CPU tests: a copy of the benchmark's
folder beside a ``BENCHMARK.json`` that adds a cell on the 64x64 mini deck
(500 steps), which the CPU runs in well under a second a solve."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(REPO)]

# limits of the mini cell on the CPU, between the program's readings on
# seeds 1 and 2 (pressure_pct 0.000275, velocity_gap 1.47e-5, av_vels_pct
# 0.00152, reynolds_pct 0.00050) and the TF32 control's on seeds 3 and 4
# (0.210, 0.0234, 10.5, 0.0779)
MINI_LIMITS = {"layout_errors": 0, "pressure_pct": 0.01, "velocity_gap": 2e-4,
               "av_vels_pct": 0.02, "reynolds_pct": 0.01}


def make_tree(root: Path) -> Path:
    """``root``/BENCHMARK.json and ``root``/portbench with the cell
    ``mini.deck``; returns the benchmark folder."""
    bench = root / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for suffix in ("params", "obstacles.dat"):
        shutil.copy(REPO / "decks" / f"mini_64x64.{suffix}", bench / "configs" / f"mini.{suffix}")
    (bench / "configs" / "mini.json").write_text(json.dumps(
        {"name": "mini", "params_file": "mini.params", "obstacles_file": "mini.obstacles.dat"}))
    (bench / "workloads" / "mini.deck.json").write_text(json.dumps({"limits": MINI_LIMITS}))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "mini", "source": "decks/mini_64x64",
                            "file": "portbench/configs/mini.json", "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "mini.deck", "config": "mini", "traffic": "deck",
                              "chips": 1, "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


@pytest.fixture
def tree(tmp_path) -> Path:
    return make_tree(tmp_path)
