"""The work counts of kernels_roofline against hand arithmetic."""

from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import BENCH
from portbench import work
from portbench.reference import lbm


def _deck(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return lbm.read_deck(BENCH / "configs" / cfg["params_file"],
                         BENCH / "configs" / cfg["obstacles_file"])


def test_operations_per_cell_add_up():
    # rho 8, 1/rho 1, u 12, u^2 3, base 2, rest 4, diagonals 2, pairs 4 x 13,
    # sqrt 1, the sum's add 1; forcing: 3 guard subtractions and 6 adds
    assert work.OPS_PER_FLUID_CELL_STEP == 8 + 1 + 12 + 3 + 2 + 4 + 2 + 4 * 13 + 1 + 1
    assert work.OPS_PER_FORCED_CELL_STEP == 3 + 6
    assert work.BYTES_PER_CELL == 73


@pytest.mark.parametrize("name, fluid, forced, steps", [
    # 1024^2: box (4092 cells) and the wall x = 341, y = 1..1022 (1022 cells);
    # row 1022 holds x = 0, 341, 1023
    ("ref1024", 1024 * 1024 - 5114, 1024 - 3, 20000),
    # 256^2: the box, 4 * 255 cells; row 254 holds x = 0 and 255
    ("ref256", 256 * 256 - 1020, 256 - 2, 80000),
])
def test_deck_counts_by_hand(name, fluid, forced, steps):
    deck = _deck(name)
    ops = work.deck_ops(deck.obstacles, deck.max_iters)
    assert ops == steps * (86 * fluid + 9 * forced)
    nbytes = work.deck_bytes(deck.obstacles, deck.max_iters)
    assert nbytes == 73 * deck.nx * deck.ny + 4 * steps
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    t, bound = work.least_seconds(deck.obstacles, deck.max_iters, peak)
    assert bound == "operations"
    assert t == pytest.approx(ops / 67e12)


def test_work_does_not_depend_on_launches():
    deck = _deck("ref256")
    # a run counted in one piece or in pieces of any length is the same work
    assert work.deck_ops(deck.obstacles, 80000) == 8 * work.deck_ops(deck.obstacles, 10000)


def test_unknown_card_has_no_peaks():
    assert work.peaks("cpu") is None
    assert work.peaks("NVIDIA A100-SXM4-80GB") is None


def test_the_1024_deck_least_time():
    deck = _deck("ref1024")
    t, _ = work.least_seconds(deck.obstacles, deck.max_iters, work.PEAKS["H100 80GB HBM3"])
    assert t == pytest.approx(20000 * (86 * 1043462 + 9 * 1021) / 67e12)
    assert 0.0267 < t < 0.0269
    assert np.count_nonzero(~deck.obstacles) == 1043462
