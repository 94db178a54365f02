"""The configurations' frozen deck copies: equal to the repository's
decks, with the reference solver's published values and obstacle counts."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

from conftest import BENCH, REPO
from portbench.reference import lbm

# SURVEY.md, "Input decks" and "Obstacle decks": nx, ny, maxIters,
# reynolds_dim, density, accel, omega; the obstacle cells of each deck
PUBLISHED = {
    "ref1024": ((1024, 1024, 20000, 10, 0.1, 0.01, 1.85), 5114),
    "ref256": ((256, 256, 80000, 10, 0.1, 0.005, 1.85), 1020),
}


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_copy_matches_the_repository_deck(name):
    cfg = _config(name)
    for copy, original in cfg["copied_from"].items():
        data = (BENCH / "configs" / copy).read_bytes()
        assert data == (REPO / original).read_bytes()
        assert hashlib.sha256(data).hexdigest() == cfg["sha256"][copy]


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_params_and_obstacles_are_the_published_ones(name):
    cfg = _config(name)
    values, cells = PUBLISHED[name]
    deck = lbm.read_deck(BENCH / "configs" / cfg["params_file"],
                         BENCH / "configs" / cfg["obstacles_file"])
    got = (deck.nx, deck.ny, deck.max_iters, deck.reynolds_dim, deck.density, deck.accel,
           deck.omega)
    assert got == values
    assert got == tuple(cfg[k] for k in ("nx", "ny", "max_iters", "reynolds_dim", "density",
                                        "accel", "omega"))
    assert int(deck.obstacles.sum()) == cells == cfg["obstacle_cells"]
    assert cfg["reduced"] == []


def test_the_1024_deck_has_its_wall():
    cfg = _config("ref1024")
    deck = lbm.read_deck(BENCH / "configs" / cfg["params_file"],
                         BENCH / "configs" / cfg["obstacles_file"])
    assert deck.obstacles[1:1023, 341].all()
    assert np.array_equal(deck.obstacles[:, 0], np.ones(1024, bool))
