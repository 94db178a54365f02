"""The benchmark's configuration of the reference's 128x256 deck
(``portbench/configs/ref128x256.json``) and its cell ``ref128x256.deck``,
and the port against the benchmark's plain reference on that deck, on the
CPU.

The port runs ``auto`` (off CUDA the K-step kernel's plain version, float32)
for 300 steps from the benchmark's seeded initial state; the reference
(``portbench/reference/lbm.py``) runs the same steps in float64.  The
tolerances are float32 against float64 over 300 steps of the deck's
fastest flow: the port's largest gap over three seeds reads 6.6e-6
relative in f and 8.9e-6 in av (each float32 step rounds every value by
up to 6e-8 relative, and the rounding builds up), so f is held at rtol
3e-5 and av at rtol 5e-5.  The TF32 control (the reference in float32
with TF32 operands, the precision below the configuration's) reads 6.9e-3
and 0.19 on the same seeds, and fails both.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, inputs
from portbench.reference import lbm

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "portbench" / "configs" / "ref128x256.json"
STEPS = 300
F_RTOL = 3e-5
AV_RTOL = 5e-5
SEEDS = (2**31 + 5, 3_000_000_007)


def _config() -> dict:
    return json.loads(CONFIG.read_text())


def _deck() -> lbm.Deck:
    cfg = _config()
    return lbm.read_deck(CONFIG.parent / cfg["params_file"], CONFIG.parent / cfg["obstacles_file"])


def test_copies_are_the_repository_deck():
    cfg = _config()
    assert set(cfg["copied_from"]) == set(cfg["sha256"]) == {cfg["params_file"],
                                                             cfg["obstacles_file"]}
    for copy, original in cfg["copied_from"].items():
        data = (CONFIG.parent / copy).read_bytes()
        assert data == (ROOT / original).read_bytes()
        assert hashlib.sha256(data).hexdigest() == cfg["sha256"][copy]


def test_config_states_the_published_deck():
    """SURVEY.md's "Input decks" and "Obstacle decks" rows, uncut."""
    cfg = _config()
    deck = _deck()
    got = (deck.nx, deck.ny, deck.max_iters, deck.reynolds_dim, deck.density, deck.accel,
           deck.omega)
    assert got == (128, 256, 40_000, 10, 0.1, 0.005, 1.85)
    assert got == tuple(cfg[k] for k in ("nx", "ny", "max_iters", "reynolds_dim", "density",
                                        "accel", "omega"))
    assert int(deck.obstacles.sum()) == cfg["obstacle_cells"] == 638
    lines = (CONFIG.parent / cfg["obstacles_file"]).read_text().splitlines()
    assert len(lines) == cfg["obstacle_lines"] == 640
    assert cfg["state_bytes"] == 9 * 4 * deck.nx * deck.ny == 1_179_648
    assert cfg["reduced"] == [] and cfg["reference"] == "reference/lbm.py"
    assert cfg["source"].startswith("https://github.com/ChuyueL/advanced-hpc-lbm ")
    assert "input_128x256.params" in cfg["source"] and "obstacles_128x256.dat" in cfg["source"]


def test_the_cell_is_in_the_benchmark():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (config,) = [c for c in spec["configs"] if c["name"] == "ref128x256"]
    assert config["file"] == "portbench/configs/ref128x256.json" and config["reduced"] == []
    assert config["source"] == _config()["source"]
    (cell,) = [w for w in spec["workloads"] if w["name"] == "ref128x256.deck"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("ref128x256", "deck", 1)
    loaded = harness.load_cell("ref128x256.deck")
    assert loaded.plan == harness.DEFAULTS  # auto, as the other cells
    assert set(loaded.limits) == {"layout_errors", "pressure_pct", "velocity_gap",
                                  "av_vels_pct", "reynolds_pct"}
    assert loaded.limits["layout_errors"] == 0
    assert (loaded.deck.nx, loaded.deck.ny) == (128, 256)


@pytest.fixture(scope="module")
def runs():
    """seed -> (port f, port av, reference f, reference av, control f,
    control av), each made once, on one thread: the suite's workers run
    side by side, and small ops on every core's thread in each of them
    starve one another."""
    deck, cfg = _deck(), _config()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {seed: _run(deck, cfg, seed) for seed in SEEDS}
    finally:
        torch.set_num_threads(threads)


def _run(deck, cfg, seed):
    f0 = inputs.initial_state(deck, seed, "cpu")
    sim = harness.Seeded.from_decks(CONFIG.parent / cfg["params_file"],
                                    CONFIG.parent / cfg["obstacles_file"], device="cpu")
    sim.f0 = f0
    port = sim.run(n_iters=STEPS)
    f_ref, av_ref = lbm.Reference(deck, "cpu").run(f0, STEPS)
    f_ctl, av_ctl = lbm.Reference(deck, "cpu", tf32=True).run(f0, STEPS)
    return (port.f_final, port.av_vels, *(np.asarray(x.numpy(), np.float64)
                                          for x in (f_ref, av_ref, f_ctl, av_ctl)))


@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_the_plain_reference(seed, runs):
    f, av, f_ref, av_ref, _, _ = runs[seed]
    assert f.shape == f_ref.shape == (9, 256, 128) and av.shape == (STEPS,)
    np.testing.assert_allclose(f, f_ref, rtol=F_RTOL, atol=0)
    np.testing.assert_allclose(av, av_ref, rtol=AV_RTOL, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_fails_the_tolerances(seed, runs):
    _, _, f_ref, av_ref, f_ctl, av_ctl = runs[seed]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(f_ctl, f_ref, rtol=F_RTOL, atol=0)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(av_ctl, av_ref, rtol=AV_RTOL, atol=0)


def test_the_seeded_state_reaches_the_wrap():
    """Rows 0 and 255 are fluid on the deck, so the seed moves them: the
    flow that crosses the periodic wrap starts from a perturbed state."""
    deck = _deck()
    f0 = inputs.initial_state(deck, SEEDS[0], "cpu").numpy()
    rest = lbm.rest_state(deck)[:, None]
    for row in (0, deck.ny - 1):
        assert not deck.obstacles[row, 1:-1].any()
        assert np.abs(f0[:, row, 1:-1] - rest).max() > 0
