"""``calibrate.py`` on the CPU, on the mini cell: each seed's line carries
the harness's verdict under the cell's limits, and the exit code says
whether every program seed read correct and every control seed not."""

from __future__ import annotations

import json

from conftest import MINI_LIMITS
from portbench import calibrate, harness


def test_verdicts_under_the_cell_limits(tree):
    cell = harness.load_cell("mini.deck", tree)
    lines = []
    rc = calibrate.calibrate(cell, [5], [6], "cpu", out=lines.append)
    rows = [json.loads(line) for line in lines]
    assert [(r["kind"], r["seed"], r["correct"]) for r in rows[:-1]] == [
        ("program", 5, True), ("control", 6, False)]
    summary = rows[-1]
    assert summary["limits"] == MINI_LIMITS and summary["wrong_verdicts"] == 0
    assert set(summary["lower"]) == set(summary["upper"]) == set(MINI_LIMITS)
    assert rc == 0


def test_a_control_that_passes_fails_the_calibration(tree):
    # limits so loose that the control reads correct: the calibration refuses them
    spec = tree / "workloads" / "mini.deck.json"
    spec.write_text(json.dumps({"limits": {k: 1e9 for k in MINI_LIMITS}}))
    cell = harness.load_cell("mini.deck", tree)
    lines = []
    assert calibrate.calibrate(cell, [], [6], "cpu", out=lines.append) == 1
    assert json.loads(lines[0])["correct"] is True
    assert json.loads(lines[-1])["wrong_verdicts"] == 1
