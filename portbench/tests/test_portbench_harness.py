"""The harness driven on the CPU: a throwaway cell and metric found from
files alone, the result line's shape, and the runs that must refuse."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import pytest

from conftest import BENCH, REPO
from portbench import harness

SEED = 2**31 + 11


def _run(bench, name="mini.deck", traced=False, seconds=0.5):
    cell = harness.load_cell(name, bench)
    return harness.run_cell(cell, seed=SEED, seconds=seconds, traced=traced, device="cpu",
                            t_process=time.perf_counter(), log=lambda m: None)


def test_cell_and_metric_from_files_alone(tree):
    # a new metric: one reader file and one BENCHMARK.json entry
    (tree / "metrics" / "throwaway.solves.py").write_text(
        "def read(run):\n    return float(len(run.solves))\n")
    spec_path = tree.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["per_layer"].append({"name": "throwaway.solves", "unit": "solves", "better": "higher",
                              "source": "host_clock", "layer": "tests", "moves": "solve_s",
                              "workloads": ["mini.deck"]})
    spec_path.write_text(json.dumps(spec))
    out = _run(tree, traced=True)
    assert out["correct"] is True and out["failed"] == 0
    assert out["metrics"]["throwaway.solves"]["value"] == out["attempted"] >= 1
    assert {"model.init_s", "model.collate_s", "io.write_s"} <= set(out["metrics"])
    # no device trace on the CPU: its readers leave their metrics out
    assert "device.idle_share" not in out["metrics"]


def test_result_line_shape(tree):
    out = _run(tree)
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert set(out["metrics"]) == {"setup_s", "compute_glups", "solve_s", "solve_p90_s"}
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert out["device"]["count"] == 1
    assert set(out["checks"]) == {"layout_errors", "pressure_pct", "velocity_gap",
                                  "av_vels_pct", "reynolds_pct"}
    assert out["correct"] is True


def test_traffic_parameters_layer(tree):
    (tree / "workloads" / "mini.deck.json").write_text(json.dumps(
        {"limits": json.loads((tree / "workloads" / "mini.deck.json").read_text())["limits"],
         "parameters": {"backend": "fused"}}))
    (tree / "traffic" / "deck.json").write_text(json.dumps(
        {"parameters": {"backend": "pallas", "profiled_solves": 1}}))
    cell = harness.load_cell("mini.deck", tree)
    assert cell.plan == {"backend": "fused", "profiled_solves": 1}
    out = _run(tree)
    assert out["correct"] is True
    # a cell cannot cut a deck's steps, nor name a parameter the harness lacks
    for unknown in ("iters", "speed"):
        (tree / "traffic" / "deck.json").write_text(json.dumps({"parameters": {unknown: 2}}))
        with pytest.raises(ValueError, match=unknown):
            harness.load_cell("mini.deck", tree)


def test_window_formats_into_the_null_device_and_judges_files_after(tree, monkeypatch):
    from advanced_hpc_lbm_tpu_torch.models import d2q9_bgk
    writes = []
    original = d2q9_bgk.SimulationResult.write

    def recorded(self, out_dir=".", **names):
        paths = original(self, out_dir, **names)
        writes.append((paths, time.perf_counter()))
        return paths
    monkeypatch.setattr(d2q9_bgk.SimulationResult, "write", recorded)
    logs = []
    cell = harness.load_cell("mini.deck", tree)
    t0 = time.perf_counter()
    out = harness.run_cell(cell, seed=SEED, seconds=0.5, traced=False, device="cpu",
                           t_process=t0, log=logs.append)
    assert out["correct"] is True
    # the warm solve, the window's solves, then the judged files
    assert len(writes) == out["attempted"] + 2
    for paths, _ in writes[:-1]:
        assert paths == (os.devnull, os.devnull)
    (fs, av), t_files = writes[-1]
    assert os.path.basename(fs) == "final_state.dat" and os.path.basename(av) == "av_vels.dat"
    assert fs.startswith(tempfile.gettempdir() + os.sep)
    window_s = float(next(m for m in logs if m.startswith("window:")).split(" in ")[1].split()[0])
    assert t_files - t0 > window_s


def _cli(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "ref256.deck",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_no_card_no_run():
    res = _cli(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA card" in res.stderr


def test_a_bare_directory_refuses(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _cli(tmp_path, {"PYTHONPATH": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "advanced_hpc_lbm_tpu_torch" in res.stderr


def test_forbidden_modules_by_whole_name():
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    assert run.forbidden_modules(["advanced_hpc_lbm_tpu_torch.ops", "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["jax.numpy", "advanced_hpc_lbm_tpu.cli", "flax"]) == [
        "advanced_hpc_lbm_tpu.cli", "flax", "jax.numpy"]


def test_a_changed_deck_copy_refuses(tree):
    harness.load_cell("ref256.deck", tree)
    with open(tree / "configs" / "ref256.obstacles.dat", "a") as fh:
        fh.write("5 5 1\n")
    with pytest.raises(ValueError, match="sha256"):
        harness.load_cell("ref256.deck", tree)
