"""The program's span recorder as the harness stands: an untraced run
never enters it, so the program's spans cost each measured run one global
check per span and nothing more, and a traced run enters it once; and a
solve recorded from outside the harness gives every span a per-layer
reader of the window would read."""

from __future__ import annotations

import contextlib
import time

import pytest

import torch

from portbench import harness, spans

from advanced_hpc_lbm_tpu_torch.utils import profiling

SEED = 2**31 + 17


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced-once"])
def test_runs_never_enter_the_recorder(tree, monkeypatch, traced):
    """Untraced: never.  Traced: one recording, over the warm solve and the
    window, each solve under its root span."""
    entered = []
    recording = profiling.recording

    def counted():
        if not traced:
            raise AssertionError("the recorder was entered")
        entered.append(1)
        return recording()

    def refuse(*args, **kwargs):
        raise AssertionError("a span was recorded")
    monkeypatch.setattr(profiling, "recording", counted)
    if not traced:
        monkeypatch.setattr(profiling, "_Active", refuse)
    cell = harness.load_cell("mini.deck", tree)
    out = harness.run_cell(cell, seed=SEED, seconds=0.2, traced=traced, device="cpu",
                           t_process=time.perf_counter(), log=lambda m: None)
    assert out["correct"] is True
    assert profiling._recorder is None
    assert len(entered) == int(traced)


def test_a_traced_run_records_every_solve(tree, monkeypatch):
    recorders = []
    recording = profiling.recording

    @contextlib.contextmanager
    def kept():
        with recording() as rec:
            recorders.append(rec)
            yield rec
    monkeypatch.setattr(profiling, "recording", kept)
    cell = harness.load_cell("mini.deck", tree)
    out = harness.run_cell(cell, seed=SEED, seconds=0.2, traced=True, device="cpu",
                           t_process=time.perf_counter(), log=lambda m: None)
    (rec,) = recorders
    roots = [s for s in rec.spans if s.parent is None]
    assert all(r.name == spans.SOLVE for r in roots)
    # the warm solve, then the window's (none profiled without a card)
    assert [(r.attrs["window"], r.attrs["profiled"]) for r in roots] == (
        [(False, False)] + [(True, False)] * out["attempted"])


def test_a_recorded_solve_has_every_layer(tree):
    from portbench import inputs

    cell = harness.load_cell("mini.deck", tree)
    f0 = inputs.initial_state(cell.deck, SEED, torch.device("cpu"))
    solver = harness.Solver(cell, f0, torch.device("cpu"), str(tree))
    with profiling.recording() as rec:
        solve = solver.solve()
    names = {s.name for s in rec.spans}
    assert {"lbm.model.from_decks", "lbm.model.warmup", "lbm.model.fit_check",
            "lbm.model.run", "lbm.model.initial_state", "lbm.ops.loop", "lbm.model.sync",
            "lbm.model.collate", "lbm.model.to_host", "lbm.model.reynolds", "lbm.io.write",
            "lbm.io.planes", "lbm.io.final_state", "lbm.io.av_vels"} <= names
    (write,) = rec.named("lbm.io.write")
    parts = sum(s.seconds for s in rec.spans
                if s.name in ("lbm.io.planes", "lbm.io.final_state", "lbm.io.av_vels"))
    assert parts <= write.seconds <= solve.write
    (run,) = rec.named("lbm.model.run")
    assert run.seconds <= solve.compute


def _script():
    import importlib.util

    path = harness.BENCH.parent / "scripts" / "torch_spans.py"
    spec = importlib.util.spec_from_file_location("torch_spans", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_spans_script_reads_every_span_and_count(tree):
    script = _script()
    cell = harness.load_cell("mini.deck", tree)
    out = script.measure(cell, "cpu", solves=2, profiled=1, pairs=0)
    r = out["readings"]
    assert r["solves"] == 2 and r["model.backend"] == ["pallask"]
    assert all(out["checks"].values()) and "loop_and_gate_within_idle" not in out["checks"]
    assert r["ops.launches"] == r["ops.launches_counted"]  # no launch counted on the CPU
    for key in ("model.from_decks_s", "model.warmup_s", "model.fit_check_s", "model.to_host_s",
                "model.reynolds_s", "io.planes_s", "io.final_state_s", "io.av_vels_s",
                "io.codec_wait_s", "io.codec_write_s", "io.av_vels_format_s",
                "io.av_vels_write_s"):
        assert r[key] >= 0.0, key
    assert r["io.av_vels_format_s"] > 0 and 0 < r["io.codec_parallelism"] <= 1.0 + 1e-9
    assert (r["io.codec_blocks"], r["io.codec_threads_used"]) == (1, 1)
    # the deck's 64 x 64 lines and 500 steps, formatted into the null device
    assert r["io.final_state_bytes"] > 64 * 64 * 6 * 12 and r["io.av_vels_bytes"] > 500 * 18
    assert r["model.to_host_bytes"] == 9 * 64 * 64 * 4 + 500 * 4
    # auto's rule and the gates of warmup and run, one memory query each
    # (none reaches a card on the CPU)
    assert r["model.fit_check_queries"] == 3
    assert sorted(out["fit_check_queries_s"]) == ["lbm.model.from_decks", "lbm.model.run",
                                                  "lbm.model.warmup"]
    assert all(len(v) == 2 for v in out["fit_check_queries_s"].values())
    assert set(r["setup.libraries"]) <= set(script.LIBRARIES)
    assert "device.idle_share" not in r  # no device work on the CPU


def test_the_spans_script_puts_idle_down_to_program_spans():
    script = _script()

    def x(name, cat, ts, dur):
        return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}
    events = [
        x("portbench.compute", "user_annotation", 0.0, 100.0),
        x("lbm.model.run", "user_annotation", 0.0, 100.0),
        x("lbm.model.fit_check", "user_annotation", 2.0, 8.0),
        x("lbm.ops.loop", "user_annotation", 20.0, 70.0),
        x("k", "kernel", 10.0, 20.0), x("k", "kernel", 40.0, 40.0),
        # outside every Compute phase: not counted
        x("lbm.io.write", "user_annotation", 150.0, 50.0),
    ]
    got = script.idle_by_span(events)
    # idle 0-10 (run 2, gate 8), 30-40 (loop), 80-100 (loop 10, run 10)
    assert got == pytest.approx({"lbm.model.run": 12e-6, "lbm.model.fit_check": 8e-6,
                                 "lbm.ops.loop": 20e-6})
