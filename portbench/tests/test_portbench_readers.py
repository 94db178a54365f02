"""The readers of the program's spans: each on a recording whose numbers
are known, on a traced run of the mini cell on the CPU with the relations
that tie them to the harness's own readings, and with nothing to read."""

from __future__ import annotations

import ast
import time

import pytest

from portbench import harness, spans, trace

from advanced_hpc_lbm_tpu_torch.utils import native, profiling

SEED = 2**31 + 23
HOST = ("model.fit_check_s", "model.to_host_s", "model.reynolds_s", "io.planes_s",
        "io.final_state_s", "io.av_vels_s", "io.codec_parallelism", "ops.launches",
        "setup.libraries_s")
DEVICE = ("device.loop_idle_share", "device.gate_idle_share")


class Spans:
    """A recorder filled by hand: ``add`` a span, with times in ns."""

    def __init__(self) -> None:
        self.rec = profiling.Recorder()

    def add(self, name, start, end, parent=None, **attrs):
        rec = self.rec
        root = rec.spans[parent].root if parent is not None else len(rec.spans)
        rec.spans.append(profiling.Span(name=name, id=len(rec.spans), parent=parent,
                                        root=root, start_ns=start, end_ns=end, attrs=attrs))
        return len(rec.spans) - 1


def _solve(s: Spans, t: int, *, window=True, profiled=False, scale=1):
    """A solve's spans from ``t`` on, every length times ``scale``."""
    k = scale
    root = s.add(spans.SOLVE, t, t + 1000 * k, window=window, profiled=profiled)
    s.add("lbm.model.fit_check", t + 10 * k, t + 30 * k, root)
    if not window:
        prep = s.add("lbm.ops.prepare", t + 40 * k, t + 140 * k, root)
        s.add("lbm.ops.library", t + 50 * k, t + 120 * k, prep, built=1)
    run = s.add("lbm.model.run", t + 200 * k, t + 600 * k, root)
    gate = s.add("lbm.model.fit_check", t + 210 * k, t + 250 * k, run)
    s.add("lbm.model.inner", t + 220 * k, t + 230 * k, gate)  # 10 of the gate's 40 not its own
    s.add("lbm.ops.loop", t + 260 * k, t + 590 * k, run, launches=40)
    collate = s.add("lbm.model.collate", t + 600 * k, t + 700 * k, root)
    s.add("lbm.model.to_host", t + 610 * k, t + 680 * k, collate, bytes=4)
    s.add("lbm.model.reynolds", t + 700 * k, t + 705 * k, root)
    write = s.add("lbm.io.write", t + 710 * k, t + 990 * k, root)
    s.add("lbm.io.planes", t + 720 * k, t + 750 * k, write)
    s.add("lbm.io.final_state", t + 750 * k, t + 950 * k, write, format_ns=150 * k)
    s.add("lbm.io.av_vels", t + 950 * k, t + 980 * k, write, format_ns=20 * k)
    if not window:
        s.add("lbm.io.codec_library", t + 985 * k, t + 988 * k, write, built=0)


def _recorded_run(cell, rec, summary=None):
    return harness.Run(cell=cell, device_name="cpu", setup_s=1.0, window_s=1.0, solves=[],
                       trace=summary, spans=rec)


def test_readers_on_a_known_recording():
    s = Spans()
    _solve(s, 0, window=False, scale=3)  # the warm solve: only its libraries are read
    _solve(s, 10_000)
    _solve(s, 20_000, profiled=True, scale=7)  # profiled: not read
    _solve(s, 30_000)
    s.add("lbm.io.write", 40_000, 41_000)  # outside every solve: not read
    run = _recorded_run(harness.load_cell("ref256.deck"), s.rec)
    got = {name: harness.reader(name)(run) for name in HOST}
    assert got == pytest.approx({
        "model.fit_check_s": (20 + 30) * 1e-9,  # two queries, the second's child left out
        "model.to_host_s": 70e-9,
        "model.reynolds_s": 5e-9,
        "io.planes_s": 30e-9,
        "io.final_state_s": 200e-9,
        "io.av_vels_s": 30e-9,
        "io.codec_parallelism": 150 / 200,
        "ops.launches": 40,
        "setup.libraries_s": 3 * (100 + 3) * 1e-9,  # prepare holds the library
    })


def test_readers_on_a_traced_cpu_run(tree):
    logs = []
    cell = harness.load_cell("mini.deck", tree)
    out = harness.run_cell(cell, seed=SEED, seconds=0.3, traced=True, device="cpu",
                           t_process=time.perf_counter(), log=logs.append)
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(HOST) <= set(m)
    assert not set(DEVICE) & set(m)  # no device trace on the CPU
    for name in HOST:
        assert m[name] >= 0, name
    # the relations between the readers and the harness's own readings
    logged = next(x for x in logs if x.startswith("launches per solve:"))
    launches = ast.literal_eval(logged.split(": ", 1)[1])
    assert m["ops.launches"] == sum(launches.values())
    assert m["io.planes_s"] + m["io.final_state_s"] + m["io.av_vels_s"] <= m["io.write_s"]
    assert m["model.to_host_s"] + m["model.reynolds_s"] <= m["model.collate_s"]
    # the mini deck's final state is one block: one thread formats it
    assert 0 < m["io.codec_parallelism"] <= min(1.05, native.default_threads())
    assert m["setup.libraries_s"] > 0


@pytest.mark.parametrize("name", HOST + DEVICE)
def test_readers_with_nothing_to_read(name):
    run = _recorded_run(harness.load_cell("ref1024.deck"), None)
    assert harness.reader(name)(run) is None
    # a recording with no read solve, a trace with no device work
    s = Spans()
    s.add(spans.SOLVE, 0, 10, window=True, profiled=True)
    run = _recorded_run(run.cell, s.rec, trace.summarize(
        [{"ph": "X", "name": trace.PHASE, "cat": "user_annotation", "ts": 0, "dur": 10}]))
    assert harness.reader(name)(run) is None


def _x(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


# one Compute phase 0-100 us; idle 0-10 (run 2, gate 8), 30-40 (loop),
# 80-100 (loop 10, run 5, sync 5)
EVENTS = [
    _x(trace.PHASE, "user_annotation", 0.0, 100.0),
    _x("lbm.model.run", "user_annotation", 0.0, 100.0),
    _x("lbm.model.fit_check", "user_annotation", 2.0, 8.0),
    _x("cudaMemGetInfo", "cuda_runtime", 3.0, 6.0),
    _x("lbm.ops.loop", "user_annotation", 20.0, 70.0),
    _x("lbm.model.sync", "user_annotation", 95.0, 5.0),
    _x("lbm.model.fit_check", "gpu_user_annotation", 2.0, 8.0),  # the device's copy
    _x("k", "kernel", 10.0, 20.0), _x("k", "kernel", 40.0, 40.0),
    # outside every Compute phase: not counted
    _x("lbm.io.write", "user_annotation", 150.0, 50.0),
    _x("k", "kernel", 210.0, 5.0),
]


def test_idle_by_span_from_the_summary():
    s = trace.summarize(EVENTS)
    assert s["idle_by_span"] == pytest.approx({"lbm.model.run": 7e-6, "lbm.model.sync": 5e-6,
                                               "lbm.model.fit_check": 8e-6,
                                               "lbm.ops.loop": 20e-6})
    # the host's view leaves the program's spans aside
    # (a gap goes whole to the host event that covers most of it)
    assert s["idle"] == pytest.approx({"cudaMemGetInfo": 10e-6, "host: untraced": 30e-6})
    merged = trace.merge([s, trace.summarize(EVENTS[:1] + EVENTS[7:9])])
    assert merged["idle_by_span"] == pytest.approx({"lbm.model.run": 7e-6, "lbm.model.sync": 5e-6,
                                                    "lbm.model.fit_check": 8e-6,
                                                    "lbm.ops.loop": 20e-6, "none": 40e-6})
    run = _recorded_run(harness.load_cell("ref256.deck"), None, s)
    got = {name: harness.reader(name)(run) for name in DEVICE + ("device.idle_share",)}
    assert got == pytest.approx({"device.loop_idle_share": 20.0, "device.gate_idle_share": 8.0,
                                 "device.idle_share": 40.0})
    assert got["device.loop_idle_share"] + got["device.gate_idle_share"] <= got[
        "device.idle_share"]


def test_a_program_span_without_idle_reads_0():
    events = [_x(trace.PHASE, "user_annotation", 0.0, 10.0),
              _x("lbm.model.fit_check", "user_annotation", 1.0, 2.0),
              _x("k", "kernel", 0.0, 10.0)]
    run = _recorded_run(harness.load_cell("ref256.deck"), None, trace.summarize(events))
    assert harness.reader("device.gate_idle_share")(run) == 0.0
    assert harness.reader("device.loop_idle_share")(run) is None
