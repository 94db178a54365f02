"""The port's span recorder (``utils/profiling.span`` / ``recording``), the
spans a deck run records at each layer boundary, the codec's counts
(``csrc/fastio.c``) and the CLI's phase spans, on the CPU."""

import ctypes
import itertools
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from advanced_hpc_lbm_tpu_torch import LBMParams, cli
from advanced_hpc_lbm_tpu_torch.models.d2q9_bgk import Simulation
from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel, resident, step_kernel, stream_kernel
from advanced_hpc_lbm_tpu_torch.utils import io, native, profiling, timers

ROOT = os.path.join(os.path.dirname(__file__), "..")
MINI = (os.path.join(ROOT, "decks", "mini_64x64.params"),
        os.path.join(ROOT, "decks", "mini_64x64.obstacles.dat"))


@pytest.fixture
def clock(monkeypatch):
    """``time.perf_counter_ns`` as 0, 10, 20, ... on each read."""
    ticks = itertools.count(0, 10)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(ticks))


# ---- the recorder ------------------------------------------------------------

def test_span_off_is_the_shared_noop():
    a, b = profiling.span("lbm.a"), profiling.span("lbm.b", n=1)
    assert a is b is profiling._NOOP
    with a as sp:
        sp.set(launches=3)
    with profiling.recording() as rec:
        pass
    assert rec.spans == []
    assert profiling.span("lbm.a") is profiling._NOOP  # off again once it ends


def test_nesting_gives_parents_roots_and_self_times(clock):
    with profiling.recording() as rec:
        with profiling.span("lbm.a"):            # 0 .. 90
            with profiling.span("lbm.b"):        # 10 .. 40
                with profiling.span("lbm.c"):    # 20 .. 30
                    pass
            with profiling.span("lbm.d"):        # 50 .. 60
                pass
            with profiling.span("lbm.e"):        # 70 .. 80
                pass
        with profiling.span("lbm.f"):            # 100 .. 110
            pass
    a, b, c, d, e, f = rec.spans
    assert [s.name for s in rec.spans] == ["lbm.a", "lbm.b", "lbm.c", "lbm.d", "lbm.e", "lbm.f"]
    assert [s.id for s in rec.spans] == list(range(6))
    assert [s.parent for s in rec.spans] == [None, a.id, b.id, a.id, a.id, None]
    assert [s.root for s in rec.spans] == [a.id] * 5 + [f.id]
    assert (a.start_ns, a.end_ns, c.start_ns, c.end_ns) == (0, 90, 20, 30)
    assert a.seconds == pytest.approx(90e-9)
    # a: 90 less b (30), d (10), e (10); b: 30 less c (10); leaves: whole
    assert rec.self_seconds(a) == pytest.approx(40e-9)
    assert rec.self_seconds(b) == pytest.approx(20e-9)
    assert rec.self_seconds(c) == pytest.approx(10e-9)
    assert rec.named("lbm.d") == [d]


def test_attributes_are_kept():
    with profiling.recording() as rec:
        with profiling.span("lbm.ops.loop", backend="pallask") as sp:
            sp.set(launches=7)
            sp.set(launches=8, bytes=64)
    (s,) = rec.spans
    assert s.attrs == {"backend": "pallask", "launches": 8, "bytes": 64}


def test_a_span_ends_on_an_exception_and_a_recording_inside_takes_its_block():
    with profiling.recording() as outer:
        with pytest.raises(ValueError), profiling.span("lbm.x"):
            raise ValueError("boom")
        with profiling.recording() as inner:
            with profiling.span("lbm.y"):
                pass
        with profiling.span("lbm.z"):
            pass
    assert [s.name for s in outer.spans] == ["lbm.x", "lbm.z"]
    assert [s.name for s in inner.spans] == ["lbm.y"]
    x = outer.spans[0]
    assert x.end_ns >= x.start_ns > 0 and outer.spans[1].parent is None


def test_spans_annotate_a_cpu_profile_properly_nested(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.recording() as rec:
        with profiling.span("lbm.outer"):
            with profiling.span("lbm.inner"):
                torch.ones(32, 32).sum()
        torch.ones(8).sum()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation" and e.get("name", "").startswith("lbm.")}
    assert set(ann) == {"lbm.outer", "lbm.inner"}
    o, i = ann["lbm.outer"], ann["lbm.inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert [s.name for s in rec.spans] == ["lbm.outer", "lbm.inner"]


def test_no_annotation_without_a_profile(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profile active")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with profiling.recording() as rec, profiling.span("lbm.a"):
        pass
    assert [s.name for s in rec.spans] == ["lbm.a"]


def test_the_recorder_imports_no_torch():
    """The codec's binding records its spans through the recorder, which
    reaches torch only where something else imported it."""
    path = os.path.join(ROOT, "advanced_hpc_lbm_tpu_torch", "utils", "profiling.py")
    code = "\n".join([
        "import importlib.util, sys",
        f"spec = importlib.util.spec_from_file_location('profiling', {path!r})",
        "m = sys.modules['profiling'] = importlib.util.module_from_spec(spec)",
        "spec.loader.exec_module(m)",
        "with m.recording() as rec, m.span('lbm.a', n=1):",
        "    pass",
        "assert [(s.name, s.attrs) for s in rec.spans] == [('lbm.a', {'n': 1})]",
        "assert 'torch' not in sys.modules, 'torch imported'",
    ])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


# ---- device idle put down to spans ---------------------------------------------

@pytest.mark.parametrize("gaps,want", [
    # a gap inside a loop inside a run: the innermost
    ([(20, 30)], {"lbm.ops.loop": 10}),
    # a gap across a gate and the run around it: split at the gate's end
    ([(0, 15)], {"lbm.model.fit_check": 5, "lbm.model.run": 10}),
    # outside every span
    ([(95, 100)], {"none": 5}),
    # several gaps summed by name
    ([(12, 14), (40, 50), (60, 61)], {"lbm.ops.loop": 11, "lbm.model.run": 2}),
])
def test_idle_by_span(gaps, want):
    spans = [(0, 90, "lbm.model.run"), (0, 5, "lbm.model.fit_check"), (15, 70, "lbm.ops.loop")]
    assert profiling.idle_by_span(gaps, spans) == pytest.approx(want)


def test_trace_summary_puts_idle_down_to_spans(tmp_path):
    def x(name, cat, ts, dur):
        return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}
    events = [
        x(profiling.WINDOW, "user_annotation", 100.0, 100.0),
        x("lbm.model.run", "user_annotation", 100.0, 95.0),
        x("lbm.model.run", "gpu_user_annotation", 100.0, 95.0),  # the device's copy
        x("lbm.model.fit_check", "user_annotation", 102.0, 6.0),
        x("lbm.ops.loop", "user_annotation", 110.0, 80.0),
        x("cudaLaunchKernel", "cuda_runtime", 110.0, 5.0),
        x("kstep_kernel<3>", "kernel", 120.0, 30.0),
        x("kstep_kernel<3>", "kernel", 160.0, 25.0),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profiling.trace_summary(path)
    assert s["busy_us"] == 55.0
    # idle 100-120 (run 2 + 2, gate 6, loop 10), 150-160 (loop), 185-200
    # (loop 5, run 5, none 5)
    assert s["idle_by_span"] == pytest.approx(
        {"lbm.model.run": 9.0, "lbm.model.fit_check": 6.0, "lbm.ops.loop": 25.0, "none": 5.0})
    assert sum(s["idle_by_span"].values()) == pytest.approx(s["window_us"] - s["busy_us"])


# ---- the spans of a deck run ------------------------------------------------------

def _count_launches(monkeypatch, module, launcher, *counters):
    """Make the plain version's launches count as the kernel's would, in the
    module's own counters."""
    make = getattr(module, launcher)

    def counting(*args, **kwargs):
        one = make(*args, **kwargs)

        def launch(*a):
            for c in counters:
                setattr(module, c, getattr(module, c) + 1)
            one(*a)
        return launch
    monkeypatch.setattr(module, launcher, counting)


COUNTED = {
    "pallask": [(kstep_kernel, "_launcher", "launches"), (step_kernel, "_launcher", "launches")],
    "resident": [(resident, "_chunk_launcher", "banded_launches")],
    "stream": [(stream_kernel, "_launcher", "launches", "snapshot_launches"),
               (step_kernel, "_launcher", "launches")],
    "step": [(step_kernel, "_launcher", "launches")],
}
EVERY = {"lbm.model.from_decks", "lbm.model.warmup", "lbm.model.fit_check", "lbm.ops.prepare",
         "lbm.model.run", "lbm.model.initial_state", "lbm.ops.loop", "lbm.model.sync",
         "lbm.model.collate", "lbm.model.to_host", "lbm.model.reynolds", "lbm.io.write",
         "lbm.io.planes", "lbm.io.final_state", "lbm.io.av_vels"}


def _counters():
    return (kstep_kernel.launches + step_kernel.launches + resident.launches
            + resident.banded_launches + stream_kernel.launches + stream_kernel.snapshot_launches)


@pytest.mark.parametrize("backend,loops", [("pallask", 2), ("resident", 1), ("stream", 2),
                                           ("step", 1)])
def test_a_deck_run_records_every_layer(backend, loops, monkeypatch, tmp_path):
    for module, launcher, *counters in COUNTED[backend]:
        _count_launches(monkeypatch, module, launcher, *counters)
    before = _counters()
    with profiling.recording() as rec:
        sim = Simulation.from_decks(*MINI, backend=backend, device="cpu")
        sim.warmup(n_iters=13)
        result = sim.run(n_iters=13, fetch=False)
        result.collate()
        re = result.reynolds
        result.write(tmp_path)
    assert EVERY <= {s.name for s in rec.spans}
    assert math.isfinite(re)
    names = [s.name for s in rec.spans]
    # 13 steps: K = 4 (pallask) and 8 (stream) leave a tail on the step kernel
    assert names.count("lbm.ops.loop") == loops
    launched = _counters() - before
    assert launched > 0
    assert sum(s.attrs["launches"] for s in rec.named("lbm.ops.loop")) == launched
    (run,) = rec.named("lbm.model.run")
    assert run.attrs == {"backend": backend}
    for s in rec.spans:
        assert s.name.startswith("lbm.") and s.end_ns >= s.start_ns
        if s.name in ("lbm.ops.loop", "lbm.model.initial_state"):
            assert rec.spans[s.parent].name == "lbm.model.run"
    assert [rec.spans[s.parent].name for s in rec.named("lbm.model.sync")] == [
        "lbm.model.warmup", "lbm.model.run"]
    to_host = rec.named("lbm.model.to_host")
    assert [t.attrs["bytes"] for t in to_host] == [9 * 64 * 64 * 4, 13 * 4]
    # one memory query each in the gates of warmup and run (the backend is
    # named, so the auto rule asks nothing)
    gates = rec.named("lbm.model.fit_check")
    assert [rec.spans[g.parent].name for g in gates] == ["lbm.model.warmup", "lbm.model.run"]
    assert all(g.attrs == {} for g in gates)
    (fs,) = rec.named("lbm.io.final_state")
    assert fs.attrs["bytes"] == (tmp_path / "final_state.dat").stat().st_size
    (av,) = rec.named("lbm.io.av_vels")
    assert av.attrs["bytes"] == (tmp_path / "av_vels.dat").stat().st_size
    assert len(rec.spans) < 40  # per phase, never per launch


def test_library_spans_say_whether_they_built(monkeypatch, tmp_path):
    native.build()
    native._library.cache_clear()
    try:
        with profiling.recording() as rec:
            assert native.available()
        (lib,) = rec.named("lbm.io.codec_library")
        assert lib.attrs == {"built": 0}
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        native._library.cache_clear()
        with profiling.recording() as rec:
            assert native.available()
        (lib,) = rec.named("lbm.io.codec_library")
        assert lib.attrs == {"built": 1} and lib.seconds > 0
    finally:
        monkeypatch.undo()
        native._library.cache_clear()


# ---- the codec's counts -------------------------------------------------------

def _planes(ny, nx, seed=5):
    rng = np.random.default_rng(seed)
    params = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    f = (rng.random((9, ny, nx)) * 0.02 + 0.005).astype(np.float32)
    mask = rng.random((ny, nx)) < 0.1
    return io.final_state_planes(f, mask, params), mask


@pytest.mark.parametrize("ny,nx,threads", [(13, 11, 1), (300, 500, 2), (300, 500, 8),
                                           (256, 256, 8)])
def test_final_state_stats(ny, nx, threads, tmp_path):
    planes, mask = _planes(ny, nx)
    path = tmp_path / "final_state.dat"
    stats = native.write_final_state(path, planes, mask, threads=threads)
    blocks = -(-ny * nx // 65536)
    assert stats["blocks"] == blocks
    assert 1 <= stats["threads"] <= min(threads, blocks)
    assert stats["bytes"] == path.stat().st_size
    assert stats["format_ns"] > 0 and stats["write_ns"] >= 0 and stats["wait_ns"] >= 0


def test_codec_writes_the_same_bytes_without_stats(tmp_path):
    planes, mask = _planes(300, 500)
    native.write_final_state(tmp_path / "with.dat", planes, mask, threads=3)
    lib = native._require()
    ux, uy, u, p = (np.ascontiguousarray(a, dtype=np.float32) for a in planes)
    rc = lib.lbm_write_final_state(str(tmp_path / "without.dat").encode(), ux, uy, u, p,
                                   mask.view(np.uint8), 500, 300, 1, 3, None)
    assert rc == 0
    assert (tmp_path / "with.dat").read_bytes() == (tmp_path / "without.dat").read_bytes()
    av = np.random.default_rng(2).random(70000)
    stats = native.write_av_vels(tmp_path / "av_with.dat", av)
    assert lib.lbm_write_av_vels(str(tmp_path / "av_without.dat").encode(), av, av.size,
                                 None) == 0
    assert (tmp_path / "av_with.dat").read_bytes() == (tmp_path / "av_without.dat").read_bytes()
    assert stats["bytes"] == (tmp_path / "av_with.dat").stat().st_size
    assert stats["format_ns"] > 0 and stats["write_ns"] >= 0
    assert ctypes.sizeof(native.FinalStateStats) == 7 * 8


def _spans_script():
    import importlib.util

    path = os.path.join(ROOT, "scripts", "torch_spans.py")
    spec = importlib.util.spec_from_file_location("torch_spans", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_codec_spans_count_the_numbers_handed_to_snprintf(tmp_path):
    """``fallback`` on both codec spans of a mini-deck run: 0, every number
    being a float32 the codec prints itself, and so the spans script's
    ``io.codec_fallback_share``; a double that is no float32 counts 1."""
    script = _spans_script()
    steps = 13
    with profiling.recording() as rec:
        with profiling.span(script.SOLVE, window=True, profiled=False):
            sim = Simulation.from_decks(*MINI, backend="pallask", device="cpu")
            sim.run(n_iters=steps, fetch=False).write(tmp_path)
    (fs,) = rec.named("lbm.io.final_state")
    (av,) = rec.named("lbm.io.av_vels")
    assert fs.attrs["fallback"] == av.attrs["fallback"] == 0
    deck = types.SimpleNamespace(nx=64, ny=64, max_iters=steps)
    r = script.readings(rec, [], deck)
    assert r["io.codec_fallback_share"] == 0
    assert script.checks(r, r["ops.launches"])["codec_fallback_share_is_0"]
    with profiling.recording() as rec:
        io.write_av_vels(tmp_path / "av.dat", np.array([0.5, 0.1, 0.25]))
    (av,) = rec.named("lbm.io.av_vels")
    assert av.attrs["fallback"] == 1


@pytest.mark.parametrize("ny,nx", [(256, 128), (128, 256), (13, 11), (11, 13), (7, 7),
                                   (1, 9), (9, 1)])
def test_quirk_clipped_lines_is_the_count(ny, nx):
    """The closed form against the lines counted one by one."""
    ii = np.tile(np.arange(nx), ny)
    jj = np.repeat(np.arange(ny), nx)
    assert io.quirk_clipped_lines(ny, nx) == int(np.count_nonzero(ii * nx + jj >= nx * ny))


@pytest.mark.parametrize("codec", [True, False], ids=["codec", "python"])
@pytest.mark.parametrize("ny,nx,clipped", [(256, 128, 0), (128, 256, 128 * 128)],
                         ids=["128x256", "256x128"])
def test_final_state_span_counts_the_clipped_lines(ny, nx, clipped, codec, monkeypatch,
                                                   tmp_path):
    """``lbm.io.final_state``'s ``quirk_clipped``: 0 on the reference's
    128x256 deck, whose transposed read stays in the grid, the closed form's
    (nx - ny) * ny at 256x128; 0 without the quirk; on the codec's path and
    on the pure-Python one."""
    if not codec:
        monkeypatch.setattr(native, "available", lambda: False)
    rng = np.random.default_rng(7)
    params = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=0.1,
                       accel=0.005, omega=1.85)
    f = (rng.random((9, ny, nx)) * 0.02 + 0.005).astype(np.float32)
    mask = rng.random((ny, nx)) < 0.1
    with profiling.recording() as rec:
        io.write_final_state(tmp_path / "quirk.dat", f, mask, params)
        io.write_final_state(tmp_path / "plain.dat", f, mask, params,
                             emulate_obstacle_column_quirk=False)
    quirk, plain = rec.named("lbm.io.final_state")
    assert quirk.attrs["quirk_clipped"] == clipped == io.quirk_clipped_lines(ny, nx)
    assert plain.attrs["quirk_clipped"] == 0
    assert ("bytes" in quirk.attrs) == codec


def test_the_resident_loop_names_its_form_and_grid():
    """The resident path's ``lbm.ops.loop`` on the reference's 128x256 deck:
    the plain form off CUDA, 32 bands of 8 rows, nx and ny, and one step
    between exchanges, so as many rounds as steps."""
    decks = os.path.join(ROOT, "decks", "reference_128x256")
    sim = Simulation.from_decks(decks + ".params", decks + ".obstacles.dat",
                                backend="resident", device="cpu")
    with profiling.recording() as rec:
        sim.run(n_iters=3)
    (loop,) = rec.named("lbm.ops.loop")
    assert loop.attrs == {"form": "plain", "bands": 32, "nx": 128, "ny": 256, "depth": 1,
                          "rounds": 3, "launches": 0}
    assert resident.num_bands(256) == 32


# ---- the CLI's phases -------------------------------------------------------------

def test_phase_timers_use_the_monotonic_clock(monkeypatch):
    def wall():
        raise AssertionError("time.time read")
    monkeypatch.setattr(timers.time, "time", wall)
    t = timers.PhaseTimers()
    with profiling.recording() as rec:
        with t.phase("init"):
            pass
        with t.phase("write"):
            pass
    assert [s.name for s in rec.spans] == ["lbm.cli.init", "lbm.cli.write"]
    assert t.elapsed["init"] >= 0.0 and "write" in t.elapsed
    assert len(t.report_lines()) == 4  # write stays out of the Elapsed lines


def test_cli_phases_are_spans_and_the_elapsed_lines_keep_their_format(tmp_path, capsys):
    with profiling.recording() as rec:
        assert cli.main([*MINI, "--device", "cpu", "--iters", "12",
                         "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "==done==" and out[1].startswith("Reynolds number:\t\t")
    for line, phase in zip(out[2:], ("Init", "Compute", "Collate", "Total")):
        head, value = line.split("\t\t\t")
        assert head == f"Elapsed {phase} time:"
        assert value.endswith(" (s)") and len(value.split()[0].split(".")[1]) == 6
    roots = [s.name for s in rec.spans if s.parent is None]
    assert roots == ["lbm.cli.init", "lbm.cli.compute", "lbm.cli.collate",
                     "lbm.model.reynolds", "lbm.cli.write"]
    (compute,) = rec.named("lbm.cli.compute")
    assert [s.name for s in rec.spans if s.parent == compute.id] == ["lbm.model.run"]
    (write,) = rec.named("lbm.cli.write")
    assert rec.spans[write.id + 1].name == "lbm.io.write"
