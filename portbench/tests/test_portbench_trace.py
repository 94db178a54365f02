"""The trace arithmetic on a synthetic Chrome trace, and the readers that
take device.idle_share and kernels_roofline from it."""

from __future__ import annotations

import json

import pytest

from conftest import BENCH
from portbench import harness, trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


# one Compute phase from 100 to 200 us: kernels 110-130 and 125-150 overlap
# (union 40), a copy 160-170, a kernel partly outside (190-250: 10 inside),
# a kernel wholly outside; the host launches in the gaps
EVENTS = [
    _x(trace.PHASE, "user_annotation", 100, 100),
    _x(trace.PHASE, "gpu_user_annotation", 100, 100),  # the device's copy: ignored
    _x("kstep_kernel<3>", "kernel", 110, 20),
    _x("kstep_kernel<3>", "kernel", 125, 25),
    _x("Memcpy DtoH", "gpu_memcpy", 160, 10),
    _x("step_kernel", "kernel", 190, 60),
    _x("step_kernel", "kernel", 300, 10),
    _x("cudaLaunchKernel", "cuda_runtime", 100, 8),
    _x("aten::sum", "cpu_op", 150, 12),
    _x("cudaLaunchKernel", "cuda_runtime", 152, 4),
    _x("cudaStreamSynchronize", "cuda_runtime", 172, 30),
]


def test_union_and_gaps():
    assert trace.union_length([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.gaps([(0, 10), (5, 15), (20, 30)], 0, 40) == [(15, 20), (30, 40)]
    assert trace.gaps([], 3, 5) == [(3, 5)]


def test_summary_of_one_phase():
    s = trace.summarize(EVENTS)
    assert s["phases"] == 1
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(60e-6)  # 40 + 10 + 10
    assert s["kernel_s"] == pytest.approx(50e-6)  # 40 + 10
    assert s["device_ops"] == pytest.approx(
        {"kstep_kernel<3>": 45e-6, "Memcpy DtoH": 10e-6, "step_kernel": 10e-6})
    # gaps 100-110 (the launch covers 8), 150-160 (aten::sum covers 10,
    # the launch inside it 4), 170-190 (the synchronise covers 18)
    assert s["idle"] == pytest.approx({"cudaLaunchKernel": 10e-6, "aten::sum": 10e-6,
                                       "cudaStreamSynchronize": 20e-6})


def test_merge_and_readers(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    merged = trace.merge([trace.read(path), trace.read(path)])
    assert merged["phases"] == 2
    assert merged["busy_s"] == pytest.approx(120e-6)
    cell = harness.load_cell("ref256.deck")
    run = harness.Run(cell=cell, device_name="NVIDIA H100 80GB HBM3", setup_s=1.0,
                      window_s=1.0, solves=[], trace=merged)
    assert harness.reader("device.idle_share")(run) == pytest.approx(40.0)
    least = 80000 * (86 * (256 * 256 - 1020) + 9 * 254) / 67e12
    assert harness.reader("kernels_roofline")(run) == pytest.approx(
        100 * least * 2 / 100e-6)
    assert trace.top({"a": 1, "b": 3, "c": 2}, 2) == [["b", 3], ["c", 2]]


def test_readers_without_a_trace_return_nothing():
    cell = harness.load_cell("ref1024.deck")
    run = harness.Run(cell=cell, device_name="cpu", setup_s=1.0, window_s=1.0, solves=[],
                      trace=None)
    for name in ("device.idle_share", "kernels_roofline"):
        assert harness.reader(name)(run) is None
    empty = trace.summarize([_x(trace.PHASE, "user_annotation", 0, 10)])
    run.trace, run.device_name = empty, "NVIDIA H100 80GB HBM3"
    for name in ("device.idle_share", "kernels_roofline"):
        assert harness.reader(name)(run) is None


def test_every_benchmark_metric_has_a_reader():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
