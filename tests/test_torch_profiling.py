"""The port's profiling module: its trace reader, and the CLI's --profile on
the CPU (host activity and the program's spans only: there is no card here,
so no device time)."""

import json
import os

import pytest
import torch

from advanced_hpc_lbm_tpu_torch import cli
from advanced_hpc_lbm_tpu_torch.utils import profiling

ROOT = os.path.join(os.path.dirname(__file__), "..")
MINI = (os.path.join(ROOT, "decks", "mini_64x64.params"),
        os.path.join(ROOT, "decks", "mini_64x64.obstacles.dat"))


@pytest.mark.parametrize("name,base", [
    # as torch.profiler's trace names the port's kernels on an H100
    ("void (anonymous namespace)::kstep_kernel<5, false>((anonymous namespace)::Args)",
     "kstep_kernel"),
    ("(anonymous namespace)::resident_banded_kernel(float*, float*, unsigned char const*, "
     "float*, unsigned long long*, int, int, int, lbm::StepConsts)", "resident_banded_kernel"),
    ("(anonymous namespace)::stream_kernel((anonymous namespace)::Args)", "stream_kernel"),
    ("(anonymous namespace)::snapshot_kernel(float const*, float*, float*, int, int)",
     "snapshot_kernel"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(float)",
     "reduce_kernel"),
    ("void lbm::local_step_kernel<true>(float const*)", "local_step_kernel"),
])
def test_kernel_base_name(name, base):
    assert profiling.kernel_base_name(name) == base


def _event(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def test_trace_summary_busy_share_and_kernels(tmp_path):
    events = [
        _event(profiling.WINDOW, "user_annotation", 100.0, 100.0),
        _event(profiling.WINDOW, "gpu_user_annotation", 110.0, 45.0),
        _event("void kstep_kernel<5, false>(Args)", "kernel", 110.0, 20.0),
        _event("void kstep_kernel<5, false>(Args)", "kernel", 125.0, 10.0),  # overlaps
        _event("step_kernel(float const*)", "kernel", 150.0, 5.0),
        _event("Memcpy DtoH", "gpu_memcpy", 180.0, 30.0),  # clipped at 200
        _event("before the window", "kernel", 50.0, 10.0),
        _event("cudaLaunchKernel", "cuda_runtime", 105.0, 2.0),
        {"name": "process_name", "ph": "M", "ts": 0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profiling.trace_summary(path)
    assert s["window_us"] == 100.0
    assert s["busy_us"] == 25.0 + 5.0 + 20.0
    assert s["busy_share"] == pytest.approx(0.5)
    assert s["first_device_us"] == 10.0
    assert s["kernels"] == {"kstep_kernel": [2, 30.0, 10.0], "step_kernel": [1, 5.0, 50.0]}
    assert list(s["kernels"]) == ["kstep_kernel", "step_kernel"]


def test_trace_summary_wants_one_window(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError, match="expected 1"):
        profiling.trace_summary(path)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(tmp_path / "tr") as tr:
        assert tr.path is None
        torch.ones(64, 64).sum()
    assert tr.path.startswith(str(tmp_path / "tr")) and tr.path.endswith(".pt.trace.json")
    s = profiling.trace_summary(tr.path)
    assert s["window_us"] > 0 and s["busy_us"] == 0.0 and s["kernels"] == {}
    assert s["first_device_us"] is None
    assert s["idle_by_span"] == {"none": s["window_us"]}


def test_cli_profile_leaves_the_block_and_outputs_unchanged(tmp_path, capsys):
    base = [*MINI, "--device", "cpu", "--backend", "pallask", "--iters", "12"]
    outs = {}
    for name, extra in (("plain", []), ("profiled", ["--profile", str(tmp_path / "trace")])):
        d = tmp_path / name
        d.mkdir()
        assert cli.main([*base, *extra, "--out-dir", str(d)]) == 0
        out = capsys.readouterr().out.splitlines()
        outs[name] = [ln.split("\t")[0] if ln.startswith("Elapsed") else ln for ln in out]
        total_s = float(out[-1].split("\t")[-1].split()[0])
        assert out[0] == "==done==" and len(out) == 6
    assert outs["plain"] == outs["profiled"]
    for f in ("final_state.dat", "av_vels.dat"):
        assert (tmp_path / "plain" / f).read_bytes() == (tmp_path / "profiled" / f).read_bytes()
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    s = profiling.trace_summary(tmp_path / "trace" / traces[0])
    # the window holds the Compute phase, not Init (the deck's reading and
    # the kernels' loading) or Collate
    assert 0 < s["window_us"] / 1e6 < total_s
    assert s["busy_us"] == 0.0 and s["kernels"] == {}
    # the device idles through the window, under the program's spans: the
    # Compute phase, the run and its loops
    assert {"lbm.cli.compute", "lbm.ops.loop"} <= set(s["idle_by_span"])
    assert sum(s["idle_by_span"].values()) == pytest.approx(s["window_us"])
