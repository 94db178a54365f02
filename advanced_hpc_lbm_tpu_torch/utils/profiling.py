"""Performance instrumentation: throughput, the memory roofline and a
profiler trace.

The counterpart of ``advanced_hpc_lbm_tpu.utils.profiling``:

* ``BenchResult`` / ``measure`` / ``roofline_report``: GLUPS and the bytes
  of the single-pass model of a measured run against the card's memory
  rate (``device_hbm_gbps``);
* ``trace``: a ``torch.profiler`` trace of the enclosed block, written as
  a Chrome trace (chrome://tracing, Perfetto, TensorBoard), the CLI's
  ``--profile``; ``trace_summary`` reads one back: the device's busy share
  of the traced window and the kernels by device time.

The JAX module's table of TPU memory rates and its note on the TPU's VMEM
are facts of that chip and have no counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import socket
import time

import torch

# one step moves 9 fp32 planes in + out plus an int8 mask read
BYTES_PER_CELL_STEP = 9 * 4 * 2 + 1
# data-sheet memory rates (GB/s) by a substring of torch.cuda.get_device_name():
# the H100 SXM's HBM3 at 3.35 TB/s
_HBM_GBPS = {
    "H100 80GB HBM3": 3350.0,
}
# the user annotation around a traced block: its span is the trace's window
WINDOW = "lbm_trace_window"
# event categories of device work in a Chrome trace of torch.profiler
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class BenchResult:
    nx: int
    ny: int
    iters: int
    elapsed_s: float

    @property
    def mlups(self) -> float:
        return self.nx * self.ny * self.iters / self.elapsed_s / 1e6

    @property
    def glups(self) -> float:
        return self.mlups / 1e3

    @property
    def effective_gbps(self) -> float:
        """Achieved memory traffic assuming the single-pass roofline."""
        return self.nx * self.ny * self.iters * BYTES_PER_CELL_STEP / self.elapsed_s / 1e9


def device_hbm_gbps(device: torch.device | str | int | None = None) -> float | None:
    """The data-sheet memory rate of the CUDA card (GB/s), or None off CUDA
    and for a card the table does not know."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for key, bw in _HBM_GBPS.items():
        if key in name:
            return bw
    return None


def roofline_report(result: BenchResult) -> str:
    lines = [
        f"grid {result.nx}x{result.ny}, {result.iters} iters in "
        f"{result.elapsed_s:.3f} s",
        f"throughput: {result.glups:.3f} GLUPS ({result.mlups:.0f} MLUPS)",
        f"effective HBM traffic (single-pass model): "
        f"{result.effective_gbps:.0f} GB/s",
    ]
    peak = device_hbm_gbps()
    if peak:
        ceiling = peak / BYTES_PER_CELL_STEP  # GLUPS
        lines.append(
            f"HBM roofline ({torch.cuda.get_device_name()}, data sheet): "
            f"{peak:.0f} GB/s -> {ceiling:.1f} GLUPS ceiling; "
            f"achieved {100 * result.glups / ceiling:.0f}% of roofline"
        )
    return "\n".join(lines)


def measure(run_fn, nx: int, ny: int, iters: int) -> BenchResult:
    """Time run_fn() (which must block until done) and wrap the numbers."""
    tic = time.perf_counter()
    run_fn()
    return BenchResult(nx=nx, ny=ny, iters=iters, elapsed_s=time.perf_counter() - tic)


@dataclasses.dataclass
class Trace:
    """What :func:`trace` yields: ``path`` is the Chrome trace's file, set
    when the block has ended."""

    path: str | None = None


@contextlib.contextmanager
def trace(trace_dir: str | os.PathLike):
    """``torch.profiler`` trace of the enclosed block: host activity, and
    the device's when a CUDA card is present, inside one ``WINDOW``
    annotation.  On exit the trace goes to
    ``trace_dir/<host>.<pid>.<ns>.pt.trace.json`` (the name TensorBoard's
    profiler plugin reads)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Trace()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield out
    out.path = os.path.join(
        str(trace_dir), f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(out.path)


def kernel_base_name(name: str) -> str:
    """The function's own name in a device event's (demangled) name:
    ``void (anonymous namespace)::kstep_kernel<5, false>((anonymous
    namespace)::Args)`` -> ``kstep_kernel``."""
    head = re.split(r"[(<]", name.replace("(anonymous namespace)", ""), maxsplit=1)[0]
    return re.split(r"[\s:]+", head.strip())[-1]


def trace_summary(path: str | os.PathLike) -> dict:
    """The device's work in a trace of :func:`trace`, within its window.

    Returns ``window_us`` (the window's length), ``busy_us`` (the union of
    the device's kernel, copy and set intervals inside it), ``busy_share``
    (their ratio), ``first_device_us`` (from the window's start to the
    first device activity; None if there was none) and ``kernels``:
    ``{base name: [launches, device us, us from the window's start to the
    first launch's start]}``, by device time, largest first.
    """
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    # the host's span (a CUDA trace also has the annotation's device span)
    windows = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
               and e.get("cat") == "user_annotation"]
    if len(windows) != 1:
        raise ValueError(f"{path}: {len(windows)} {WINDOW} spans, expected 1")
    t0 = float(windows[0]["ts"])
    t1 = t0 + float(windows[0]["dur"])
    spans, kernels = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        spans.append((a, b))
        if e["cat"] == "kernel":
            entry = kernels.setdefault(kernel_base_name(e["name"]), [0, 0.0, a - t0])
            entry[0] += 1
            entry[1] += b - a
            entry[2] = min(entry[2], a - t0)
    busy, end = 0.0, t0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    window = t1 - t0
    return {
        "window_us": window,
        "busy_us": busy,
        "busy_share": busy / window if window > 0 else 0.0,
        "first_device_us": min(a for a, _ in spans) - t0 if spans else None,
        "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1][1])),
    }
