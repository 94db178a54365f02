"""Performance instrumentation: the program's spans and a profiler trace.

* ``span`` / ``recording``: named phases of a run, recorded in memory
  while a :func:`recording` is active (the CLI's ``--profile``, a
  benchmark's traced run) and free otherwise: ``span`` then returns one
  shared no-op.  Every span of the program is named ``lbm.<layer>.<what>``;
  while a ``torch.profiler`` profile is active a recorded span is also a
  ``record_function`` annotation of the same name, so it shows on the
  profiler's timeline beside the kernels;
* ``trace``: a ``torch.profiler`` trace of the enclosed block, written as
  a Chrome trace (chrome://tracing, Perfetto, TensorBoard), the CLI's
  ``--profile``, with the block's spans recorded; ``trace_summary`` reads
  one back: the device's busy share of the traced window, the kernels by
  device time and the device's idle time by program span.

The JAX module's throughput, roofline and TPU memory-rate helpers have no
counterpart here: the benchmark (``portbench/``) counts a run's work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import socket
import sys
import time

# the user annotation around a traced block: its span is the trace's window
WINDOW = "lbm_trace_window"
# event categories of device work in a Chrome trace of torch.profiler
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the prefix of every span of the program
PREFIX = "lbm."


@dataclasses.dataclass
class Span:
    """One recorded span: ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns()``, the ids of its parent (None for a root)
    and of its root, and its attributes (counts)."""

    name: str
    id: int
    parent: int | None
    root: int
    start_ns: int
    end_ns: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Recorder:
    """The spans of one recording, in the order they started, each with
    its end once it has ended.  Spans nest on the thread that opens them."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self._open: list[Span] = []

    def self_seconds(self, span: Span) -> float:
        """``span``'s length less the part of it its children cover."""
        kids = sorted((max(c.start_ns, span.start_ns), min(c.end_ns, span.end_ns))
                      for c in self.spans if c.parent == span.id)
        covered, end = 0, span.start_ns
        for a, b in kids:
            if b > end:
                covered += b - max(a, end)
                end = b
        return (span.end_ns - span.start_ns - covered) * 1e-9

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]


class _Noop:
    """The span while nothing records: enters, sets and exits for free."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _Noop()
_recorder: Recorder | None = None


def _profiler_active() -> bool:
    """Whether a ``torch.profiler`` profile is active: never where torch
    was not imported, so the recorder does not import it."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd.profiler._is_profiler_enabled


class _Active:
    """A span being recorded into ``recorder``."""

    __slots__ = ("recorder", "span", "annotation")

    def __init__(self, recorder: Recorder, name: str, attrs: dict) -> None:
        self.recorder = recorder
        self.span = Span(name=name, id=0, parent=None, root=0, start_ns=0, attrs=attrs)
        self.annotation = None

    def __enter__(self):
        rec, sp = self.recorder, self.span
        sp.id = len(rec.spans)
        if rec._open:
            sp.parent, sp.root = rec._open[-1].id, rec._open[-1].root
        else:
            sp.root = sp.id
        rec.spans.append(sp)
        rec._open.append(sp)
        if _profiler_active():
            self.annotation = sys.modules["torch"].autograd.profiler.record_function(sp.name)
            self.annotation.__enter__()
        sp.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.span.end_ns = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.recorder._open.pop()
        return False

    def set(self, **attrs) -> None:
        """Add or replace attributes of the span."""
        self.span.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager that records the enclosed block as a span named
    ``name`` with ``attrs`` while a :func:`recording` is active; what it
    yields takes more attributes with ``.set(**attrs)``.  With no recording
    active it is one shared no-op."""
    if _recorder is None:
        return _NOOP
    return _Active(_recorder, name, attrs)


@contextlib.contextmanager
def recording():
    """Record every :func:`span` entered inside the block; yields the
    :class:`Recorder`, whose ``spans`` are complete when the block ends.
    Nothing is written.  A recording inside another takes the spans of its
    block from it."""
    global _recorder
    outer, _recorder = _recorder, Recorder()
    try:
        yield _recorder
    finally:
        _recorder = outer


@dataclasses.dataclass
class Trace:
    """What :func:`trace` yields: ``path``, the Chrome trace's file, is set
    when the block has ended."""

    path: str | None = None


@contextlib.contextmanager
def trace(trace_dir: str | os.PathLike):
    """``torch.profiler`` trace of the enclosed block: host activity, the
    program's spans (annotated on the timeline, and recorded into the
    active recording, or one of the block's own), and the device's activity when a CUDA
    card is present, inside one ``WINDOW`` annotation.  On exit the trace
    goes to ``trace_dir/<host>.<pid>.<ns>.pt.trace.json`` (the name
    TensorBoard's profiler plugin reads)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Trace()
    active = contextlib.nullcontext() if _recorder is not None else recording()
    with profile(activities=activities) as prof:
        with record_function(WINDOW), active:
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


def idle_by_span(gaps: list[tuple[float, float]],
                 spans: list[tuple[float, float, str]]) -> dict[str, float]:
    """The length of ``gaps`` (device idle intervals) put down to
    ``spans`` (program spans, properly nested): each part of a gap to the
    innermost span over it, ``none`` where no span is."""
    out: dict[str, float] = {}
    spans = sorted(spans)
    for g0, g1 in gaps:
        over = [s for s in spans if s[0] < g1 and s[1] > g0]
        cuts = sorted({g0, g1, *(t for s in over for t in s[:2] if g0 < t < g1)})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            inner = [s for s in over if s[0] <= mid < s[1]]
            # nested spans: the innermost started last (the shortest of equals)
            name = max(inner, key=lambda s: (s[0], s[0] - s[1]))[2] if inner else "none"
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def trace_summary(path: str | os.PathLike) -> dict:
    """The device's work in a trace of :func:`trace`, within its window.

    Returns ``window_us`` (the window's length), ``busy_us`` (the union of
    the device's kernel, copy and set intervals inside it), ``busy_share``
    (their ratio), ``first_device_us`` (from the window's start to the
    first device activity; None if there was none), ``kernels``:
    ``{base name: [launches, device us, us from the window's start to the
    first launch's start]}``, by device time, largest first, and
    ``idle_by_span``: ``{program span: us}``, the window's device idle put
    down to the program's spans (:func:`idle_by_span`).
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
    spans, kernels, program = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX):
            program.append((a, b, e["name"]))
        if e.get("cat") not in _DEVICE_CATS:
            continue
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        spans.append((a, b))
        if e["cat"] == "kernel":
            entry = kernels.setdefault(kernel_base_name(e["name"]), [0, 0.0, a - t0])
            entry[0] += 1
            entry[1] += b - a
            entry[2] = min(entry[2], a - t0)
    busy, end, gaps = 0.0, t0, []
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if end < t1:
        gaps.append((end, t1))
    window = t1 - t0
    return {
        "window_us": window,
        "busy_us": busy,
        "busy_share": busy / window if window > 0 else 0.0,
        "first_device_us": min(a for a, _ in spans) - t0 if spans else None,
        "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1][1])),
        "idle_by_span": idle_by_span(gaps, program),
    }
