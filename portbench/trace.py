"""Reading a ``torch.profiler`` Chrome trace: device work inside the
benchmark's Compute phases, its union, the idle gaps between it, what the
host was doing in each, and the program span each lies under.

The interval union and the idle put down to program spans are the
arithmetic of the program's own trace summary
(``utils/profiling.trace_summary``, ``idle_by_span``), copied here so that
the yardstick does not move with the program.
"""

from __future__ import annotations

import collections
import json

# the user annotation the harness puts around each traced Compute phase
PHASE = "portbench.compute"
# event categories of device work in a Chrome trace of torch.profiler
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host event categories that say what the host was doing
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
# the prefix of the program's spans, which a traced run's recorder also
# annotates on the profiler's timeline
PROGRAM = "lbm."


def union_length(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(spans, t0: float, t1: float) -> list[tuple[float, float]]:
    """The sub-intervals of [t0, t1] that no interval of ``spans`` covers."""
    out, cursor = [], t0
    for a, b in sorted(spans):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < t1:
        out.append((cursor, t1))
    return out


def _clip(a: float, b: float, t0: float, t1: float):
    a, b = max(a, t0), min(b, t1)
    return (a, b) if b > a else None


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


def _is_program(e: dict) -> bool:
    return e.get("cat") == "user_annotation" and e.get("name", "").startswith(PROGRAM)


def summarize(events: list[dict]) -> dict:
    """The device's work inside the trace's ``PHASE`` spans (times in
    seconds): ``window_s`` (the phases' length), ``busy_s`` (the union of
    device intervals in them), ``kernel_s`` (the union of kernel
    intervals), ``device_ops`` ({event name: seconds}), ``idle`` ({what
    the host was doing, the program's spans left aside: seconds of device
    idle}) and ``idle_by_span`` ({innermost program span over the idle:
    seconds}, with 0 for every program span in a phase that has none)."""
    phases = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
              if e.get("ph") == "X" and e.get("name") == PHASE
              and e.get("cat") == "user_annotation"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("name") != PHASE and not _is_program(e)]
    program = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
               if e.get("ph") == "X" and _is_program(e)]
    window = busy = kernel = 0.0
    ops: dict[str, float] = collections.Counter()
    holes: list[tuple[float, float]] = []
    by_span: dict[str, float] = collections.Counter()
    for t0, t1 in sorted(phases):
        spans, kspans = [], []
        for e in device:
            c = _clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]), t0, t1)
            if c is None:
                continue
            spans.append(c)
            if e["cat"] == "kernel":
                kspans.append(c)
            ops[e["name"]] += c[1] - c[0]
        window += t1 - t0
        busy += union_length(spans)
        kernel += union_length(kspans)
        mine = gaps(spans, t0, t1)
        holes += mine
        inside = [s for s in program if s[0] < t1 and s[1] > t0]
        by_span.update(dict.fromkeys({s[2] for s in inside}, 0.0))
        by_span.update(idle_by_span(mine, inside))
    idle: dict[str, float] = collections.Counter()
    for g, name in zip(holes, _doing(host, holes)):
        idle[name] += g[1] - g[0]
    us = 1e-6
    return {
        "phases": len(phases),
        "window_s": window * us,
        "busy_s": busy * us,
        "kernel_s": kernel * us,
        "device_ops": {k: v * us for k, v in ops.items()},
        "idle": {k: v * us for k, v in idle.items()},
        "idle_by_span": {k: v * us for k, v in by_span.items()},
    }


def _doing(host: list[dict], holes: list[tuple[float, float]]) -> list[str]:
    """For each of the time-ordered ``holes``, the host event that covers
    most of it, the innermost (shortest) of equals; ``host: untraced``
    where none does (Python between calls).  One sweep over the events."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in host)
    names, active, i = [], [], 0
    for g0, g1 in holes:
        while i < len(spans) and spans[i][0] < g1:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] > g0]
        best, best_key = "host: untraced", (0.0, 0.0)
        for a, b, name in active:
            cover = min(b, g1) - max(a, g0)
            if cover > 0 and (cover, a - b) > best_key:
                best, best_key = name, (cover, a - b)
        names.append(best)
    return names


def read(path) -> dict:
    """:func:`summarize` of a Chrome trace file."""
    with open(path) as fh:
        return summarize(json.load(fh)["traceEvents"])


def merge(summaries: list[dict]) -> dict:
    """Several traces' summaries as one."""
    out = {"phases": 0, "window_s": 0.0, "busy_s": 0.0, "kernel_s": 0.0,
           "device_ops": collections.Counter(), "idle": collections.Counter(),
           "idle_by_span": collections.Counter()}
    for s in summaries:
        for k in ("phases", "window_s", "busy_s", "kernel_s"):
            out[k] += s[k]
        for k in ("device_ops", "idle", "idle_by_span"):
            out[k].update(s[k])
    return out


def top(d: dict, n: int = 10) -> list[list]:
    """The ``n`` largest entries of ``d`` as [[name, value], ...]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
