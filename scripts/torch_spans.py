#!/usr/bin/env python
"""Per-layer readings of a benchmark cell from the program's own spans
(``utils/profiling.py``) and the codec's counts.

  python scripts/torch_spans.py ref1024.deck --cost 4

Runs the cell's solves through the benchmark's own harness
(``portbench/harness.py``: its ``Solver``, the seed's initial state, its
launch counters) with the program's spans recorded: one warm solve (the
libraries' build and load), ``--solves`` read solves, then ``--profiled``
solves whose Compute phase is traced.  Prints one JSON object as its last
line: the readings (means per read solve; device shares of the traced
Compute phases), each memory query's self time by the span it was asked
in, and the checks that tie the readings together (non-zero exit where one
fails).  With ``--cost PAIRS`` it then times 8 s windows of solves with
the recorder on and off in turns (on, off, off, on, ...): each window's
``solve_s`` and ``compute_glups``, with medians and spreads.

It stands in for the benchmark's per-layer readers of these spans until
``portbench/`` records them itself (PERF.md, Open questions); those
readers import ``profiling.idle_by_span`` and ``Recorder.self_seconds``
as this script does, and the script goes when they land.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel  # noqa: E402
from advanced_hpc_lbm_tpu_torch.utils import io, native, profiling  # noqa: E402
from portbench import harness, inputs, trace  # noqa: E402
from portbench.run import card_report  # noqa: E402

SOLVE = "torch_spans.solve"  # the root span of each solve
SEED = 2**31 + 19
LIBRARIES = ("lbm.ops.library", "lbm.io.codec_library", "lbm.ops.prepare")
WINDOW_S = 8.0  # a --cost window


def launches() -> int:
    return sum(harness.launch_counts().values())


def record(cell: harness.Cell, device, solves: int, profiled: int, tmp: str):
    """The recording of a warm solve, ``solves`` read solves and
    ``profiled`` traced ones; the solver; the launches a read solve
    counted."""
    device = torch.device(device)
    solver = harness.Solver(cell, inputs.initial_state(cell.deck, SEED, device), device, tmp)
    with profiling.recording() as rec:
        with profiling.span(SOLVE, window=False, profiled=False):
            solver.solve()
        before = launches()
        for _ in range(solves):
            with profiling.span(SOLVE, window=True, profiled=False):
                solver.solve()
        counted = (launches() - before) / solves
        for _ in range(profiled):
            with profiling.span(SOLVE, window=True, profiled=True):
                solver.solve(profile=True)
    return rec, solver, counted


def idle_by_span(events: list[dict]) -> dict[str, float]:
    """Seconds of device idle inside the trace's Compute phases, each put
    down to the innermost program span over it (``none`` where none is)."""
    def x(cats):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
                for e in events if e.get("ph") == "X" and e.get("cat") in cats]
    device = [(a, b) for a, b, _ in x(trace.DEVICE_CATS)]
    notes = x(("user_annotation",))
    program = [s for s in notes if s[2].startswith(profiling.PREFIX)]
    out: dict[str, float] = collections.Counter()
    for t0, t1, _ in (s for s in notes if s[2] == trace.PHASE):
        out.update(profiling.idle_by_span(trace.gaps(device, t0, t1), program))
    return {k: v * 1e-6 for k, v in out.items()}


def bulk_share(loops) -> float | None:
    """Of the K-step kernel's tiles in the loops, the share its bulk
    tensor copy fed (None where no loop ran the kernel)."""
    bulk = sum(s.attrs.get("tiles_bulk", 0) for s in loops)
    total = bulk + sum(s.attrs.get("tiles_wrap", 0) for s in loops)
    return bulk / total if total else None


def readings(rec: profiling.Recorder, traces: list[str], deck) -> dict:
    """The per-layer readings of a recording: host spans as means per read
    solve, device shares over the traced Compute phases."""
    by_root = collections.defaultdict(list)
    for s in rec.spans:
        by_root[s.root].append(s)
    roots = rec.named(SOLVE)
    read = [r for r in roots if r.attrs["window"] and not r.attrs["profiled"]]
    n = len(read)

    def spans(name):
        return [s for r in read for s in by_root[r.id] if s.name == name]

    def per_solve(name, value=lambda s: s.seconds):
        return sum(value(s) for s in spans(name)) / n

    def total(name, key, scale=1.0):
        return sum(s.attrs.get(key, 0) for s in spans(name)) * scale / n

    def outermost(among, names):
        ids = {s.id for s in among if s.name in names}
        return [s for s in among if s.id in ids and s.parent not in ids]

    codec = spans("lbm.io.final_state")
    setup = outermost([s for r in roots if not r.attrs["window"] for s in by_root[r.id]],
                      LIBRARIES)
    out = {
        "solves": n,
        "solve_s": sum(r.seconds for r in read) / n,
        "model.from_decks_s": per_solve("lbm.model.from_decks"),
        "model.warmup_s": per_solve("lbm.model.warmup"),
        "compute_s": per_solve("lbm.model.run"),
        "model.backend": sorted({s.attrs["backend"] for s in spans("lbm.model.run")}),
        "model.fit_check_s": per_solve("lbm.model.fit_check", rec.self_seconds),
        "model.fit_check_queries": len(spans("lbm.model.fit_check")) / n,
        "model.to_host_s": per_solve("lbm.model.to_host"),
        "model.to_host_bytes": total("lbm.model.to_host", "bytes"),
        "model.reynolds_s": per_solve("lbm.model.reynolds"),
        # what the benchmark's model.collate_s times: collate() and .reynolds
        "model.collate_s": per_solve("lbm.model.collate") + per_solve("lbm.model.reynolds"),
        "io.planes_s": per_solve("lbm.io.planes"),
        "io.final_state_s": per_solve("lbm.io.final_state"),
        "io.av_vels_s": per_solve("lbm.io.av_vels"),
        "io.write_s": per_solve("lbm.io.write"),
        "io.codec_parallelism": (sum(s.attrs.get("format_ns", 0) for s in codec)
                                 / sum(s.end_ns - s.start_ns for s in codec)) if codec else None,
        "io.codec_blocks": total("lbm.io.final_state", "blocks"),
        "io.codec_threads_used": total("lbm.io.final_state", "threads"),
        "io.codec_wait_s": total("lbm.io.final_state", "wait_ns", 1e-9),
        "io.codec_write_s": total("lbm.io.final_state", "write_ns", 1e-9),
        "io.final_state_bytes": total("lbm.io.final_state", "bytes"),
        "io.av_vels_format_s": total("lbm.io.av_vels", "format_ns", 1e-9),
        "io.av_vels_write_s": total("lbm.io.av_vels", "write_ns", 1e-9),
        "io.av_vels_bytes": total("lbm.io.av_vels", "bytes"),
        "ops.launches": per_solve("lbm.ops.loop", lambda s: s.attrs["launches"]),
        "ops.tiles_bulk_share": bulk_share(spans("lbm.ops.loop")),
        # the resident path's loops: (form, bands, nx, ny, depth) of each
        # grid it ran, and its exchanges with the neighbours a solve
        "ops.resident_grids": sorted({(s.attrs["form"], s.attrs["bands"], s.attrs["nx"],
                                       s.attrs["ny"], s.attrs.get("depth"))
                                      for s in spans("lbm.ops.loop") if "form" in s.attrs}),
        "ops.resident_rounds": total("lbm.ops.loop", "rounds"),
        "io.quirk_clipped": total("lbm.io.final_state", "quirk_clipped"),
        "setup.libraries_s": sum(s.seconds for s in setup),
        "setup.libraries": {s.name: [s.seconds, s.attrs] for s in setup},
        "cells": deck.nx * deck.ny,
        "grid": [deck.ny, deck.nx],
    }
    k = kstep_kernel.best_k(deck.ny, deck.nx)
    out["ops.tiles_bulk_rule"] = (kstep_kernel.bulk_tiles(deck.ny, deck.nx, k)
                                  / kstep_kernel.num_tiles(deck.ny, deck.nx))
    window_s = busy_s = 0.0
    idle: dict[str, float] = collections.Counter()
    for path in traces:
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        s = trace.summarize(events)
        window_s += s["window_s"]
        busy_s += s["busy_s"]
        idle.update(idle_by_span(events))
    if busy_s > 0:
        out["device.idle_share"] = 100.0 * (1.0 - busy_s / window_s)
        out["device.loop_idle_share"] = 100.0 * idle.get("lbm.ops.loop", 0.0) / window_s
        out["device.gate_idle_share"] = 100.0 * idle.get("lbm.model.fit_check", 0.0) / window_s
    out["idle_by_span_s"] = dict(sorted(idle.items(), key=lambda kv: -kv[1]))
    out["traced_compute_s"] = window_s
    return out


def queries(rec: profiling.Recorder) -> dict[str, list[float]]:
    """Each read solve's memory queries' self seconds, in order, by the
    span they were asked in."""
    read = {r.id for r in rec.named(SOLVE) if r.attrs["window"] and not r.attrs["profiled"]}
    out = collections.defaultdict(list)
    for s in rec.named("lbm.model.fit_check"):
        if s.root in read:
            out[rec.spans[s.parent].name].append(rec.self_seconds(s))
    return dict(out)


def checks(r: dict, counted: float) -> dict:
    """The relations the readings must keep, each True or False."""
    out = {
        "launches_equal_the_counters": r["ops.launches"] == counted,
        "io_parts_within_write": r["io.planes_s"] + r["io.final_state_s"] + r["io.av_vels_s"]
        <= r["io.write_s"],
        "to_host_and_reynolds_within_collate": r["model.to_host_s"] + r["model.reynolds_s"]
        <= r["model.collate_s"],
    }
    if r["io.final_state_bytes"]:
        out["quirk_clipped_is_the_rule"] = r["io.quirk_clipped"] == io.quirk_clipped_lines(
            *r["grid"])
    if r["ops.tiles_bulk_share"] is not None:
        out["tiles_bulk_share_is_the_rule"] = r["ops.tiles_bulk_share"] == r["ops.tiles_bulk_rule"]
    if r["io.codec_parallelism"] is not None:
        out["codec_parallelism_within_threads"] = (r["io.codec_parallelism"]
                                                   <= native.default_threads())
        out["codec_blocks_of_64ki_lines"] = r["io.codec_blocks"] == -(-r["cells"] // 65536)
    if "device.idle_share" in r:
        out["loop_and_gate_within_idle"] = (r["device.loop_idle_share"]
                                            + r["device.gate_idle_share"]
                                            <= r["device.idle_share"])
    return out


def spread(values: list[float]) -> float | None:
    """(Q3 - Q1) / median, by ``statistics.quantiles(n=4)``."""
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def cost(solver: harness.Solver, pairs: int, seconds: float = WINDOW_S) -> dict:
    """Windows of solves, recorder on and off in turns."""
    deck = solver.cell.deck
    rows = []
    for i in range(pairs):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            done = []
            with profiling.recording() if on else contextlib.nullcontext():
                t0 = time.perf_counter()
                while not done or time.perf_counter() - t0 < seconds:
                    done.append(solver.solve().compute)
                wall = time.perf_counter() - t0
            rows.append({"recorder": "on" if on else "off", "solves": len(done),
                         "solve_s": wall / len(done),
                         "compute_glups": deck.nx * deck.ny * deck.max_iters * len(done)
                         / sum(done) * 1e-9})
    out = {"windows": rows}
    for side in ("on", "off"):
        for metric in ("solve_s", "compute_glups"):
            values = [w[metric] for w in rows if w["recorder"] == side]
            out[f"{metric}.{side}"] = {"median": statistics.median(values),
                                       "spread": spread(values)}
    return out


def measure(cell: harness.Cell, device, *, solves: int, profiled: int, pairs: int) -> dict:
    """The JSON object the script prints."""
    with tempfile.TemporaryDirectory(prefix="torch-spans-") as tmp:
        rec, solver, counted = record(cell, device, solves, profiled, tmp)
        out = {"cell": cell.name, "codec_threads": native.default_threads(),
               "readings": readings(rec, solver.traces, cell.deck),
               "fit_check_queries_s": queries(rec)}
        out["readings"]["ops.launches_counted"] = counted
        out["checks"] = checks(out["readings"], counted)
        if pairs:
            out["cost"] = cost(solver, pairs)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("workload", help="a cell of BENCHMARK.json")
    p.add_argument("--solves", type=int, default=6, help="read solves (at least 1)")
    p.add_argument("--profiled", type=int, default=2, help="solves whose Compute is traced")
    p.add_argument("--cost", type=int, default=0, metavar="PAIRS",
                   help="pairs of recorder-on and recorder-off windows to time")
    args = p.parse_args(argv)
    if args.solves < 1:
        p.error("--solves must be at least 1")
    if not torch.cuda.is_available():
        print("torch_spans: no CUDA card here", file=sys.stderr)
        return 2
    out = measure(harness.load_cell(args.workload), "cuda:0", solves=args.solves,
                  profiled=args.profiled, pairs=args.cost)
    out["card"] = card_report()
    print(json.dumps(out), flush=True)
    return 0 if all(out["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
