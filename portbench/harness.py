"""One benchmark run of a cell: set-up, the measured window of whole deck
runs, the traced Compute phases, and the comparison with the reference.

A *solve* is one whole deck run through the program's main path, in the
order its command line takes it (``cli._main``):

1. ``Simulation.from_decks`` on the cell's frozen deck copy, then
   ``warmup`` (the CLI's Init);
2. ``run(fetch=False)``, which ends in the device synchronise (Compute);
3. ``collate()`` and ``.reynolds`` (Collate);
4. ``write``: ``final_state.dat`` and ``av_vels.dat`` through the
   program's writer and codec, into the null device.

Set-up runs one warm solve; the window then runs solves back to back and
ends at the first solve boundary past ``seconds``.  A traced run records
the program's spans (``utils/profiling.recording``) over the warm solve
and the window, each solve under a root span ``SOLVE``; an untraced run
never enters the recorder.  Once the window is
closed, the last solve's result is written again through the same writer,
into real files, which are judged: the disk's cost stays out of every
timed solve alike.  The seed's
initial state (``inputs.py``) is made on the device once, and each solve's
``initial_state`` hands the program a device copy of it.

Everything that belongs to one configuration, traffic mix, cell or metric
is found by name: ``configs/<file>`` (``BENCHMARK.json``), ``traffic/<traffic>.json``,
``workloads/<cell>.json`` and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import importlib.util
import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from advanced_hpc_lbm_tpu_torch.models.d2q9_bgk import Simulation
from advanced_hpc_lbm_tpu_torch.utils import profiling
from portbench import inputs, judge, spans, trace
from portbench.reference import lbm

BENCH = Path(__file__).resolve().parent

# what a traffic mix or a cell may set, and its value where neither does
DEFAULTS = {
    "backend": "auto",        # the program's --backend
    "profiled_solves": 2,     # solves of a traced run whose Compute is profiled
}

# the program's launch counters: (label, module under ops/, attribute)
COUNTERS = (("step", "step_kernel", "launches"), ("resident", "resident", "launches"),
            ("resident_banded", "resident", "banded_launches"),
            ("kstep", "kstep_kernel", "launches"), ("stream", "stream_kernel", "launches"))


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its files read."""

    name: str
    root: Path  # the benchmark's folder it was found in
    plan: dict
    limits: dict
    deck: lbm.Deck
    params_path: Path
    obstacles_path: Path
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: Path = BENCH) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` (beside ``root``)."""
    with open(root.parent / "BENCHMARK.json") as fh:
        spec = json.load(fh)
    try:
        entry = next(w for w in spec["workloads"] if w["name"] == name)
    except StopIteration:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json") from None
    cfg_file = root.parent / next(c["file"] for c in spec["configs"]
                                  if c["name"] == entry["config"])
    config = _json(cfg_file)
    for copy, digest in config.get("sha256", {}).items():
        if hashlib.sha256((cfg_file.parent / copy).read_bytes()).hexdigest() != digest:
            raise ValueError(f"{cfg_file.parent / copy}: not the deck its sha256 names")
    traffic = _json(root / "traffic" / f"{entry['traffic']}.json")
    spec_cell = _json(root / "workloads" / f"{name}.json")
    plan = {**DEFAULTS, **traffic.get("parameters", {}), **spec_cell.get("parameters", {})}
    unknown = set(plan) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"{name}: unknown traffic parameters {sorted(unknown)}")
    params_path = cfg_file.parent / config["params_file"]
    obstacles_path = cfg_file.parent / config["obstacles_file"]
    deck = lbm.read_deck(params_path, obstacles_path)

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name=name, root=root, plan=plan, limits=spec_cell["limits"],
                deck=deck, params_path=params_path, obstacles_path=obstacles_path,
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=[m for m in spec["per_layer"] if mine(m)])


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def reader(name: str, root: Path = BENCH):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Solve:
    """One solve's spans (host seconds) and outputs, on the host."""

    init: float
    compute: float
    collate: float
    write: float
    wall: float
    f: np.ndarray
    av: np.ndarray
    reynolds: float


@dataclasses.dataclass
class Run:
    """What the metric readers read: with ``spans`` the program's span
    recorder of a traced run (``spans.py`` reads it), None untraced."""

    cell: Cell
    device_name: str
    setup_s: float
    window_s: float
    solves: list[Solve]
    trace: dict | None
    spans: profiling.Recorder | None = None


class Seeded(Simulation):
    """The program's Simulation, started from the seed's initial state: a
    device copy of ``f0`` each time the run asks for its initial state."""

    f0: torch.Tensor | None = None

    def initial_state(self) -> torch.Tensor:
        return self.f0.clone()


def launch_counts() -> dict:
    """The program's launch counters as they stand."""
    return {label: getattr(importlib.import_module(f"advanced_hpc_lbm_tpu_torch.ops.{module}"),
                           attr) for label, module, attr in COUNTERS}


class Solver:
    """Runs solves of one cell from one initial state."""

    def __init__(self, cell: Cell, f0: torch.Tensor, device: torch.device, tmp: str) -> None:
        self.cell = cell
        self.f0 = f0
        self.device = device
        self.trace_dir = tmp  # where profiled solves' traces go
        self.traces: list[str] = []
        self.result = None  # the last solve's SimulationResult

    def solve(self, profile: bool = False) -> Solve:
        """One solve, its files formatted into the null device."""
        t0 = time.perf_counter()
        sim = Seeded.from_decks(self.cell.params_path, self.cell.obstacles_path,
                                backend=self.cell.plan["backend"], device=self.device)
        sim.f0 = self.f0
        sim.warmup()
        t1 = time.perf_counter()
        with self._profiler(profile) as prof:
            c0 = time.perf_counter()
            with _phase(profile):
                result = sim.run(fetch=False)
            c1 = time.perf_counter()
        if profile:  # outside every span: the trace leaves the process now
            path = os.path.join(self.trace_dir, f"compute{len(self.traces)}.json")
            prof.export_chrome_trace(path)
            self.traces.append(path)
        t2 = time.perf_counter()
        result.collate()
        re = result.reynolds
        t3 = time.perf_counter()
        result.write(".", final_state_name=os.devnull, av_vels_name=os.devnull)
        t4 = time.perf_counter()
        self.result = result
        return Solve(init=t1 - t0, compute=c1 - c0, collate=t3 - t2, write=t4 - t3,
                     wall=t4 - t0, f=result.f_final, av=result.av_vels, reynolds=re)

    def write_files(self, out_dir: str) -> tuple[str, str]:
        """The last solve's ``final_state.dat`` and ``av_vels.dat``, written
        into ``out_dir`` through the program's writer."""
        os.makedirs(out_dir, exist_ok=True)
        return self.result.write(out_dir)

    def _profiler(self, on: bool):
        if not on:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def trace_summary(self) -> dict | None:
        """The profiled Compute phases, read back from their Chrome traces,
        which are deleted."""
        if not self.traces:
            return None
        parts = []
        for path in self.traces:
            parts.append(trace.read(path))
            os.remove(path)
        return trace.merge(parts)


def _phase(on: bool):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(trace.PHASE)


def run_cell(cell: Cell, *, seed: int, seconds: float, traced: bool, device,
             t_process: float, log=print) -> dict:
    """One run of ``cell``: the result line's object, ``checks`` last."""
    device = torch.device(device)
    f0 = inputs.initial_state(cell.deck, seed, device)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        solver = Solver(cell, f0, device, tmp)
        with profiling.recording() if traced else contextlib.nullcontext() as rec:
            before = launch_counts()
            _solve(solver, window=False, profiled=False)  # the warm solve
            after = launch_counts()
            log(f"launches per solve: { {k: after[k] - before[k] for k in after} }")
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t_window = time.perf_counter()
            solves = _window(solver, t_window + seconds, profiled=cell.plan["profiled_solves"]
                             if traced and device.type == "cuda" else 0)
            window_s = time.perf_counter() - t_window
        return _measure(cell, solver, solves, seed=seed, setup_s=t_window - t_process,
                        window_s=window_s, traced=traced, recorder=rec, tmp=tmp, log=log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _solve(solver: Solver, *, window: bool, profiled: bool) -> Solve:
    """One solve under its root span (a no-op where nothing records)."""
    with profiling.span(spans.SOLVE, window=window, profiled=profiled):
        return solver.solve(profile=profiled)


def _window(solver: Solver, deadline: float, *, profiled: int) -> list[Solve]:
    """Solves back to back up to the first solve boundary past
    ``deadline``; the first ``profiled`` have their Compute profiled."""
    solves = []
    while not solves or time.perf_counter() < deadline:
        solves.append(_solve(solver, window=True, profiled=len(solves) < profiled))
    return solves


def _measure(cell, solver, solves, *, seed, setup_s, window_s, traced, recorder, tmp,
             log) -> dict:
    device = solver.device
    files = solver.write_files(os.path.join(tmp, "judged"))  # after the window
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary = solver.trace_summary()
    log(f"window: {len(solves)} solves in {window_s:.6f} s; setup {setup_s:.6f} s; "
        f"peak device memory {peak} B")
    log("median seconds a solve: " + ", ".join(
        f"{k} {np.median([getattr(s, k) for s in solves]):.6f}"
        for k in ("init", "compute", "collate", "write", "wall")))

    # the program's state goes before the reference runs on the device
    f0 = solver.f0.cpu()
    solver.f0 = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    f_ref, av_ref = lbm.Reference(cell.deck, device).run(f0.to(device))
    expected = judge.Expected(cell.deck, f_ref.cpu().numpy(), av_ref.cpu().numpy())
    del f_ref, av_ref
    rng = np.random.default_rng(seed % 2**64)
    last = solves[-1]
    # the judged files, and every solve's answer: most are the last one's
    # bit for bit, and share its reading
    last_numbers = judge.worst([expected.file_numbers(*files, last.reynolds, rng),
                                expected.state_numbers(last.f, last.av, last.reynolds)])
    readings, failed = [], 0
    for s in solves:
        if s is last or (np.array_equal(s.f, last.f) and np.array_equal(s.av, last.av)
                         and s.reynolds == last.reynolds):
            numbers = last_numbers
        else:
            numbers = expected.state_numbers(s.f, s.av, s.reynolds)
        readings.append(numbers)
        failed += not judge.verdict(numbers, cell.limits)
    numbers = judge.worst(readings)
    log(f"judged {len(solves)} solves against the reference in "
        f"{time.perf_counter() - t_ref:.3f} s")

    run = Run(cell=cell, device_name=_device_name(device), setup_s=setup_s,
              window_s=window_s, solves=solves, trace=summary, spans=recorder)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"], cell.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.device_name, "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": failed == 0, "attempted": len(solves), "failed": failed,
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": trace.top(summary["device_ops"]),
                            "idle_gaps": trace.top(summary["idle"])}
    out["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in cell.limits}
    return out


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
