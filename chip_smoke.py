#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

It needs one CUDA card, nvcc (``/usr/local/cuda`` or on PATH) and nothing
else of the repository but ``advanced_hpc_lbm_tpu_torch/``, ``decks/`` and
``goldens/``; it imports no JAX.  Each case prints one line; the first failure exits
non-zero and prints no result:

  1. card    the card's name and power limit (nvidia-smi), torch and CUDA
  2. build   nvcc builds the kernel library from csrc/ (or finds it built)
             and every kernel is loaded onto the card (the ptxas report of
             each: registers, shared memory, spills; the persistent grids'
             blocks per SM)
  3. kernel  the step kernel against its plain PyTorch version on the card,
             from seeded states, at 1024x1024, 64x64, 100x130 and 17x23,
             1 and 50 steps, plus a forcing row that fails the guard
  3r. resident  the form each shape takes (the C rule against
             resident.banded_fits; the band's shared-memory bytes; ptxas's
             registers and spills of both forms; the cooperative form's C
             queries against its Python rules: its K, segments a band,
             grid, outbox and shared memory by shape, blocks per SM), then
             the resident kernel against the step kernel (0 differing
             values) and its plain version, 1024^2 to 17x23: 1 and 50 steps
             in one chunk, 17 steps in chunks of 6 with a guard-failing row,
             in both forms where both take the shape, the cooperative one
             at every built K on twelve shapes (one, two and three bands,
             one segment a band and several), its partials bitwise, also
             with fewer blocks than tiles; then its time per step beside
             the step kernel's run loop: banded and cooperative in turns at
             64^2 to 256^2, from 512^2 to 4096^2 the cooperative form at K =
             1..4 and pallask in turns, and both in turns on grids of fewer
             bands than SMs (256x512 to 672x1024, 8x4096)
  3k. kstep  the K-step kernel (every built K; at 4096^2 K = 2, 4, 8 and
             best_k, the K pallask runs there) against the step kernel (0
             differing values) and its plain version at 4096^2, 1024^2,
             256^2, 128x256, 64^2, 100x130 and 17x23, 1 pass and 3 passes
             (one launch that walks them on grids of whole tiles, up to 16
             tiles a pass per SM) with a guard-failing row, its C rules
             against their Python restatements on each
             (lbm_kstep_bulk_tiles against kstep_kernel.bulk_tiles, the
             teams a block, lbm_kstep_walks and lbm_kstep_item), and a
             recorded run's lbm.ops.loop span
             (launches, passes_per_launch, tiles_bulk, tiles_wrap) at
             1024^2; then its time per step for K = 2..6, 8 at 4096^2 down
             to 64^2, beside the step and resident kernels, and at best_k a
             step, a pass and the launches of a timed run beside the design
             before (KSTEP_BEFORE_US)
  3s. stream the stream kernel, in place and out of place, against the step
             kernel (0 differing values) and its plain version at 8192^2,
             4096^2, 1024^2, 256^2, 64^2 (the mini deck), 100x130 and
             17x23, 1 pass and 3 passes
             with a guard-failing row; +4 cells and a second forcing row
             against the plain version; then its time per step in place
             beside pallask (best_k) and step from 2048^2 to 16384^2
  4. mini    decks/mini_64x64 through the CLI with auto, pallas, resident,
             pallask, pallas2 and stream: exact launches per kernel, the
             ==done== block, and the golden at 1%
  5. full    bench.py's 1024x1024 deck (20 000 steps; a half-height wall
             at x = 341, so not the reference's 1024x1024 deck, which is
             5r's) through the CLI with auto and with resident: finite,
             positive av history, mass conserved, GLUPS of the run and of
             the kernel alone; final_state.dat written by the port's
             codec, timed
  5r. reference  the reference's own decks that the repo holds,
             decks/reference_256x256 (80 000 steps, auto: the banded
             resident kernel, 80 chunks), decks/reference_1024x1024
             (20 000 steps, auto: pallask K = 3 with a 2-step tail, and
             resident: the cooperative form) and decks/reference_128x256
             (40 000 steps, auto and resident: the banded form, 32 bands,
             fluid across the periodic y-wrap), through the CLI: exact
             launches, the spans' backend, resident form, bands, nx, ny
             and quirk_clipped, the ==done== block, the port's codec,
             auto's final_state.dat against goldens/<deck>.final_state.dat.xz
             at 1% where the repo has it (the reference checker's
             final-state half; resident's file equal to auto's by sha256),
             the Reynolds number within 1% of the reference README's (and
             at 128x256, which has no golden, within 0.3% of the float64
             reference's run from rest), mass drift <= 5e-9 a step (phase
             5's 1e-4 over 20 000 steps), auto's and resident's av within
             rtol 1e-5; a row in PARITY.md's layout
  5m. mid    a 512x512 deck (64 bands in 2 segments each) for 2000
             steps through the CLI with resident and with pallas: exact
             launches, av histories compared
  5b. cli big  a 4096x4096 deck for 2000 steps through the CLI with
             stream: the ==done== block, and final_state.dat written by
             the port's codec (csrc/fastio.c), timed at the default
             thread count and at 1 thread, the two files equal by sha256
  6. big     a 4096x4096 deck for 2000 steps through Simulation with
             pallask and with step: finite, mass conserved, the same state
             bit for bit, GLUPS of both
  6s. big stream  an 8192x8192 deck for 2000 steps through Simulation with
             stream and with pallask: the same state bit for bit
  7. capacity  a 36864x36864 grid (one state 48.9 GB) through
             Simulation(backend="auto") for 64 steps: auto picks stream, the
             gate refuses pallask before allocating, the in-place tier's
             peak device memory against tier_bytes, finite, mass conserved
  3l. local  the sharded path's kernels (the 1-D and 2-D local step, the
             K-step kernel's local form and the stream kernel on a ring or
             torus shard's window) against their plain versions on seeded
             shard windows: ly = 2 to 4096, 17x23 blocks, the forcing row
             on a halo row, an own row and twice in a K-step window (K =
             2..8), and every shard shape that phases 8, 12 and 14 give
             them on meshes of 2 and 4; a 12288x49152 shard of the 49152^2
             ring of 4 cards (windows of more than 2^32 values, made on
             the card) with the 1-D step, K = 4 and stream, the plain
             version by blocks of 1024 own rows; then their times at the
             main path's shard shapes
  3 retime  the K-step (both forms) and stream kernels' times beside
             PERF.md's from before their redesign, and the untouched step
             kernel's as the yardstick that the card matches
  8. sharded the main path on a device mesh: decks/mini_64x64 through the
             CLI with --backend sharded (a ring of the visible cards, one
             shard each: pallas, --ca-steps 4, --shard-kernel stream; exact
             launches, golden at 1%), the 1024x1024 deck through the CLI and
             the library with --backend sharded (the same state as auto's, 0
             differing values), and an 8192x8192 deck for 200 steps on 4
             shards of the card (a ring: pallas, pallas with ca_steps 4,
             stream; a 2x2 torus: pallas, stream) against single-device
             pallask (0 differing values, av within rtol 1e-5, exact
             launches, mass conserved); on N >= 2 cards also those
             configurations across the cards (a ring of N, and the same
             ring laid on cuda:0; the tori on 4 cards), and the mini and
             1024x1024 CLI runs held to the same mesh laid on cuda:0 alone
             (0 differing values in both output files), each timed beside
             that mesh and single-device pallask (or auto), with the
             exchange timed alone; then 4 shards of pallas, pallas K = 4
             and stream beside single-device pallask from 2048^2 to 8192^2.
             Every timed library run of phases 8, 12 and 14 follows an
             untimed run of 8 steps
  9. checkpoint  checkpointed runs against straight ones (0 differing
             values in the state, the same final_state.dat, av within
             rtol 1e-5, exact launches per segment): the 128x128 deck
             (40 000 steps) through the CLI on auto (banded resident) with
             --checkpoint-every 15000; the 1024x1024 deck on auto
             (pallask) with --checkpoint-every 7000 against phase 5's
             run, and killed at 10 000 then --resume'd to 20 000; a
             4096x4096 deck on stream in place with checkpoint_every=1000
             (peak device memory no higher than the straight run's, the
             snapshots' write time); 1024x1024 on 4 shards of the card
             (ring pallas and stream, 2x2 torus pallas), every 300 of
             1000 steps
  10. profile  --profile through the CLI on a 512x512 deck (pallask) and
             the 128x128 deck (auto): the trace file, the ==done== block
             and outputs as without it, each launched port kernel in the
             trace by name as often as its counter, the device's busy
             share of the Compute window and the top kernels; phase 7's
             run is traced too (its host set-up before the first kernel)
  11. batch  parallel/batch.batch_run of 4 decks of 1024x1024 for 200
             steps against 4 sequential fused runs (rtol 1e-6), split over
             [cuda:0, cuda:0] equal to the unsplit batch
  12. multiprocess  N processes in one launch of torch.distributed.run
             --standalone --nproc-per-node N (each process is this script
             with --rank-worker, which forms the group and runs each run
             through the CLI or the library): with one card N = 2, both on
             it over gloo (halos staged through pinned host buffers); with
             two or more N = the cards, each on its own over nccl (halos
             staged on the card; nccl on every rank is checked).  The
             sharded path with its mesh across the processes, each run
             held to the one-process run on the same mesh shape laid on
             cuda:0 with 0 differing values, exact launches per rank, one
             ==done== block and the outputs written once by rank 0:
             decks/mini_64x64 on a ring of N (pallas, --ca-steps 4, stream;
             golden at 1%), the 1024x1024 deck for 20 000 steps (pallas), a
             2 x N/2 torus of it for 1000 steps (pallas), an 8192x8192 ring
             on stream for 200 steps (digests of the own blocks), and a
             --multihost run of a 128x128 deck on auto (each process runs
             the deck); the chosen backend and each rank's device; times
             beside the one-process runs (and on several cards beside
             single-device pallask)
  13. overlap  the overlapped jnp ring on 4 shards of the card (1024x1024,
             1000 steps) bitwise equal to the default schedule, both
             timed; ops/mxu_collide.collide_flat on a seeded 1024x1024
             state against kernel_common.collide (rtol 2e-5 / atol 2e-7);
             utils/viz.main on phase 5's final_state.dat (a PGM of the
             grid's shape where matplotlib is missing)
  14. cards  what the sharded path does only across N >= 2 visible cards,
             beyond phases 8 and 12 (one line says it is skipped where one
             card is visible): the peer access of each pair of cards and
             `nvidia-smi topo -m`; on 4 cards the 1024x1024 deck for 1000
             steps on a 2x2 torus of the cards (pallas) through the CLI,
             held to the same mesh laid on cuda:0 alone with 0 differing
             values; scripts/torch_mp_exchange.py's split of a 1024^2
             exchange over nccl, N processes; on 4 cards a 49152x49152 grid
             (one state 87.0 GB, more than a card holds) for 64 steps on a
             ring of the 4 cards with pallas and with stream: the two
             runs' own blocks equal by a digest computed on each card, mass
             conserved, each card's peak memory, us per step and the
             exchange timed alone
  result     a JSON line of the kernels (the K-step kernel's main-path
             launches also by K, and its time at K = 2, the port of
             pallas_multi's _kernel2), then the device JSON line last

Each phase's wall time follows it on a ``[time]`` line.  Outside 5r, "the
NxN deck" is bench.py's geometry (``write_full_deck``: a closed box and a
half-height wall at x = nx // 3), not a reference deck.

Launch counts: every kernel module counts its launches; each run of
phases 4-14 (the main path; in phases 12 and 14 each process of a launch) sets the
counts to 0 just before it and reads them just after, and the kernels line
reports their sum.  Times in the
kernels line are per step; ``bound_ms`` is the least time of the same
work on an H100 (bytes of each input read once and each output written
once at 3.35 TB/s, or FLOPS_PER_CELL_STEP per cell and step at 67 TFLOP/s
float32, whichever is larger).
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import ctypes
import hashlib
import io
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
F_RTOL, F_ATOL, AV_RTOL = 1e-6, 1e-8, 1e-5  # kernel vs plain, same card
RUN_STEPS = 1000  # steps per timed run of the kernel
KSTEP_TIMED_STEPS = 480  # a multiple of every timed K
TIMED_K = (2, 3, 4, 5, 6, 8)
STREAM_TIMED_STEPS = 96  # a multiple of 8 and of every best_k
# The K-step kernel's us a step and a pass at best_k (K = 3) in the design
# before launches walked many passes (one launch a pass): chip_smoke 3k at
# 4096^2 and 1024^2
KSTEP_BEFORE_US = {4096: (200.02, 600.06), 1024: (15.96, 47.88)}

# The card's published peaks (H100 SXM data sheet) for the bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# float32 operations of one cell step (step_common.cuh:cell_step): 6
# forcing adds and 3 guard subtractions, rho (8 adds), 1/rho, u_x and u_y
# (12), u_sq (3), base (2), the rest speed (4), the two diagonal
# velocities (2), four pairs (4 x 13), sqrt
FLOPS_PER_CELL_STEP = 94
# bytes of one cell per launch of a kernel: 9 float32 read and written,
# the uint8 mask read
CELL_BYTES = 9 * 4 * 2 + 1
# µs per step in PERF.md's bring-up table before the K-step and stream
# kernels were redesigned (H100 80GB HBM3 at 700 W), to re-time beside: the
# untouched step kernel as the yardstick, the K-step kernel (both forms)
# and the stream kernel in place
BEFORE_US = {"step 1024^2": 32.37, "K=4 4096^2": 303.93, "K=4 1024^2": 23.20,
             "K=2 4096^2": 361.50, "local K=4 2048x8192": 309.43,
             "stream 4096^2": 476.92, "stream 8192^2": 1665.38,
             "stream 16384^2": 5945.41}

# launches of each kernel over the main-path runs of phases 4-14, and the
# K-step kernel's by K (in this process)
MAIN_LAUNCHES: collections.Counter = collections.Counter()
MAIN_K_LAUNCHES: collections.Counter = collections.Counter()


def kernel_counters() -> dict:
    """name -> (module, counter attribute) of every kernel's launch count;
    the stream module also counts the ghost snapshots before its passes,
    the local module its 1-D, 2-D and K-step forms apart."""
    from advanced_hpc_lbm_tpu_torch.ops import (
        kstep_kernel, local_kernel, resident, step_kernel, stream_kernel,
    )

    return {"step_kernel": (step_kernel, "launches"),
            "resident_kernel": (resident, "launches"),
            "resident_banded_kernel": (resident, "banded_launches"),
            "kstep_kernel": (kstep_kernel, "launches"),
            "stream_kernel": (stream_kernel, "launches"),
            "stream_snapshot": (stream_kernel, "snapshot_launches"),
            "local_kernel": (local_kernel, "launches"),
            "local2d_kernel": (local_kernel, "launches_2d"),
            "local_ca_kernel": (local_kernel, "ca_launches")}


@contextlib.contextmanager
def counted(into: dict):
    """Set every launch count to 0, run the body, then read the counts into
    ``into`` and add them to MAIN_LAUNCHES (the K-step kernel's by K to
    MAIN_K_LAUNCHES)."""
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel

    counters = kernel_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    kstep_kernel.launches_by_k.clear()
    yield
    into.update({name: getattr(mod, attr) for name, (mod, attr) in counters.items()})
    MAIN_LAUNCHES.update(into)
    MAIN_K_LAUNCHES.update(kstep_kernel.launches_by_k)


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---- 1. card -------------------------------------------------------------

def phase_card() -> str:
    if not torch.cuda.is_available():
        fail("[1 card] torch.cuda.is_available() is False: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"[1 card] nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    say(card)
    say(f"[1 card] {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda} | "
        f"{torch.cuda.device_count()} device(s)")
    return card


# ---- 2. build --------------------------------------------------------------

def ptxas_report(kernel: str | None = None) -> list[str]:
    """ptxas's lines (registers, shared memory; spills where not 0) of each
    kernel entry in the library's build log, or of the entries whose
    (mangled) name holds ``kernel``."""
    from advanced_hpc_lbm_tpu_torch.ops import _build

    log = _build.library_path().with_suffix(".log")
    report, name = [], "?"
    for ln in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif kernel is not None and kernel not in name:
            continue
        elif "registers" in ln:
            report.append(f"{name}: {ln.split(':', 1)[1].strip()}")
        elif "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill"):
            report.append(f"{name}: {ln.strip()}")
    return report


def phase_build() -> None:
    from advanced_hpc_lbm_tpu_torch.ops import _build, kstep_kernel, resident, step_kernel
    from advanced_hpc_lbm_tpu_torch.ops import local_kernel, stream_kernel

    t0 = time.perf_counter()
    path, cached = _build.build()
    step_kernel.prepare("cuda")
    resident.prepare("cuda")
    stream_kernel.prepare("cuda")
    local_kernel.prepare("cuda", tuple(kstep_kernel.K_RANGE))
    dt = time.perf_counter() - t0
    report = ptxas_report()
    for kernel in ("stream_kernel", "local_step_kernel", "kstep_kernel", "resident_kernel",
                   "resident_banded_kernel"):
        if not any(kernel in r for r in report):
            fail(f"[2 build] {kernel} is not in the ptxas report")
    report = " | ".join(report)
    say(f"[2 build] {path.name} {'from cache' if cached else 'built by nvcc'} "
        f"in {dt:.2f} s | ptxas: {report or 'no report'}")
    # the persistent grids' blocks per SM, from the occupancy query
    lib = _build.load()
    per_sm = {f"K={k}": (lib.lbm_kstep_blocks_per_sm(k, 0), lib.lbm_kstep_blocks_per_sm(k, 1))
              for k in kstep_kernel.K_RANGE}
    stream_per_sm = lib.lbm_stream_blocks_per_sm()
    if min(min(v) for v in per_sm.values()) < 1 or stream_per_sm < 1:
        fail(f"[2 build] a kernel fits no block on an SM: {per_sm}, stream {stream_per_sm}")
    say("[2 build] blocks per SM (global, local form): " + ", ".join(
        f"{k} {g}, {loc}" for k, (g, loc) in per_sm.items())
        + f"; stream {stream_per_sm} | {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")


# ---- 3. kernel vs plain ------------------------------------------------------

def seeded_case(ny: int, nx: int, seed: int, guard_fail: bool = False):
    """Equilibrium x uniform(0.8, 1.2) with a box, a block and random
    obstacles; ``guard_fail`` starves W on half of row ny-2."""
    from advanced_hpc_lbm_tpu_torch.ops import reference
    from advanced_hpc_lbm_tpu_torch.params import LBMParams

    params = LBMParams(nx=nx, ny=ny, max_iters=50, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[ny // 2: ny // 2 + 2, nx // 3: nx // 2] = True
    for _ in range(max(6, ny * nx // 2000)):
        mask[rng.randint(1, ny - 1), rng.randint(0, nx)] = True
    f0 = reference.initial_state(params, "cpu").numpy() * rng.uniform(
        0.8, 1.2, (9, ny, nx)).astype(np.float32)
    if guard_fail:
        f0[3, ny - 2, : nx // 2] = params.accel_w1 * np.float32(0.5)
    return params, mask, f0


def run_steps(stepper, f, mask, params, n):
    """n steps of ``stepper`` (step_kernel.step or .plain_step) from f;
    returns the final state and the per-step av."""
    from advanced_hpc_lbm_tpu_torch.ops import step_kernel

    _, ny, nx = f.shape
    bufs = [f.clone(), torch.empty_like(f)]
    part = torch.empty(n, step_kernel.num_partials(ny, nx), device=f.device)
    for t in range(n):
        stepper(bufs[t % 2], mask, params, out=bufs[(t + 1) % 2], partials=part[t])
    n_fluid = (mask == 0).sum().to(torch.float32)
    return bufs[n % 2], part.sum(dim=1) / n_fluid


def time_ms(fn, n: int) -> float:
    """Mean device time of one call of ``fn`` over n back-to-back calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def step_timer(stepper, params, mask, f):
    from advanced_hpc_lbm_tpu_torch.ops import step_kernel

    out = torch.empty_like(f)
    part = torch.empty(step_kernel.num_partials(*f.shape[1:]), device=f.device)
    return lambda: stepper(f, mask, params, out=out, partials=part)


def phase_kernel(card: str) -> tuple[float, dict]:
    from advanced_hpc_lbm_tpu_torch.ops import step_kernel

    dev = torch.device("cuda")
    cases = [(s, n, False) for s in ((1024, 1024), (64, 64), (100, 130), (17, 23))
             for n in (1, 50)] + [((64, 64), 50, True)]
    worst_f = 0.0
    times = {}
    for seed, ((ny, nx), n, guard) in enumerate(cases):
        params, mask_np, f0 = seeded_case(ny, nx, seed, guard)
        f = torch.from_numpy(f0).to(dev)
        mask = step_kernel.prepare_obstacles(torch.from_numpy(mask_np).to(dev))
        if guard:
            row = f0[:, ny - 2]
            starved = (~mask_np[ny - 2]) & ~(
                (row[3] - params.accel_w1 > 0) & (row[6] - params.accel_w2 > 0)
                & (row[7] - params.accel_w2 > 0))
            if not starved.any():
                fail("[3 kernel] the guard case has no cell failing the guard")
        fk, avk = run_steps(step_kernel.step, f, mask, params, n)
        fp, avp = run_steps(step_kernel.plain_step, f, mask, params, n)
        torch.cuda.synchronize()
        df = (fk - fp).abs().max().item()
        n_diff = int((fk != fp).sum().item())
        dav = ((avk - avp).abs() / avp.abs()).max().item()
        worst_f = max(worst_f, df)
        finite = bool(torch.isfinite(fk).all().item())
        label = f"{ny}x{nx} {n} step(s){' guard-failing row' if guard else ''}"
        say(f"[3 kernel] {label}: max|df| {df:.3e} ({n_diff} of {fk.numel()} "
            f"values differ), max rel dav {dav:.3e}")
        if not finite or not torch.allclose(fk, fp, rtol=F_RTOL, atol=F_ATOL):
            fail(f"[3 kernel] {label}: f differs beyond rtol {F_RTOL} atol {F_ATOL}")
        if not torch.allclose(avk, avp, rtol=AV_RTOL, atol=0.0):
            fail(f"[3 kernel] {label}: av differs beyond rtol {AV_RTOL}")
        if n == 1 and not guard:
            # the kernel as the run loop launches it, back to back; the plain
            # version one step per call
            k_ms = time_ms(lambda: step_kernel.run(f, mask, params, n_iters=RUN_STEPS), 3) / RUN_STEPS
            p_ms = time_ms(step_timer(step_kernel.plain_step, params, mask, f), 200)
            times[(ny, nx)] = (k_ms, p_ms)
            say(f"[3 kernel] {ny}x{nx} time per step: kernel {k_ms * 1e3:.2f} us "
                f"({ny * nx / k_ms / 1e6:.3f} GLUPS, run loop of {RUN_STEPS} steps), "
                f"plain {p_ms * 1e3:.2f} us ({ny * nx / p_ms / 1e6:.3f} GLUPS) | {card}")
    return worst_f, times


# ---- 3r. resident kernel -------------------------------------------------------

def diff_line(got, want) -> tuple[float, int]:
    """(max |got - want|, number of differing values)."""
    return (got - want).abs().max().item(), int((got != want).sum().item())


def check_against(tag: str, f, av, ref_f, ref_av, what: str, bitwise: bool) -> str:
    """Hold (f, av) to a reference: f equal (bitwise) or within rtol/atol,
    av within AV_RTOL; fail on any miss.  Returns the report fragment."""
    df, n_diff = diff_line(f, ref_f)
    dav = ((av - ref_av).abs() / ref_av.abs()).max().item() if av.numel() else 0.0
    if not bool(torch.isfinite(f).all().item()):
        fail(f"{tag}: non-finite state")
    if bitwise and n_diff:
        fail(f"{tag}: {n_diff} values differ from the {what}")
    if not torch.allclose(f, ref_f, rtol=F_RTOL, atol=F_ATOL):
        fail(f"{tag}: f differs from the {what} beyond rtol {F_RTOL} atol {F_ATOL}")
    if av.numel() and not torch.allclose(av, ref_av, rtol=AV_RTOL, atol=0.0):
        fail(f"{tag}: av differs from the {what} beyond rtol {AV_RTOL}")
    return f"vs {what}: {n_diff} of {f.numel()} values differ, max|df| {df:.3e}, max rel dav {dav:.3e}"


def on_card(ny: int, nx: int, seed: int, guard: bool = False):
    from advanced_hpc_lbm_tpu_torch.ops import step_kernel

    params, mask_np, f0 = seeded_case(ny, nx, seed, guard)
    mask = step_kernel.prepare_obstacles(torch.from_numpy(mask_np).cuda())
    return params, mask, torch.from_numpy(f0).cuda()


def plain_resident(f, mask, params, n, chunk):
    """The resident kernel's plain version on the card: chunks of plain_run
    into the kernel's partials layout."""
    from advanced_hpc_lbm_tpu_torch.ops import resident, step_kernel

    _, ny, nx = f.shape
    bufs = (f.clone(), torch.empty_like(f))
    part = torch.empty(n, step_kernel.num_partials(ny, nx), device=f.device)
    for t0 in range(0, n, chunk):
        m = min(chunk, n - t0)
        resident.plain_run((bufs[t0 % 2], bufs[(t0 + 1) % 2]), mask, params, m, part[t0:t0 + m])
    return bufs[n % 2], part.sum(dim=1) / (mask == 0).sum().to(torch.float32)


def resident_form(f, mask, params, n, chunk, form, k=None, blocks=0):
    """n steps of the resident kernel in chunks, in the form the shape takes
    (``form`` None) or the one named (the wrapper's test hooks, with the
    cooperative form's K and grid): (state, av), as resident_run returns
    them."""
    from advanced_hpc_lbm_tpu_torch.ops import resident, step_kernel

    if form is None:
        return resident.resident_run(f, mask, params, n_iters=n, chunk=chunk)
    _, ny, nx = f.shape
    mask = step_kernel.prepare_obstacles(mask)
    bufs = (f.clone(), torch.empty_like(f))
    part = torch.empty(chunk, step_kernel.num_partials(ny, nx), device=f.device)
    av = torch.empty(n, device=f.device)
    launch = resident._chunk_launcher(f, mask, params, blocks=blocks, form=form, k=k)
    for t0 in range(0, n, chunk):
        m = min(chunk, n - t0)
        launch((bufs[t0 % 2], bufs[(t0 + 1) % 2]), m, part)
        torch.sum(part[:m], dim=1, out=av[t0:t0 + m])
    return bufs[n % 2], av / (mask == 0).sum().to(torch.float32)


# grids whose form phase 3r holds: the C rule against resident.banded_fits
RULE_SHAPES = ((8, 32), (17, 23), (64, 64), (128, 128), (128, 256), (256, 128), (256, 256),
               (1056, 64), (1064, 64), (64, 318), (64, 319), (256, 512), (512, 512),
               (1024, 1024))
# the square grids that phase 3r times
TIMED_SQUARES = tuple((n, n) for n in (64, 128, 256, 512, 768, 1024, 2048, 4096))
# the small decks, which the banded form must take
BANDED_DECKS = ((64, 64), (128, 128), (128, 256), (256, 128), (256, 256))
# grids with fewer bands than an H100 has SMs, where the cooperative form
# cuts bands into segments of windows (and a 1024^2 deck, where it does
# not): phase 3r holds its tiles' C rule to resident.coop_segments there and
# times it beside pallask
TILED_GRIDS = ((512, 512), (256, 512), (256, 1024), (640, 1024), (656, 1024), (672, 1024),
               (8, 4096), (1024, 1024))


def check_banded_rule(card: str) -> None:
    """The C query lbm_resident_banded_fits equals resident.banded_fits on
    the card's limits; the small decks take the banded form, 512^2 and
    1024^2 the cooperative one; the cooperative form's C queries equal its
    Python rules."""
    from advanced_hpc_lbm_tpu_torch.ops import library, resident

    lib = library.load()
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for ny, nx in RULE_SHAPES:
        smem, blocks = resident._banded_limits(dev, nx)
        c_rule = lib.lbm_resident_banded_fits(ny, nx)
        py_rule = resident.banded_fits(ny, nx, smem, blocks)
        if c_rule != int(py_rule):
            fail(f"[3r resident] {ny}x{nx}: the C rule says {c_rule}, banded_fits {py_rule} "
                 f"(smem {smem} B, {blocks} co-resident blocks)")
        c_depth = lib.lbm_resident_banded_depth(ny, nx)
        if c_depth != resident.banded_depth(ny, nx, sms):
            fail(f"[3r resident] {ny}x{nx}: the C depth {c_depth}, banded_depth "
                 f"{resident.banded_depth(ny, nx, sms)}")
        if lib.lbm_resident_banded_smem(nx) != resident.band_smem_bytes(nx):
            fail(f"[3r resident] nx {nx}: C shared memory {lib.lbm_resident_banded_smem(nx)} B, "
                 f"band_smem_bytes {resident.band_smem_bytes(nx)} B")
        rows.append(f"{ny}x{nx} {resident.form_of(ny, nx, 'cuda')} ({blocks} bands co-resident, "
                    f"D={c_depth})")
    for ny, nx in BANDED_DECKS:
        if not resident.takes_banded(ny, nx, "cuda"):
            fail(f"[3r resident] {ny}x{nx} does not take the banded form")
    for ny, nx in ((512, 512), (1024, 1024)):
        if resident.form_of(ny, nx, "cuda") != "cooperative":
            fail(f"[3r resident] {ny}x{nx} takes the {resident.form_of(ny, nx, 'cuda')} form, "
                 f"expected the cooperative one")
    smem = resident._banded_limits(dev, 64)[0]
    say(f"[3r resident] form by shape, C rule = banded_fits and C depth = banded_depth at "
        f"{smem} B of opt-in shared memory: {', '.join(rows)}; a block's bytes: 32 columns "
        f"{resident.band_smem_bytes(32)} (D = {resident.band_depth(32)}), 64 "
        f"{resident.band_smem_bytes(64)} (D = {resident.band_depth(64)}) "
        "| ptxas: "
        + " | ".join(ptxas_report("resident")) + f" | {card}")
    # the cooperative form: its C queries against the Python rules
    coop = []
    for k in resident.COOP_K:
        c_smem, max_blocks = resident._coop_limits(dev, k)
        words = ctypes.c_longlong()
        for ny, nx in RULE_SHAPES + TILED_GRIDS + TIMED_SQUARES:
            library.check(lib.lbm_resident_coop_scratch(ny, nx, ctypes.byref(words)),
                          "sizing the cooperative outbox")
            grid = lib.lbm_resident_coop_grid(ny, nx, k)
            segs = lib.lbm_resident_coop_segments(ny, nx, k)
            want = (resident.coop_flag_words(ny, nx), resident.coop_blocks(ny, nx, max_blocks),
                    resident.coop_segments(ny, nx, max_blocks))
            if (words.value, grid, segs) != want:
                fail(f"[3r resident] {ny}x{nx} K={k}: C outbox {words.value} words, grid "
                     f"{grid}, {segs} segments a band; Python {want}")
        if c_smem != resident.coop_smem_bytes(k) or c_smem > smem:
            fail(f"[3r resident] K={k}: C shared memory {c_smem} B, Python "
                 f"{resident.coop_smem_bytes(k)} B, opt-in limit {smem} B")
        coop.append(f"K={k} {c_smem} B, {max_blocks // sms} block(s) per SM")
    for ny, nx in RULE_SHAPES + TIMED_SQUARES:
        if lib.lbm_resident_coop_k(ny, nx) != resident.coop_k(ny, nx):
            fail(f"[3r resident] {ny}x{nx}: C K {lib.lbm_resident_coop_k(ny, nx)}, coop_k "
                 f"{resident.coop_k(ny, nx)}")
    max_blocks = resident._coop_limits(dev, resident.coop_k(1024, 1024))[1]
    say(f"[3r resident] cooperative form: C queries (K, outbox words, segments, grid, shared "
        f"memory) = the Python rules at {len(RULE_SHAPES + TILED_GRIDS + TIMED_SQUARES)} shapes; "
        f"K by shape " + ", ".join(f"{n}^2 {resident.coop_k(n, n)}" for n, _ in TIMED_SQUARES)
        + "; segments a band, tiles and blocks: " + ", ".join(
            f"{ny}x{nx} {resident.coop_segments(ny, nx, max_blocks)}, "
            f"{len(resident.coop_tiles(ny, nx, resident.coop_segments(ny, nx, max_blocks)))}, "
            f"{resident.coop_blocks(ny, nx, max_blocks)}" for ny, nx in TILED_GRIDS + TIMED_SQUARES)
        + f"; {', '.join(coop)} | {card}")


# shapes at which phase 3r runs the cooperative form at every built K, and
# with fewer blocks than bands (a block owning several bands)
COOP_K_SHAPES = ((256, 512), (100, 130), (17, 23), (24, 64), (16, 64), (8, 40))


def phase_resident(card: str) -> tuple[dict, dict]:
    """Every form at every shape against the step kernel (0 differing
    values) and the plain version; returns (worst max |df| against the
    plain version per form, times)."""
    from advanced_hpc_lbm_tpu_torch.ops import resident, step_kernel

    check_banded_rule(card)
    shapes = ((1024, 1024), (672, 1024), (640, 1024), (512, 512), (256, 512), (8, 4096),
              (256, 256), (128, 256), (128, 128), (64, 64), (100, 130), (17, 23))
    worst = {"banded": 0.0, "cooperative": 0.0}
    for seed, (ny, nx) in enumerate(shapes):
        taken = resident.form_of(ny, nx, "cuda")
        # the form the shape takes (the wrapper's rule), then the other forms
        # that take it through the test hook
        forms = [(None, None)] + ([("cooperative", None)] if taken != "cooperative" else [])
        if (ny, nx) in COOP_K_SHAPES:
            forms += [("cooperative", k) for k in resident.COOP_K]
        for n, chunk, guard in ((1, resident.CHUNK, False), (50, resident.CHUNK, False),
                                (17, 6, True)):
            params, mask, f = on_card(ny, nx, 100 + seed, guard)
            fs, avs = step_kernel.run(f, mask, params, n_iters=n)
            fp, avp = plain_resident(f, mask, params, n, chunk)
            for form, k in forms:
                name = form or taken
                tag = (f"[3r resident] {name}{'' if form else ' (the rule)'} {ny}x{nx} {n} "
                       f"step(s), chunk {chunk}"
                       + (f", K={k or resident.coop_k(ny, nx)}" if name == "cooperative" else "")
                       + (", guard-failing row" if guard else ""))
                resident.launches = resident.banded_launches = 0
                fr, avr = resident_form(f, mask, params, n, chunk, form, k)
                torch.cuda.synchronize()
                counts = {"banded": resident.banded_launches, "cooperative": resident.launches}
                want = {other: -(-n // chunk) if other == name else 0 for other in counts}
                if counts != want:
                    fail(f"{tag}: launches {counts}, expected {want}")
                worst[name] = max(worst[name], diff_line(fr, fp)[0])
                say(f"{tag}: {sum(counts.values())} launch(es); "
                    f"{check_against(tag, fr, avr, fs, avs, 'step kernel', True)}; "
                    f"{check_against(tag, fr, avr, fp, avp, 'plain version', False)}")
    coop_partials(card)
    return worst, time_whole_runs(card)


# grids at which phase 3r holds the cooperative form's partials at every
# built K: segmented bands (512^2: 2 segments a band, 256x1024: 4,
# 640x1024: 8, 672x1024: 3, 8x4096: 32 on an H100) and one segment
# (1024^2); and (grid, blocks) with fewer blocks than tiles
COOP_TILED_SHAPES = ((512, 512), (256, 1024), (640, 1024), (672, 1024), (8, 4096), (1024, 1024))
COOP_FEW_BLOCKS = (((64, 64), 1), ((64, 64), 3), ((512, 512), 7), ((8, 4096), 5),
                   ((640, 1024), 37))


def coop_partials(card: str) -> None:
    """The cooperative form's per-tile partials bitwise equal to the step
    kernel's, 17 steps in chunks of 6 with a guard-failing row, at every
    built K; also with fewer blocks than tiles, which own several tiles
    each."""
    from advanced_hpc_lbm_tpu_torch.ops import resident, step_kernel

    cases = [((ny, nx), k, 0) for ny, nx in COOP_K_SHAPES + COOP_TILED_SHAPES
             for k in resident.COOP_K]
    cases += [(shape, k, blocks) for k in resident.COOP_K for shape, blocks in COOP_FEW_BLOCKS]
    for (ny, nx), k, blocks in cases:
        params, mask, f = on_card(ny, nx, 500 + ny, True)
        tiles = step_kernel.num_partials(ny, nx)
        bufs = [f.clone(), torch.empty_like(f)]
        ps = torch.empty(17, tiles, device="cuda")
        for t in range(17):
            step_kernel.step(bufs[t % 2], mask, params, out=bufs[(t + 1) % 2], partials=ps[t])
        launch = resident._chunk_launcher(f, mask, params, blocks=blocks, form="cooperative",
                                          k=k)
        rb = [f.clone(), torch.empty_like(f)]
        pr = torch.empty(17, tiles, device="cuda")
        for t0 in range(0, 17, 6):
            m = min(6, 17 - t0)
            launch((rb[t0 % 2], rb[(t0 + 1) % 2]), m, pr[t0:t0 + m])
        torch.cuda.synchronize()
        n_f, n_p = int((rb[1] != bufs[1]).sum().item()), int((pr != ps).sum().item())
        if n_f or n_p:
            fail(f"[3r resident] cooperative {ny}x{nx} K={k}, blocks {blocks or 'per tile'}: "
                 f"{n_f} state values and {n_p} partials differ from the step kernel")
    say(f"[3r resident] cooperative form, 17 steps in chunks of 6 with a guard-failing row, "
        f"partials and state bitwise equal to the step kernel's at K = "
        f"{', '.join(map(str, resident.COOP_K))} on "
        f"{len(COOP_K_SHAPES + COOP_TILED_SHAPES)} shapes, and with fewer blocks than tiles: "
        + ", ".join(f"{ny}x{nx} {b}" for (ny, nx), b in COOP_FEW_BLOCKS) + f" | {card}")


def time_whole_runs(card: str) -> dict:
    """us per step of the resident kernel in the form the shape takes, the
    step kernel's run loop and the plain step at grids from 64^2 to 4096^2
    (one chunk of RUN_STEPS steps per timed run; the plain step one call at
    a time); at 64^2, 128^2 and 256^2 the banded and the cooperative form
    in turns (cooperative, banded, banded, cooperative); from 512^2 the
    cooperative form at every built K and pallask (best_k) in turns, each
    twice (the order reversed the second time).  Returns (resident, step,
    plain, cooperative form) ms per step by grid."""
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel, resident, step_kernel

    times = {}
    for seed, (n, _) in enumerate(TIMED_SQUARES):
        params, mask, f = on_card(n, n, 200 + seed)
        steps = RUN_STEPS if n <= 2048 else RUN_STEPS // 4
        reps = 3 if n <= 2048 else 1
        k_rule = resident.coop_k(n, n)

        def run(form=None, k=None):
            return time_ms(lambda: resident_form(f, mask, params, steps, steps, form, k),
                           reps) / steps
        if resident.takes_banded(n, n, "cuda"):
            c1, b1, b2, c2 = run("cooperative"), run(), run(), run("cooperative")
            r_ms, coop_ms = (b1 + b2) / 2, (c1 + c2) / 2
            forms = (f"banded {r_ms * 1e3:.2f} us ({b1 * 1e3:.2f}, {b2 * 1e3:.2f}), "
                     f"cooperative K={k_rule} {coop_ms * 1e3:.2f} us ({c1 * 1e3:.2f}, "
                     f"{c2 * 1e3:.2f}), banded {coop_ms / r_ms - 1:+.1%} faster")
        else:
            best = kstep_kernel.best_k(n, n)
            timers = {f"pallask K={best}": lambda: time_ms(
                          lambda: kstep_kernel.run(f, mask, params, n_iters=steps, k=best),
                          reps) / steps,
                      **{f"cooperative K={k}": (lambda k=k: run("cooperative", k))
                         for k in resident.COOP_K}}
            got = {name: [fn()] for name, fn in timers.items()}
            for name in reversed(list(timers)):
                got[name].append(timers[name]())
            mean = {name: sum(v) / 2 for name, v in got.items()}
            r_ms = coop_ms = mean[f"cooperative K={k_rule}"]
            forms = (f"cooperative form {r_ms * 1e3:.2f} us; "
                     + ", ".join(f"{name} {mean[name] * 1e3:.2f} us "
                                 f"({v[0] * 1e3:.2f}, {v[1] * 1e3:.2f})"
                                 for name, v in got.items())
                     + f"; cooperative (K={k_rule}) {mean[f'pallask K={best}'] / coop_ms - 1:+.1%} "
                     f"faster than pallask")
        s_ms = time_ms(lambda: step_kernel.run(f, mask, params, n_iters=steps), reps) / steps
        p_ms = (time_ms(step_timer(step_kernel.plain_step, params, mask, f), 20)
                if n in (128, 512, 1024) else float("nan"))
        times[(n, n)] = (r_ms, s_ms, p_ms, coop_ms)
        say(f"[3r resident] {n}x{n} time per step ({steps} steps, one chunk): resident "
            f"{forms} ({n * n / r_ms / 1e6:.3f} GLUPS), step run loop "
            f"{s_ms * 1e3:.2f} us ({n * n / s_ms / 1e6:.3f} GLUPS), plain "
            + (f"{p_ms * 1e3:.2f} us" if p_ms == p_ms else "not timed")
            + f" | {card}")
    time_tiled(card)
    return times


def time_tiled(card: str) -> None:
    """The cooperative form (its K, the rule's tiles) and pallask (best_k)
    in turns (cooperative, pallask, pallask, cooperative) at the
    TILED_GRIDS that time_whole_runs does not time."""
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel, resident

    for seed, (ny, nx) in enumerate(TILED_GRIDS):
        if (ny, nx) in TIMED_SQUARES:
            continue
        max_blocks = resident._coop_limits(torch.cuda.current_device(),
                                           resident.coop_k(ny, nx))[1]
        params, mask, f = on_card(ny, nx, 600 + seed)
        best = kstep_kernel.best_k(ny, nx)

        def coop():
            return time_ms(lambda: resident_form(f, mask, params, RUN_STEPS, RUN_STEPS,
                                                 "cooperative"), 2) / RUN_STEPS

        def pallask():
            return time_ms(lambda: kstep_kernel.run(f, mask, params, n_iters=RUN_STEPS, k=best),
                           2) / RUN_STEPS
        c1, p1, p2, c2 = coop(), pallask(), pallask(), coop()
        got = {f"cooperative K={resident.coop_k(ny, nx)}": (c1, c2),
               f"pallask K={best}": (p1, p2)}
        segs = resident.coop_segments(ny, nx, max_blocks)
        say(f"[3r resident] {ny}x{nx} ({resident.num_bands(ny)} bands, {segs} segments a band, "
            f"{resident.coop_blocks(ny, nx, max_blocks)} blocks): "
            + ", ".join(f"{name} {sum(v) / 2 * 1e3:.2f} us ({v[0] * 1e3:.2f}, {v[1] * 1e3:.2f})"
                        for name, v in got.items())
            + f"; cooperative {(p1 + p2) / (c1 + c2) - 1:+.1%} faster than pallask | {card}")


# ---- 3k. K-step kernel ----------------------------------------------------------

def plain_kstep(f, mask, params, k, passes):
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel

    _, ny, nx = f.shape
    part = torch.empty(passes, k, kstep_kernel.num_tiles(ny, nx), device=f.device)
    for p in range(passes):
        out = torch.empty_like(f)
        kstep_kernel.plain_multi_step(f, mask, params, k, out=out, partials=part[p])
        f = out
    return f, part.sum(dim=2).reshape(-1) / (mask == 0).sum().to(torch.float32)


def check_feed(ny: int, nx: int, k: int, tag: str) -> str:
    """The kernel's C rules for the (ny, nx) grid at K against their Python
    restatements: the tiles the bulk tensor copy feeds, the teams a block,
    whether a launch walks its passes and the (pass, tile) of the items of
    a walk of 3 passes."""
    from advanced_hpc_lbm_tpu_torch.ops import _build, kstep_kernel

    lib = _build.load()
    bulk = lib.lbm_kstep_bulk_tiles(ny, nx, k)
    if bulk != kstep_kernel.bulk_tiles(ny, nx, k):
        fail(f"{tag}: lbm_kstep_bulk_tiles {bulk} != the rule's "
             f"{kstep_kernel.bulk_tiles(ny, nx, k)}")
    teams, stages = ctypes.c_int(), ctypes.c_int()
    if (lib.lbm_kstep_schedule(k, ctypes.byref(teams), ctypes.byref(stages)) != 0
            or teams.value != kstep_kernel.teams(k) or stages.value < 3):
        fail(f"{tag}: lbm_kstep_schedule {teams.value} teams, {stages.value} stages; "
             f"the rule's {kstep_kernel.teams(k)} teams")
    walks = bool(lib.lbm_kstep_walks(ny, nx))
    rule = kstep_kernel.walks(ny, nx, kstep_kernel.card_sms("cuda"))
    if walks != rule:
        fail(f"{tag}: lbm_kstep_walks {walks} != the rule's {rule}")
    pass_ = ctypes.c_int()
    for j in range(3 * kstep_kernel.num_tiles(ny, nx)):
        t = lib.lbm_kstep_item(ny, nx, j, ctypes.byref(pass_))
        if (pass_.value, t) != kstep_kernel.item(ny, nx, j):
            fail(f"{tag}: lbm_kstep_item({j}) {(pass_.value, t)} != the rule's "
                 f"{kstep_kernel.item(ny, nx, j)}")
    return (f"{'walks' if walks else 'a launch a pass'}, "
            f"bulk {bulk} / wrap {kstep_kernel.num_tiles(ny, nx) - bulk} tiles, "
            f"{teams.value} teams, {stages.value} stages")


def check_loop_span(ny: int, nx: int) -> None:
    """A recorded run's lbm.ops.loop span carries the tiles of its passes
    by feed: the C rule's count times the passes."""
    from advanced_hpc_lbm_tpu_torch.ops import _build, kstep_kernel
    from advanced_hpc_lbm_tpu_torch.utils import profiling

    k = kstep_kernel.best_k(ny, nx)
    params, mask, f = on_card(ny, nx, 399)
    passes = 4
    with profiling.recording() as rec:
        kstep_kernel.run(f, mask, params, n_iters=passes * k, k=k)
    torch.cuda.synchronize()
    loop = [sp for sp in rec.spans if sp.name == "lbm.ops.loop"]
    bulk = _build.load().lbm_kstep_bulk_tiles(ny, nx, k)
    want = {"launches": 1, "passes_per_launch": passes, "tiles_bulk": passes * bulk,
            "tiles_wrap": passes * (kstep_kernel.num_tiles(ny, nx) - bulk)}
    got = {key: loop[0].attrs.get(key) for key in want} if len(loop) == 1 else None
    if got != want:
        fail(f"[3k kstep] {ny}x{nx} K={k}: lbm.ops.loop spans {[sp.attrs for sp in loop]}, "
             f"expected one with {want}")
    say(f"[3k kstep] {ny}x{nx} K={k}: lbm.ops.loop carries {got} (lbm_kstep_bulk_tiles "
        f"{bulk} a pass)")


def phase_kstep(card: str, res_times: dict) -> tuple[float, dict]:
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel, step_kernel

    worst = 0.0
    shapes = ((4096, 4096), (1024, 1024), (256, 256), (128, 256), (64, 64),
              (100, 130), (17, 23))
    for seed, (ny, nx) in enumerate(shapes):
        # every built K; at 4096^2 the K the pallask backend runs there, and 2, 4, 8
        ks = ({2, 4, 8, kstep_kernel.best_k(ny, nx)} if ny == 4096
              else set(kstep_kernel.K_RANGE))
        for k in sorted(ks):
            feed = check_feed(ny, nx, k, f"[3k kstep] {ny}x{nx} K={k}")
            for passes, guard in ((1, False), (3, True)):
                params, mask, f = on_card(ny, nx, 300 + seed, guard)
                n = k * passes
                tag = f"[3k kstep] {ny}x{nx} K={k}, {passes} pass(es)" + (
                    ", guard-failing row" if guard else "")
                kstep_kernel.launches = 0
                fk, avk = kstep_kernel.run(f, mask, params, n_iters=n, k=k)
                torch.cuda.synchronize()
                want = 1 if kstep_kernel.walks(ny, nx, kstep_kernel.card_sms("cuda")) else passes
                if kstep_kernel.launches != want:
                    fail(f"{tag}: {kstep_kernel.launches} launches, expected {want}")
                fs, avs = step_kernel.run(f, mask, params, n_iters=n)
                fp, avp = plain_kstep(f, mask, params, k, passes)
                torch.cuda.synchronize()
                worst = max(worst, diff_line(fk, fp)[0])
                say(f"{tag}: {check_against(tag, fk, avk, fs, avs, 'step kernel', True)}; "
                    f"{check_against(tag, fk, avk, fp, avp, 'plain version', False)}; "
                    f"{feed}")
                del fp, avp
    check_loop_span(1024, 1024)
    k_times = time_kstep(card)
    check_auto(card, res_times, k_times)
    return worst, k_times


def time_kstep(card: str) -> dict:
    """us per step of the K-step kernel for each TIMED_K beside the step
    kernel's run loop, and of the plain version at 4096^2 (at best_k)."""
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel, step_kernel

    times = {}
    n = KSTEP_TIMED_STEPS
    for seed, size in enumerate((4096, 2048, 1024, 768, 512, 256, 128, 64)):
        params, mask, f = on_card(size, size, 400 + seed)
        s_ms = time_ms(lambda: step_kernel.run(f, mask, params, n_iters=n), 2) / n
        row = {"step": s_ms}
        for k in TIMED_K:
            row[k] = time_ms(lambda: kstep_kernel.run(f, mask, params, n_iters=n, k=k), 2) / n
        if size == 4096:
            # the plain version at best_k (pallask) and at K = 2 (pallas2)
            for key, k in (("plain", kstep_kernel.best_k(size, size)), ("plain K=2", 2)):
                out = torch.empty_like(f)
                part = torch.empty(k, kstep_kernel.num_tiles(size, size), device=f.device)
                row[key] = time_ms(lambda: kstep_kernel.plain_multi_step(
                    f, mask, params, k, out=out, partials=part), 2) / k
        times[(size, size)] = row
        ks = " ".join(f"K={k} {row[k] * 1e3:.2f} us ({size * size / row[k] / 1e6:.3f} GLUPS)"
                      for k in TIMED_K)
        plain = (f", plain K={kstep_kernel.best_k(size, size)} {row['plain'] * 1e3:.2f} us, "
                 f"plain K=2 {row['plain K=2'] * 1e3:.2f} us" if "plain" in row else "")
        say(f"[3k kstep] {size}x{size} time per step ({n} steps): {ks}; step run loop "
            f"{s_ms * 1e3:.2f} us ({size * size / s_ms / 1e6:.3f} GLUPS){plain} | {card}")
        if size in KSTEP_BEFORE_US:
            k = kstep_kernel.best_k(size, size)
            step_us, pass_us = KSTEP_BEFORE_US[size]
            kstep_kernel.launches = 0
            kstep_kernel.run(f, mask, params, n_iters=n, k=k)
            say(f"[3k kstep] {size}x{size} K={k}: {row[k] * 1e3:.2f} us a step, "
                f"{row[k] * k * 1e3:.2f} us a pass, {kstep_kernel.launches} launch(es) for "
                f"{n // k} passes; a launch a pass before {step_us:.2f} us a step, "
                f"{pass_us:.2f} us a pass ({row[k] * 1e3 / step_us - 1:+.1%}) | {card}")
    return times


def check_auto(card: str, res_times: dict, k_times: dict) -> None:
    """One line per timed grid: each backend's us per step and what auto and
    best_k choose there (a report; the choice is fixed in the code)."""
    from advanced_hpc_lbm_tpu_torch.models import d2q9_bgk
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel
    from advanced_hpc_lbm_tpu_torch.params import LBMParams

    for (ny, nx), row in sorted(k_times.items()):
        k = min(TIMED_K, key=row.get)
        t = {"step": row["step"], "resident": res_times[(ny, nx)][0],
             "pallask": row[kstep_kernel.best_k(ny, nx)]}
        auto = d2q9_bgk.Simulation(LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10,
                                             density=0.1, accel=0.005, omega=1.85),
                                   np.zeros((ny, nx), dtype=bool), device="cuda").backend
        fastest = min(t, key=t.get)
        say(f"[3k auto] {ny}x{nx}: step {t['step'] * 1e3:.2f} us, resident "
            f"{t['resident'] * 1e3:.2f} us, pallask (K={kstep_kernel.best_k(ny, nx)}) "
            f"{t['pallask'] * 1e3:.2f} us, fastest K here {k}; auto picks {auto}, "
            f"{'the fastest' if auto == fastest else 'fastest was ' + fastest} | {card}")


def retime(card: str, step_times: dict, k_times: dict, s_times: dict, l_times: dict) -> None:
    """The redesigned K-step and stream kernels and the untouched step
    kernel (the yardstick that the card matches the earlier one), beside
    PERF.md's times from before the redesign."""
    now = {"step 1024^2": step_times[(1024, 1024)][0], "K=4 4096^2": k_times[(4096, 4096)][4],
           "K=4 1024^2": k_times[(1024, 1024)][4], "K=2 4096^2": k_times[(4096, 4096)][2],
           "local K=4 2048x8192": l_times["ca"][0],
           **{f"stream {n}^2": s_times[(n, n)]["stream"] for n in (4096, 8192, 16384)}}
    say("[3 retime] us per step now vs before the redesign (PERF.md): " + ", ".join(
        f"{name} {now[name] * 1e3:.2f} vs {BEFORE_US[name]:.2f} "
        f"({now[name] * 1e3 / BEFORE_US[name] - 1:+.1%})" for name in BEFORE_US) + f" | {card}")


# ---- 3s. stream kernel ----------------------------------------------------------

def plain_stream(f, enc, params, passes):
    """``passes`` passes of the stream kernel's plain version, out of place."""
    from advanced_hpc_lbm_tpu_torch.ops import stream_kernel as sk

    _, ny, nx = f.shape
    part = torch.empty(passes, sk.K, sk.num_tiles(ny, nx), device=f.device)
    for p in range(passes):
        out = torch.empty_like(f)
        sk.plain_multi_step(f, enc, params, out=out, partials=part[p])
        f = out
    n_fluid = ((enc & sk.OBSTACLE) == 0).sum().to(torch.float32)
    return f, part.sum(dim=2).reshape(-1) / n_fluid


def phase_stream(card: str) -> tuple[float, dict]:
    from advanced_hpc_lbm_tpu_torch.ops import step_kernel
    from advanced_hpc_lbm_tpu_torch.ops import stream_kernel as sk

    worst = 0.0
    shapes = ((8192, 8192), (4096, 4096), (1024, 1024), (256, 256), (64, 64), (100, 130),
              (17, 23))
    for seed, (ny, nx) in enumerate(shapes):
        for passes, guard in ((1, False), (3, True)):
            params, mask, f = on_card(ny, nx, 500 + seed, guard)
            enc = sk.prepare_obstacles(mask)
            n = sk.K * passes
            fs, avs = step_kernel.run(f, mask, params, n_iters=n)
            fp, avp = plain_stream(f, enc, params, passes)
            for inplace in (True, False):
                tag = (f"[3s stream] {ny}x{nx} {'in place' if inplace else 'out of place'}, "
                       f"{passes} pass(es)" + (", guard-failing row" if guard else ""))
                sk.launches = sk.snapshot_launches = 0
                fk, avk = sk.run(f, enc, params, n_iters=n, inplace=inplace)
                torch.cuda.synchronize()
                if (sk.launches, sk.snapshot_launches) != (passes, passes):
                    fail(f"{tag}: {sk.launches} passes and {sk.snapshot_launches} snapshots, "
                         f"expected {passes} of each")
                worst = max(worst, diff_line(fk, fp)[0])
                say(f"{tag}: {check_against(tag, fk, avk, fs, avs, 'step kernel', True)}; "
                    f"{check_against(tag, fk, avk, fp, avp, 'plain version', False)}")
                del fk
            del fs, fp
    # masks the step kernel cannot express: against the plain version only
    ny = nx = 1024
    params, mask, f = on_card(ny, nx, 520)
    accel = torch.zeros(ny, dtype=torch.bool, device=f.device)
    accel[[100, ny - 2]] = True
    excl = torch.zeros(ny, nx, dtype=torch.bool, device=f.device)
    excl[300:400, 200:700] = True
    plain_enc = sk.prepare_obstacles(mask)
    for label, enc in (("+4 cells", sk.mark_reduction_excluded(plain_enc, excl)),
                       ("+2 on rows 100 and ny-2", sk.encode_masks(mask, accel))):
        tag = f"[3s stream] {ny}x{nx} {label}, in place, 1 pass"
        n_fluid = ((enc & sk.OBSTACLE) == 0).sum().to(torch.float32)
        fk = f.clone()
        part = torch.empty(sk.K, sk.num_tiles(ny, nx), device=f.device)
        sk.stream_pass(fk, enc, params, partials=part)
        fp, avp = plain_stream(f, enc, params, 1)
        worst = max(worst, diff_line(fk, fp)[0])
        say(f"{tag}: {check_against(tag, fk, part.sum(dim=1) / n_fluid, fp, avp, 'plain version', False)}")
    return worst, time_stream(card)


def time_stream(card: str) -> dict:
    """us per step of the stream kernel in place beside pallask (at best_k)
    and the step kernel's run loop, each run starting in its input's own
    buffer; and of the plain version for one pass at 4096^2.  Then which
    backend auto picks on this card at each size."""
    from advanced_hpc_lbm_tpu_torch import Simulation
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel, step_kernel
    from advanced_hpc_lbm_tpu_torch.ops import stream_kernel as sk

    n = STREAM_TIMED_STEPS
    times = {}
    for seed, size in enumerate((2048, 4096, 8192, 16384)):
        params, mask, f = on_card(size, size, 600 + seed)
        enc = sk.prepare_obstacles(mask)
        k = kstep_kernel.best_k(size, size)
        row = {
            "stream": time_ms(lambda: sk.run(f, enc, params, n_iters=n, donate=True), 2) / n,
            "pallask": time_ms(lambda: kstep_kernel.run(f, mask, params, n_iters=n, k=k,
                                                        donate=True), 2) / n,
            "step": time_ms(lambda: step_kernel.run(f, mask, params, n_iters=n,
                                                    donate=True), 2) / n,
        }
        if size == 4096:
            out = torch.empty_like(f)
            part = torch.empty(sk.K, sk.num_tiles(size, size), device=f.device)
            row["plain"] = time_ms(lambda: sk.plain_multi_step(
                f, enc, params, out=out, partials=part), 2) / sk.K
            del out
        del f, mask, enc
        auto = Simulation(params, np.zeros((size, size), dtype=bool), device="cuda").backend
        times[(size, size)] = row
        fastest = min(("stream", "pallask", "step"), key=row.get)
        say(f"[3s stream] {size}x{size} time per step ({n} steps): stream in place "
            f"{row['stream'] * 1e3:.2f} us ({size * size / row['stream'] / 1e6:.3f} GLUPS), "
            f"pallask K={k} {row['pallask'] * 1e3:.2f} us, step run loop "
            f"{row['step'] * 1e3:.2f} us"
            + (f", plain {row['plain'] * 1e3:.2f} us" if "plain" in row else "")
            + f"; fastest {fastest}, auto picks {auto} | {card}")
    return times


# ---- 4.-7. the main path: decks through the CLI and the library ------------------

def run_cli(argv: list[str]) -> tuple[int, list[str], dict]:
    """``cli.main(argv)`` in-process: (rc, stdout lines, launches per kernel)."""
    from advanced_hpc_lbm_tpu_torch import cli

    buf = io.StringIO()
    counts: dict = {}
    with counted(counts), contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines(), counts


def expected_launches(backend: str, ny: int, nx: int, iters: int) -> dict:
    """Launches per kernel module of a run of ``iters`` steps."""
    from advanced_hpc_lbm_tpu_torch.models import d2q9_bgk
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel, resident, stream_kernel

    if backend == "auto":
        backend = ("resident" if resident.takes_banded(ny, nx, "cuda")
                   else d2q9_bgk.AUTO_BACKEND)
    forms = {"banded": "resident_banded_kernel", "cooperative": "resident_kernel"}
    want = dict.fromkeys(kernel_counters(), 0)
    if backend in ("step", "pallas"):
        want["step_kernel"] = iters
    elif backend == "resident":
        want[forms[resident.form_of(ny, nx, "cuda")]] = -(-iters // resident.CHUNK)
    elif backend == "stream":
        want["stream_kernel"], want["step_kernel"] = divmod(iters, stream_kernel.K)
        want["stream_snapshot"] = want["stream_kernel"]
    else:
        k = 2 if backend == "pallas2" else kstep_kernel.best_k(ny, nx)
        want["kstep_kernel"], want["step_kernel"] = divmod(iters, k)
    return want


def check_block(lines: list[str], tag: str) -> dict[str, float]:
    """The ==done== block: Reynolds and the four timers, parsed."""
    if len(lines) != 6 or lines[0] != "==done==":
        fail(f"{tag} stdout is not the ==done== block: {lines[:8]}")
    out = {"reynolds": float(lines[1].split("\t")[-1])}
    for line, phase in zip(lines[2:], ("Init", "Compute", "Collate", "Total")):
        if not (line.startswith(f"Elapsed {phase} time:") and line.endswith("(s)")):
            fail(f"{tag} bad timer line {line!r}")
        out[phase.lower()] = float(line.split("\t")[-1].split()[0])
    if not np.isfinite(out["reynolds"]):
        fail(f"{tag} Reynolds number is not finite")
    return out


def phase_mini() -> None:
    from advanced_hpc_lbm_tpu_torch.utils import check

    decks = ROOT / "decks"
    for backend in ("auto", "pallas", "resident", "pallask", "pallas2", "stream"):
        tag = f"[4 mini] --backend {backend}:"
        with tempfile.TemporaryDirectory() as tmp:
            rc, lines, n = run_cli([str(decks / "mini_64x64.params"),
                                    str(decks / "mini_64x64.obstacles.dat"),
                                    "--backend", backend, "--out-dir", tmp])
            if rc != 0:
                fail(f"{tag} CLI exited {rc}")
            want = expected_launches(backend, 64, 64, 500)
            if n != want:
                fail(f"{tag} launches {n}, expected {want}")
            block = check_block(lines, tag)
            stats = check.check_av_vels_only(
                str(decks / "mini_64x64.golden_av_vels.dat"), str(Path(tmp) / "av_vels.dat"))
            if not stats.passed(1.0):
                fail(f"{tag} av_vels fail the golden: {stats.max_diff_pcnt:.4g}%")
        say(f"{tag} 64x64, 500 steps: launches {n}, Reynolds "
            f"{block['reynolds']:.6E}, golden max diff {stats.max_diff_pcnt:.4g}% "
            f"(limit 1%), Compute {block['compute']:.4f} s")


def write_full_deck(d: Path, nx: int, ny: int, iters: int) -> tuple[Path, Path]:
    """A benchmark deck: a closed box and a half-height wall at x = nx // 3
    (the same geometry as bench.py's build_deck)."""
    params = d / f"full_{ny}x{nx}.params"
    params.write_text(f"{nx}\n{ny}\n{iters}\n10\n0.1\n0.01\n1.85\n")
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[:, 0] = mask[:, -1] = True
    mask[: ny // 2, min(nx - 1, nx // 3)] = True
    yy, xx = np.nonzero(mask)
    obst = d / f"full_{ny}x{nx}.obstacles.dat"
    obst.write_text("".join(f"{x} {y} 1\n" for x, y in zip(xx.tolist(), yy.tolist())))
    return params, obst


def phase_full(card: str, times: dict, keep: Path) -> dict:
    """bench.py's 1024^2 deck (``write_full_deck``: a half-height wall at
    x = 341, where the reference's 1024^2 deck, phase 5r's, has a
    full-height one; the same params); returns the library run's state and
    av and the digest of auto's final_state.dat, the straight run phase 9
    holds its checkpointed runs to; auto's final_state.dat is kept in
    ``keep`` for phase 13."""
    from advanced_hpc_lbm_tpu_torch import Simulation
    from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io

    nx = ny = 1024
    iters = 20_000
    with tempfile.TemporaryDirectory() as tmp:
        params_f, obst_f = write_full_deck(Path(tmp), nx, ny, iters)
        histories, digests = {}, {}
        for backend in ("auto", "resident"):
            tag = f"[5 full] --backend {backend}:"
            with final_state_writes() as writes:
                rc, lines, n = run_cli([str(params_f), str(obst_f), "--backend", backend,
                                        "--out-dir", tmp])
            if rc != 0:
                fail(f"{tag} CLI exited {rc}")
            want = expected_launches(backend, ny, nx, iters)
            if n != want:
                fail(f"{tag} launches {n}, expected {want}")
            block = check_block(lines, tag)
            av_cli = lbm_io.read_av_vels(Path(tmp) / "av_vels.dat")
            if av_cli.shape != (iters,) or not np.all(np.isfinite(av_cli)) or not np.all(av_cli > 0):
                fail(f"{tag} av history is not finite and positive")
            histories[backend] = av_cli
            port_codec_check(tag, writes)
            digests[backend] = digest(Path(tmp) / "final_state.dat")
            if backend == "auto":
                shutil.copy(Path(tmp) / "final_state.dat", keep / "final_state.dat")
            glups = iters * nx * ny / block["compute"] / 1e9
            say(f"{tag} bench.py's {ny}x{nx} deck (half-height wall; not the reference "
                f"deck), {iters} steps: launches {n}, Compute "
                f"{block['compute']:.4f} s = {glups:.3f} GLUPS (host loop included), "
                f"Init {block['init']:.3f} s, Collate {block['collate']:.3f} s, Reynolds "
                f"{block['reynolds']:.6E}, final av {av_cli[-1]:.6E} | {card}")
            say(f"{tag} {codec_line(writes[0], nx * ny)} | {card}")

        # the same deck through the library entry points, for the state
        sim = Simulation.from_decks(params_f, obst_f, device="cuda")
        sim.warmup()
        counts: dict = {}
        with counted(counts):
            res = sim.run(check_finite=True)
    mass0 = float(sim.initial_state().double().sum().item())
    mass1 = float(res.f_final.astype(np.float64).sum())
    drift = abs(mass1 - mass0) / mass0
    if drift > 1e-4:
        fail(f"[5 full] total density drifted by {drift:.3e} (limit 1e-4)")
    for backend, av_cli in histories.items():
        if not np.allclose(res.av_vels, av_cli, rtol=1e-5, atol=0.0):
            fail(f"[5 full] library run ({sim.backend}) disagrees with the CLI's "
                 f"--backend {backend} av history")
    same = bool(np.array_equal(histories["auto"], histories["resident"]))
    r_ms, s_ms, p_ms = times[(ny, nx)][:3]
    from advanced_hpc_lbm_tpu_torch.ops import resident

    say(f"[5 full] library run ({sim.backend}): launches {counts}, mass drift {drift:.3e} "
        f"(limit 1e-4), av within rtol 1e-5 of both CLI runs; auto and resident (its "
        f"{resident.form_of(ny, nx, 'cuda')} form, K={resident.coop_k(ny, nx)}) av "
        f"{'bitwise equal' if same else 'within rtol 1e-5'} | {card}")
    say(f"[5 full] {ny}x{nx} kernels alone: resident {nx * ny / r_ms / 1e6:.3f} GLUPS "
        f"({r_ms * 1e3:.2f} us/step), step run loop {nx * ny / s_ms / 1e6:.3f} GLUPS "
        f"({s_ms * 1e3:.2f} us/step), plain step {nx * ny / p_ms / 1e6:.3f} GLUPS "
        f"({p_ms * 1e3:.2f} us/step) | {card}")
    return {"f": res.f_final, "av": res.av_vels, "final_state": digests["auto"]}


# the reference's decks the repo holds: (deck, the reference README's
# Reynolds number, as scripts/validate_all.py has it, the float64 plain
# reference's from rest or None, backends run through the CLI, whether
# goldens/ holds its final state).  128x256 has no golden: Re is its check,
# within 1% of the README's and 0.3% of portbench/reference/lbm.py's run
# from rest (decks/README.md)
REFERENCE_DECKS = (("256x256", 10.051412, None, ("auto",), True),
                   ("1024x1024", 3.375851, None, ("auto", "resident"), True),
                   ("128x256", 37.150040, 37.18484, ("auto", "resident"), False))
# Re's allowed gap from the float64 reference's run from rest
RE_FLOAT64_OFF = 0.003
# mass drift allowed per step: phase 5's 1e-4 over its 20 000 steps.  Near a
# steady state each step rounds the same values the same way, so float32
# drift grows with the steps: 1.231e-4 after the 256^2 deck's 80 000 on an
# H100, where the JAX package's fused backend drifts 1.339e-3 on the CPU
# (scripts/jax_mass_drift.py)
DRIFT_PER_STEP = 1e-4 / 20_000


def read_golden(deck: str) -> np.ndarray:
    """goldens/<deck>.final_state.dat.xz, decompressed with lzma and held
    to goldens/SHA256SUMS, as a float64 (N, 7) table."""
    import lzma

    from advanced_hpc_lbm_tpu_torch.utils import check

    path = ROOT / "goldens" / f"{deck}.final_state.dat.xz"
    with lzma.open(path, "rb") as fh:
        sha = hashlib.sha256(fh.read()).hexdigest()
    sums = dict(line.split()[::-1]
                for line in (ROOT / "goldens" / "SHA256SUMS").read_text().splitlines())
    if sha != sums.get(f"{deck}.final_state.dat"):
        fail(f"[5r reference] {path.name} decompresses to sha256 {sha}, not "
             f"goldens/SHA256SUMS's")
    return check.read_final_state(path)


def reference_spans(tag: str, rec, backend: str, ny: int, nx: int) -> dict:
    """A recorded CLI run of ``--backend backend``: the backend it ran, its
    resident loops' attributes and the final state's clipped lines, held to
    the rules they come from (the backend auto resolves to,
    ``resident.form_of`` and ``num_bands``, ``io.quirk_clipped_lines``)."""
    from advanced_hpc_lbm_tpu_torch.models import d2q9_bgk
    from advanced_hpc_lbm_tpu_torch.ops import resident
    from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io

    (run,) = rec.named("lbm.model.run")
    ran = run.attrs["backend"]
    out = {"backend": ran}
    if backend == "auto":
        want = "resident" if resident.takes_banded(ny, nx, "cuda") else d2q9_bgk.AUTO_BACKEND
        if ran != want:
            fail(f"{tag} lbm.model.run ran {ran}, auto's rule says {want}")
    loops = [sp.attrs for sp in rec.named("lbm.ops.loop")]
    if ran == "resident":
        want = {"form": resident.form_of(ny, nx, "cuda"), "bands": resident.num_bands(ny),
                "nx": nx, "ny": ny}
        got = [{k: a.get(k) for k in want} for a in loops]
        if got != [want]:
            fail(f"{tag} lbm.ops.loop carries {got}, expected [{want}]")
        out["loop"] = want
    (fs,) = rec.named("lbm.io.final_state")
    out["quirk_clipped"] = fs.attrs.get("quirk_clipped")
    if out["quirk_clipped"] != lbm_io.quirk_clipped_lines(ny, nx):
        fail(f"{tag} lbm.io.final_state quirk_clipped {out['quirk_clipped']}, the rule says "
             f"{lbm_io.quirk_clipped_lines(ny, nx)}")
    return out


def phase_reference(card: str) -> None:
    """The reference's 256^2, 1024^2 and 128x256 decks through the CLI,
    held to their goldens where the repo has them (final state at 1%) and
    to the reference's Reynolds numbers (within 1%)."""
    from advanced_hpc_lbm_tpu_torch.utils import check, profiling
    from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io

    rows = []
    for deck, want_re, float64_re, backends, has_golden in REFERENCE_DECKS:
        params_f = ROOT / "decks" / f"reference_{deck}.params"
        obst_f = ROOT / "decks" / f"reference_{deck}.obstacles.dat"
        params = lbm_io.load_params(params_f)
        ny, nx, iters = params.ny, params.nx, params.max_iters
        mass0 = rest_mass(params)
        histories, digests = {}, {}
        with tempfile.TemporaryDirectory() as tmp:
            for backend in backends:
                tag = f"[5r reference] {deck} --backend {backend}:"
                with final_state_writes() as writes, profiling.recording() as rec:
                    rc, lines, n = run_cli([str(params_f), str(obst_f), "--backend", backend,
                                            "--out-dir", tmp])
                if rc != 0:
                    fail(f"{tag} CLI exited {rc}")
                want = expected_launches(backend, ny, nx, iters)
                if n != want:
                    fail(f"{tag} launches {n}, expected {want}")
                block = check_block(lines, tag)
                port_codec_check(tag, writes)
                say(f"{tag} spans: {reference_spans(tag, rec, backend, ny, nx)} | {card}")
                av = lbm_io.read_av_vels(Path(tmp) / "av_vels.dat")
                if av.shape != (iters,) or not np.all(np.isfinite(av)) or not np.all(av > 0):
                    fail(f"{tag} av history is not finite and positive")
                histories[backend] = av
                f_host = writes[0]["args"][0]  # the collated state the writer got
                drift = abs(float(f_host.astype(np.float64).sum()) - mass0) / mass0
                if drift > DRIFT_PER_STEP * iters:
                    fail(f"{tag} total density drifted by {drift:.3e} (limit "
                         f"{DRIFT_PER_STEP * iters:.1e})")
                re_off = abs(block["reynolds"] - want_re) / want_re
                if re_off > 0.01:
                    fail(f"{tag} Reynolds number {block['reynolds']:.6E} is "
                         f"{100 * re_off:.4f}% off the reference's {want_re} (limit 1%)")
                f64 = ""
                if float64_re is not None:
                    f64_off = abs(block["reynolds"] - float64_re) / float64_re
                    f64 = (f", {100 * f64_off:.4f}% off the float64 reference's {float64_re} "
                           f"(limit {100 * RE_FLOAT64_OFF}%)")
                    if f64_off > RE_FLOAT64_OFF:
                        fail(f"{tag} Reynolds number {block['reynolds']:.6E}{f64}")
                digests[backend] = digest(Path(tmp) / "final_state.dat")
                if backend == "auto" and not has_golden:
                    fs_pcnt = None
                    rows.append(f"| {deck} | {block['reynolds']:.7g} | av: no golden | "
                                f"final state: no golden | none (Re only) | PASS |")
                elif backend == "auto":
                    golden = read_golden(deck)
                    table = check.read_final_state(Path(tmp) / "final_state.dat")
                    stats = check.check_final_state_only(golden, table)
                    if not stats.passed(1.0):
                        fail(f"{tag} final_state.dat fails the golden: max diff "
                             f"{stats.max_diff_pcnt:.4g}% at {stats.coord} (limit 1%)")
                    fs_pcnt = abs(stats.max_diff_pcnt)
                    # a difference that is the same in every fluid cell is one of mass
                    fluid = golden[:, 4] != 0
                    offset = 100 * np.mean(table[fluid, 5] / golden[fluid, 5] - 1)
                    say(f"{tag} pressure against the golden over the fluid cells: mean "
                        f"{offset:+.4f}%, max |diff| {fs_pcnt:.4f}% at {stats.coord}")
                    rows.append(f"| {deck} | {block['reynolds']:.7g} | av: no golden | "
                                f"{fs_pcnt:.4f} | regen | PASS |")
                elif digests[backend] != digests["auto"]:
                    fail(f"{tag} final_state.dat differs from auto's (sha256)")
                fs_said = ("no golden" if fs_pcnt is None else
                           f"max diff {fs_pcnt:.4f}% against goldens/{deck}")
                say(f"{tag} {iters} steps: launches { {a: b for a, b in n.items() if b} }, "
                    f"Compute {block['compute']:.4f} s = "
                    f"{iters * nx * ny / block['compute'] / 1e9:.3f} GLUPS, final state "
                    f"{fs_said} "
                    f"({'this file' if backend == 'auto' else 'equal to auto by sha256'}; "
                    f"limit 1%), Reynolds {block['reynolds']:.6E}, {100 * re_off:.4f}% off the "
                    f"reference's {want_re} (limit 1%){f64}, mass drift {drift:.3e} (limit "
                    f"{DRIFT_PER_STEP * iters:.1e}) "
                    f"| {card}")
        if len(histories) > 1:
            if not np.allclose(histories["auto"], histories["resident"], rtol=1e-5, atol=0.0):
                fail(f"[5r reference] {deck} auto's and resident's av histories differ "
                     "beyond rtol 1e-5")
            same = np.array_equal(histories["auto"], histories["resident"])
            say(f"[5r reference] {deck} auto and resident av "
                f"{'bitwise equal' if same else 'within rtol 1e-5'} | {card}")
    say("[5r reference] in PARITY.md's layout: | deck | Re | av max% | final-state max% "
        "| golden | verdict |")
    for row in rows:
        say(f"[5r reference] {row} ({card})")


def phase_mid(card: str) -> None:
    """A 512^2 deck (64 bands: the resident kernel's cooperative form, 2
    segments a band on an H100)
    through the CLI on resident and on pallas (the step kernel): exact
    launches, the ==done== block, a finite positive av history, the two
    runs' av histories compared."""
    from advanced_hpc_lbm_tpu_torch.ops import resident
    from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io

    n, iters = 512, 2000
    form = resident.form_of(n, n, "cuda")
    histories = {}
    with tempfile.TemporaryDirectory() as tmp:
        params_f, obst_f = write_full_deck(Path(tmp), n, n, iters)
        for backend in ("resident", "pallas"):
            tag = f"[5m mid] --backend {backend}:"
            rc, lines, counts = run_cli([str(params_f), str(obst_f), "--backend", backend,
                                         "--out-dir", tmp])
            if rc != 0:
                fail(f"{tag} CLI exited {rc}")
            want = expected_launches(backend, n, n, iters)
            if counts != want:
                fail(f"{tag} launches {counts}, expected {want}")
            block = check_block(lines, tag)
            av = lbm_io.read_av_vels(Path(tmp) / "av_vels.dat")
            if av.shape != (iters,) or not np.all(np.isfinite(av)) or not np.all(av > 0):
                fail(f"{tag} av history is not finite and positive")
            histories[backend] = av
            say(f"{tag} {n}x{n}, {iters} steps: launches "
                f"{ {a: b for a, b in counts.items() if b} }, Compute {block['compute']:.4f} s "
                f"= {iters * n * n / block['compute'] / 1e9:.3f} GLUPS | {card}")
    if not np.allclose(histories["resident"], histories["pallas"], rtol=1e-5, atol=0.0):
        fail("[5m mid] resident and pallas av histories differ beyond rtol 1e-5")
    same = bool(np.array_equal(histories["resident"], histories["pallas"]))
    say(f"[5m mid] resident ({form} form) and pallas av "
        f"{'bitwise equal' if same else 'within rtol 1e-5'} | {card}")


def digest(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while block := fh.read(1 << 24):
            h.update(block)
    return h.hexdigest()


@contextlib.contextmanager
def final_state_writes():
    """Record each ``io.write_final_state`` call inside the block: its
    arguments, its seconds, and the port codec's calls within it (path,
    seconds, threads) that wrote the file, none where the pure-Python path
    did."""
    from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io
    from advanced_hpc_lbm_tpu_torch.utils import native

    write, native_write = lbm_io.write_final_state, native.write_final_state
    calls: list[dict] = []

    def timed_write(path, *args, **kwargs):
        call = {"path": Path(path), "args": args, "kwargs": kwargs, "native": []}
        calls.append(call)
        t0 = time.perf_counter()
        write(path, *args, **kwargs)
        call["seconds"] = time.perf_counter() - t0

    def timed_native_write(path, *args, **kwargs):
        t0 = time.perf_counter()
        stats = native_write(path, *args, **kwargs)
        threads = kwargs.get("threads") or native.default_threads()
        calls[-1]["native"].append((Path(path), time.perf_counter() - t0, threads))
        return stats

    lbm_io.write_final_state, native.write_final_state = timed_write, timed_native_write
    try:
        yield calls
    finally:
        lbm_io.write_final_state, native.write_final_state = write, native_write


def port_codec_check(tag: str, calls: list[dict]) -> None:
    """Fail unless every recorded final_state.dat was written by the port's
    codec, a library built from the port's own csrc/fastio.c."""
    import advanced_hpc_lbm_tpu_torch
    from advanced_hpc_lbm_tpu_torch.utils import native

    for call in calls:
        if [Path(c[0]) for c in call["native"]] != [call["path"]]:
            fail(f"{tag} {call['path'].name} was not written by the native codec "
                 f"({call['native']})")
    src = Path(advanced_hpc_lbm_tpu_torch.__file__).resolve().parent / "csrc" / "fastio.c"
    lib = native._library()
    if (native.SRC != src or lib is None or Path(lib._name) != native.library_path()
            or not hasattr(lib, "lbm_write_final_state")):
        fail(f"{tag} the codec is not the port's own build of {src} "
             f"({native.SRC}, {lib and lib._name})")


def codec_line(call: dict, lines: int) -> str:
    """The write's time, rate and thread count, for a phase's line."""
    import os

    _, sec, threads = call["native"][0]
    size = call["path"].stat().st_size
    return (f"final_state.dat ({size / 1e9:.3f} GB, {lines} lines) written by the port's "
            f"codec in {sec:.3f} s = {size / sec / 1e9:.3f} GB/s on {threads} "
            f"thread{'s' if threads != 1 else ''} "
            f"(io.write_final_state {call['seconds']:.3f} s with the float32 planes; host: "
            f"{len(os.sched_getaffinity(0))} usable cores of {os.cpu_count()})")


def device_mass(f: torch.Tensor, rows: int = 1024) -> float:
    """Total density of a state on the card in float64, summed plane by
    plane and block of rows by block, so that the sum allocates no buffer
    of the state's size."""
    return sum(float(f[k, r:r + rows].double().sum().item())
               for k in range(f.shape[0]) for r in range(0, f.shape[1], rows))


def rest_mass(params) -> float:
    from advanced_hpc_lbm_tpu_torch.ops import reference

    return float(np.float64(reference.rest_populations(params)).sum()) * params.ny * params.nx


def phase_big(card: str, label: str, n: int, backends: tuple[str, str]) -> None:
    """A n x n deck for 2000 steps through Simulation with two backends:
    finite, mass conserved, the same state bit for bit, GLUPS of both."""
    from advanced_hpc_lbm_tpu_torch import Simulation

    nx = ny = n
    iters = 2000
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        params_f, obst_f = write_full_deck(Path(tmp), nx, ny, iters)
        for backend in backends:
            sim = Simulation.from_decks(params_f, obst_f, backend=backend, device="cuda")
            sim.warmup()
            counts: dict = {}
            with counted(counts):
                t0 = time.perf_counter()
                res = sim.run(fetch=False)  # waits for the device
                dt = time.perf_counter() - t0
            want = expected_launches(backend, ny, nx, iters)
            if counts != want:
                fail(f"[{label}] {backend}: launches {counts}, expected {want}")
            f = res.f_final
            if not bool(torch.isfinite(f).all().item()) or not bool(
                    torch.isfinite(res.av_vels).all().item()):
                fail(f"[{label}] {backend}: non-finite result")
            mass0 = rest_mass(sim.params)
            drift = abs(device_mass(f) - mass0) / mass0
            if drift > 1e-4:
                fail(f"[{label}] {backend}: total density drifted by {drift:.3e} (limit 1e-4)")
            runs[backend] = res
            say(f"[{label}] {ny}x{nx}, {iters} steps, --backend {backend}"
                + (f" (K={sim._k()})" if backend == "pallask" else "")
                + f": launches {counts}, {dt:.4f} s = {iters * nx * ny / dt / 1e9:.3f} GLUPS "
                f"(host clock, run synchronised), mass drift {drift:.3e} (limit 1e-4) | {card}")
    a, b = (runs[name] for name in backends)
    tag = f"[{label}] {ny}x{nx} {backends[0]} vs {backends[1]}"
    say(f"{tag}: {check_against(tag, a.f_final, a.av_vels, b.f_final, b.av_vels, backends[1] + ' backend', True)}")


def phase_cli_big(card: str) -> None:
    """The 4096^2 deck through the CLI on stream; final_state.dat must be
    written by the port's codec, and its write is timed at the default
    thread count and again at 1 thread, the two files equal by sha256."""
    from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io

    nx = ny = 4096
    iters = 2000
    tag = "[5b cli big] --backend stream:"
    with tempfile.TemporaryDirectory() as tmp:
        params_f, obst_f = write_full_deck(Path(tmp), nx, ny, iters)
        with final_state_writes() as writes:
            rc, lines, n = run_cli([str(params_f), str(obst_f), "--backend", "stream",
                                    "--out-dir", tmp])
        if rc != 0:
            fail(f"{tag} CLI exited {rc}")
        port_codec_check(tag, writes)
        fs = Path(tmp) / "final_state.dat"
        with open(fs, "rb") as fh:
            fh.seek(fs.stat().st_size - 200)
            last = fh.read().decode().splitlines()[-1].split()
        av = lbm_io.read_av_vels(Path(tmp) / "av_vels.dat")
        default = writes[0]
        with final_state_writes() as again:
            lbm_io.write_final_state(Path(tmp) / "final_state_1t.dat", *default["args"],
                                     **{**default["kwargs"], "threads": 1})
        port_codec_check(tag, again)
        one = again[0]
        same = digest(fs) == digest(one["path"])
        default_line, one_line = codec_line(default, nx * ny), codec_line(one, nx * ny)
    want = expected_launches("stream", ny, nx, iters)
    if n != want:
        fail(f"{tag} launches {n}, expected {want}")
    block = check_block(lines, tag)
    if last[:2] != [str(nx - 1), str(ny - 1)] or len(last) != 7:
        fail(f"{tag} final_state.dat does not end with cell ({nx - 1}, {ny - 1}): {last}")
    if av.shape != (iters,) or not np.all(np.isfinite(av)) or not np.all(av > 0):
        fail(f"{tag} av history is not finite and positive")
    if not same:
        fail(f"{tag} final_state.dat at {default['native'][0][2]} threads and at 1 thread "
             f"differ (sha256)")
    for line in lines:
        say(f"{tag} | {line}")
    say(f"{tag} {ny}x{nx}, {iters} steps: launches {n}, Compute {block['compute']:.4f} s = "
        f"{iters * nx * ny / block['compute'] / 1e9:.3f} GLUPS | {card}")
    say(f"{tag} default threads: {default_line} | {card}")
    say(f"{tag} 1 thread: {one_line}; equal to the default's by sha256 | {card}")


def phase_capacity(card: str) -> None:
    """A grid whose two states exceed 0.9 of the card: auto runs the
    in-place stream tier, and pallask is refused before it allocates."""
    from advanced_hpc_lbm_tpu_torch import LBMParams, Simulation
    from advanced_hpc_lbm_tpu_torch.models import d2q9_bgk
    from advanced_hpc_lbm_tpu_torch.ops import stream_kernel
    from advanced_hpc_lbm_tpu_torch.utils import profiling

    n, iters = 36864, 64
    tag = f"[7 capacity] {n}x{n}, {iters} steps:"
    params = LBMParams(nx=n, ny=n, max_iters=iters, reynolds_dim=10,
                       density=0.1, accel=0.01, omega=1.85)
    obst = np.zeros((n, n), dtype=bool)  # write_full_deck's geometry, in memory
    obst[0] = obst[-1] = True
    obst[:, 0] = obst[:, -1] = True
    obst[: n // 2, n // 3] = True
    torch.cuda.empty_cache()
    mem = d2q9_bgk._device_memory_bytes("cuda")
    state = 4 * 9 * n * n
    sim = Simulation(params, obst, backend="auto", device="cuda")
    if sim.backend != "stream":
        fail(f"{tag} auto picked {sim.backend}, expected stream")
    refused = Simulation(params, obst, backend="pallask", device="cuda")
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        refused.warmup()
    except ValueError as e:
        message = str(e)
    else:
        fail(f"{tag} the gate let pallask run")
    if torch.cuda.max_memory_allocated() > before + 2**20:
        fail(f"{tag} pallask allocated before the gate refused it")
    sim.warmup()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    counts: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        with counted(counts), profiling.trace(tmp) as tr:
            t0 = time.perf_counter()
            res = sim.run(fetch=False)
            dt = time.perf_counter() - t0
        summary = trace_check(tag, tr.path, counts)
        first_port = min(summary["kernels"][name][2] for name in set(TRACE_NAMES.values())
                         if name in summary["kernels"])
        set_up = host_ops_before(tr.path, first_port)
    peak = torch.cuda.max_memory_allocated() - before
    tier = stream_kernel.tier_bytes(n, n)
    want = expected_launches("stream", n, n, iters)
    if counts != want:
        fail(f"{tag} launches {counts}, expected {want}")
    if peak > tier or peak > 1.25 * state + 2 * n * n:
        fail(f"{tag} peak device memory {peak} B exceeds tier_bytes {tier} B "
             f"or 1.25 x state + masks")
    f, av = res.f_final, res.av_vels
    if not all(bool(torch.isfinite(f[k]).all().item()) for k in range(9)) or not bool(
            torch.isfinite(av).all().item()):
        fail(f"{tag} non-finite result")
    mass0 = rest_mass(params)
    drift = abs(device_mass(f) - mass0) / mass0
    if drift > 1e-4:
        fail(f"{tag} total density drifted by {drift:.3e} (limit 1e-4)")
    say(f"{tag} card {mem / 1e9:.2f} GB, one state {state / 1e9:.2f} GB; auto picked "
        f"stream; pallask refused before allocating: \"{message}\"")
    say(f"{tag} launches {counts}, {dt:.4f} s = {iters * n * n / dt / 1e9:.3f} GLUPS (host "
        f"clock, run synchronised, in-place tier), peak allocated {peak / 1e9:.3f} GB "
        f"against tier_bytes {tier / 1e9:.3f} GB ({peak / state:.4f} of a state), mass drift "
        f"{drift:.3e} (limit 1e-4) | {card}")
    say(f"{tag} profiled: window {summary['window_us'] / 1e6:.4f} s, host set-up before the "
        f"first device activity {summary['first_device_us'] / 1e6:.4f} s and before the first "
        f"port kernel {first_port / 1e6:.4f} s (the host's longest operators there: "
        f"{set_up}), device busy {summary['busy_us'] / 1e6:.4f} s "
        f"({summary['busy_share']:.4f} of the window); by device time: "
        f"{top_kernels(summary)} | {card}")
    del res, f, av, sim
    torch.cuda.empty_cache()


def bound(cells: int, steps_per_launch: int) -> tuple[float, str]:
    """(ms per step, bound_by): the least time of one step of the kernel on
    an H100, the larger of its bytes over the memory rate (each input read
    once and each output written once per launch) and its operations over
    the float32 rate."""
    t_bytes = CELL_BYTES * cells / steps_per_launch / HBM_BYTES_PER_S
    t_ops = FLOPS_PER_CELL_STEP * cells / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---- 3l. the local kernels of the sharded path ----------------------------------

def window_case(h: int, w: int, seed: int, accel_rows: tuple[int, ...],
                ghosts: tuple[int, int] = (0, 0)):
    """A seeded (9, h, w) shard window on the card and its encoded mask
    window, forced on ``accel_rows`` (window rows), where W is starved on
    half of each forced row so that the guard fails there; the outer
    ``ghosts`` (rows, columns) of the mask +4, as the runner marks a
    stream window's ghost cells."""
    from advanced_hpc_lbm_tpu_torch.ops import stream_kernel as sk

    params, mask_np, f0 = seeded_case(h, w, seed)
    for r in accel_rows:
        f0[3, r, : w // 2] = params.accel_w1 * np.float32(0.5)
    accel = np.zeros(h, dtype=bool)
    accel[list(accel_rows)] = True
    enc = sk.encode_masks(torch.from_numpy(mask_np), torch.from_numpy(accel)).cuda()
    return params, torch.from_numpy(f0).cuda(), ghost_excluded(enc, *ghosts)


def ghost_excluded(enc: torch.Tensor, gy: int, gx: int) -> torch.Tensor:
    """``enc`` with +4 on its outer gy rows and gx columns."""
    from advanced_hpc_lbm_tpu_torch.ops import stream_kernel as sk

    if not (gy or gx):
        return enc
    h, w = enc.shape
    ghost = torch.ones(h, w, dtype=torch.bool, device=enc.device)
    ghost[gy:h - gy, gx:w - gx] = False
    return sk.mark_reduction_excluded(enc, ghost)


def device_window_case(h: int, w: int, seed: int, accel_rows: tuple[int, ...],
                       ghosts: tuple[int, int] = (0, 0)):
    """:func:`window_case` made on the card from a seeded CUDA generator,
    for windows too large to build on the host: the rest state x
    uniform(0.8, 1.2) plane by plane, the box rows, a block and h*w/2000
    random obstacles."""
    from advanced_hpc_lbm_tpu_torch.ops import reference
    from advanced_hpc_lbm_tpu_torch.ops import stream_kernel as sk
    from advanced_hpc_lbm_tpu_torch.params import LBMParams

    params = LBMParams(nx=w, ny=h, max_iters=50, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    win = torch.empty(9, h, w, device="cuda")
    for k, rest in enumerate(reference.rest_populations(params)):
        win[k].uniform_(0.8, 1.2, generator=gen).mul_(float(rest))
    for r in accel_rows:
        win[3, r, : w // 2] = float(params.accel_w1 * np.float32(0.5))
    obst = torch.zeros(h, w, dtype=torch.uint8, device="cuda")
    obst[0] = obst[-1] = 1
    obst[h // 2: h // 2 + 2, w // 3: w // 2] = 1
    obst.view(-1)[torch.randint(0, h * w, (h * w // 2000,), generator=gen,
                                device="cuda")] = 1
    accel = torch.zeros(h, dtype=torch.bool, device="cuda")
    accel[list(accel_rows)] = True
    return params, win, ghost_excluded(sk.encode_masks(obst, accel), *ghosts)


def local_ghosts(kind: str, k: int) -> tuple[int, int]:
    """(rows, columns) of a kind's window on each side of the own block."""
    return {"1d": (1, 0), "2d": (1, 1), "ca": (k, 0), "stream": (k, 0),
            "stream2d": (k, k)}[kind]


def local_launch(kind: str, k: int, params, win, enc, plain: bool = False):
    """(run, own block of out, partials) of one launch on a window of a
    local kernel (``kind`` "1d", "2d" or "ca"), of the stream kernel on a
    ring or torus shard's window ("stream", "stream2d": out of place into a
    tensor shaped like the window, whose own block is the shard's next
    state) or of its plain version."""
    from advanced_hpc_lbm_tpu_torch.ops import local_kernel as lk
    from advanced_hpc_lbm_tpu_torch.ops import stream_kernel as sk

    _, h, w = win.shape
    gy, gx = local_ghosts(kind, k)
    if kind.startswith("stream"):
        out = torch.empty_like(win)
        part = torch.empty(k, sk.num_tiles(h, w), device=win.device)
        fn = (sk.plain_multi_step if plain else
              sk.window_ca_steps_2d if kind == "stream2d" else sk.window_ca_steps)
        return ((lambda: fn(win, enc, params, out=out, partials=part)),
                out[:, gy:h - gy, gx:w - gx], part)
    ly, lx = h - 2 * gy, w - 2 * gx
    if kind == "ca":
        part = torch.empty(k, lk.num_tiles(ly, lx), device=win.device)
    else:
        part = torch.empty(lk.num_partials(ly, lx), device=win.device)
    out = torch.empty(9, ly, lx, device=win.device)
    if kind == "ca":
        fn = lk.plain_local_ca_steps if plain else lk.local_ca_steps
        return (lambda: fn(win, enc, params, k, out=out, partials=part)), out, part
    if plain:
        return (lambda: lk.plain_local_step(win, enc, params, out=out, partials=part,
                                            torus=kind == "2d")), out, part
    fn = lk.local_step_2d if kind == "2d" else lk.local_step
    return (lambda: fn(win, enc, params, out=out, partials=part)), out, part


# (kind, K, own rows, own columns, forced window rows, what the case holds)
LOCAL_CASES = (
    ("1d", 1, 2, 64, (3,), "ly = 2, the bottom halo row is row ny-2"),
    ("1d", 1, 17, 23, (0,), "17x23, the top halo row forced"),
    ("1d", 1, 64, 64, (63,), "the mini deck's shard, an own row forced"),
    ("1d", 1, 2048, 8192, (2047,), "an 8192^2 ring shard of 4"),
    ("2d", 1, 2, 3, (3,), "2x3 block, the bottom halo row forced across the halo columns"),
    ("2d", 1, 17, 23, (1,), "17x23 block"),
    ("2d", 1, 64, 64, (0, 64), "both halo rows forced"),
    ("2d", 1, 4096, 4096, (4095,), "an 8192^2 torus shard of 2x2"),
    ("ca", 2, 4, 64, (1, 5), "K = 2, forcing row twice: ghost and own"),
    ("ca", 3, 16, 100, (7,), "K = 3"),
    ("ca", 4, 2048, 8192, (2049,), "K = 4, an 8192^2 ring shard of 4"),
    ("ca", 8, 17, 23, (1, 20), "K = 8, 17x23, forcing row twice"),
    ("ca", 5, 40, 130, (43,), "K = 5, a ragged tile"),
    ("ca", 6, 2, 64, (1, 13), "K = 6, ly = 2, forcing row twice"),
    ("ca", 7, 33, 96, (2, 40), "K = 7, forcing row twice"),
    # the shards of the mini, 1024^2 and 8192^2 decks on meshes of 2 and 4
    # (phases 8, 12 and 14: a card each, or one card)
    ("1d", 1, 32, 64, (32,), "the mini deck's ring shard of 2"),
    ("1d", 1, 16, 64, (16,), "the mini deck's ring shard of 4"),
    ("ca", 4, 32, 64, (35,), "K = 4, the mini deck's ring shard of 2"),
    ("ca", 4, 16, 64, (19,), "K = 4, the mini deck's ring shard of 4"),
    ("stream", 8, 32, 64, (39,), "the mini deck's ring shard of 2"),
    ("stream", 8, 16, 64, (23, 30), "the mini deck's ring shard of 4, forcing row twice"),
    ("1d", 1, 512, 1024, (512,), "a 1024^2 ring shard of 2"),
    ("1d", 1, 256, 1024, (256,), "a 1024^2 ring shard of 4"),
    ("2d", 1, 512, 512, (512,), "a 1024^2 torus shard of 2x2"),
    ("2d", 1, 512, 1024, (512,), "a 1024^2 torus shard of 2x1"),
    ("1d", 1, 4096, 8192, (4096,), "an 8192^2 ring shard of 2"),
    ("ca", 4, 4096, 8192, (4099,), "K = 4, an 8192^2 ring shard of 2"),
    ("stream", 8, 4096, 8192, (4103,), "an 8192^2 ring shard of 2"),
    ("stream", 8, 2048, 8192, (2055,), "an 8192^2 ring shard of 4"),
    ("stream2d", 8, 4096, 4096, (4103,), "an 8192^2 torus shard of 2x2"),
)

# (own rows, own columns, (kind, K) ...): a 49152^2 ring shard of 4 cards
# (phase 14), whose windows hold more than 2^32 values: built on the card
# and held to the plain version by blocks of HUGE_ROWS own rows
LOCAL_HUGE = (12288, 49152, (("1d", 1), ("ca", 4), ("stream", 8)))
HUGE_ROWS = 1024

# the main path's shard shape of each kind, timed
LOCAL_TIMED = {"1d": (1, 2048, 8192), "2d": (1, 4096, 4096), "ca": (4, 2048, 8192)}


def local_bound(kind: str, k: int, ly: int, lx: int) -> tuple[float, str]:
    """(ms per step, bound_by) of a local kernel's launch on a (ly, lx)
    shard: each input read once (window, mask), each output written once;
    operations FLOPS_PER_CELL_STEP per own cell and step."""
    if kind == "ca":
        bytes_ = (9 * 4 + 1) * (ly + 2 * k) * lx + 9 * 4 * ly * lx
    else:
        h, w = ly + 2, (lx + 2 if kind == "2d" else lx)
        bytes_ = (9 * 4 + 1) * h * w + 9 * 4 * ly * lx
    t_bytes = bytes_ / HBM_BYTES_PER_S / k
    t_ops = FLOPS_PER_CELL_STEP * ly * lx / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def held_to_plain(tag: str, fk, fp, sk_sum, sp_sum) -> tuple[float, int]:
    """Fail unless a kernel's output ``fk`` is finite and within rtol/atol
    of the plain version's ``fp`` and its ||u|| sums per step within
    AV_RTOL; returns (max |df|, values that differ)."""
    df, n_diff = diff_line(fk, fp)
    if not bool(torch.isfinite(fk).all().item()):
        fail(f"{tag}: non-finite output")
    if not torch.allclose(fk, fp, rtol=F_RTOL, atol=F_ATOL):
        fail(f"{tag}: f differs from the plain version beyond rtol {F_RTOL} atol {F_ATOL}")
    if sk_sum is not None and not torch.allclose(sk_sum, sp_sum, rtol=AV_RTOL, atol=0.0):
        fail(f"{tag}: ||u|| sums differ from the plain version beyond rtol {AV_RTOL}")
    return df, n_diff


def step_sums(kind: str, k: int, part: torch.Tensor) -> torch.Tensor:
    """The ||u|| sum of each step of a launch's partials."""
    return part.reshape(k if kind in ("ca", "stream", "stream2d") else 1, -1).sum(1)


def huge_local(card: str, worst: dict) -> None:
    """LOCAL_HUGE: each kernel once on the whole window, its plain version
    on windows of HUGE_ROWS own rows (the rows they pull from are all in
    the slice, so their own rows are exact; a stream slice's outer K rows
    +4, so that its sums count its own rows only), compared block by
    block on the card."""
    ly, lx, kinds = LOCAL_HUGE
    torch.cuda.empty_cache()  # what earlier phases left cached
    for seed, (kind, k) in enumerate(kinds):
        g, _ = local_ghosts(kind, k)
        h = ly + 2 * g
        params, win, enc = device_window_case(h, lx, 900 + seed, (ly - 2 + g,), (g, 0)
                                              if kind == "stream" else (0, 0))
        run_k, fk, pk = local_launch(kind, k, params, win, enc)
        run_k()
        torch.cuda.synchronize()
        tag = (f"[3l local] {kind} K={k} {ly}x{lx} (a 49152^2 ring shard of 4 cards, a window "
               f"of {9 * h * lx} values = {9 * h * lx / 2**32:.3f} x 2^32, the plain version "
               f"by blocks of {HUGE_ROWS} rows)")
        sk_sum = step_sums(kind, k, pk)
        sp_sum = torch.zeros_like(sk_sum)
        df, n_diff = 0.0, 0
        for a in range(0, ly, HUGE_ROWS):
            b = min(a + HUGE_ROWS, ly)
            sub_enc = ghost_excluded(enc[a:b + 2 * g], g, 0) if kind == "stream" else \
                enc[a:b + 2 * g]
            run_p, fp, pp = local_launch(kind, k, params, win[:, a:b + 2 * g], sub_enc,
                                         plain=True)
            run_p()
            d, n = held_to_plain(f"{tag}, own rows {a}-{b}", fk[:, a:b], fp, None, None)
            df, n_diff = max(df, d), n_diff + n
            sp_sum += step_sums(kind, k, pp)
            del fp, pp, run_p
        if not torch.allclose(sk_sum, sp_sum, rtol=AV_RTOL, atol=0.0):
            fail(f"{tag}: ||u|| sums differ from the plain version beyond rtol {AV_RTOL}")
        dsum = ((sk_sum - sp_sum).abs() / sp_sum.abs()).max().item()
        worst[kind] = max(worst[kind], df)
        say(f"{tag}: {n_diff} of {fk.numel()} values differ from the plain version, max|df| "
            f"{df:.3e}, max rel d(||u|| sum) {dsum:.3e} | {card}")
        del win, enc, fk, pk, run_k
        torch.cuda.empty_cache()


def phase_local(card: str) -> tuple[dict, dict]:
    """Each local kernel, and the stream kernel on a shard's window, against
    its plain version; returns (worst max |df| per kind, (kernel ms, plain
    ms) per step per kind of the main path)."""
    worst = {"1d": 0.0, "2d": 0.0, "ca": 0.0, "stream": 0.0, "stream2d": 0.0}
    for seed, (kind, k, ly, lx, rows, what) in enumerate(LOCAL_CASES):
        gy, gx = local_ghosts(kind, k)
        params, win, enc = window_case(ly + 2 * gy, lx + 2 * gx, 700 + seed, rows,
                                       (gy, gx) if kind.startswith("stream") else (0, 0))
        run_k, fk, pk = local_launch(kind, k, params, win, enc)
        run_p, fp, pp = local_launch(kind, k, params, win, enc, plain=True)
        run_k()
        run_p()
        torch.cuda.synchronize()
        tag = f"[3l local] {kind} K={k} {ly}x{lx} ({what})"
        sk_sum, sp_sum = step_sums(kind, k, pk), step_sums(kind, k, pp)
        df, n_diff = held_to_plain(tag, fk, fp, sk_sum, sp_sum)
        worst[kind] = max(worst[kind], df)
        dsum = ((sk_sum - sp_sum).abs() / sp_sum.abs()).max().item()
        say(f"{tag}: {n_diff} of {fk.numel()} values differ from the plain version, "
            f"max|df| {df:.3e}, max rel d(||u|| sum) {dsum:.3e}")
        del win, enc, fk, fp
    huge_local(card, worst)
    times = {}
    for seed, (kind, (k, ly, lx)) in enumerate(LOCAL_TIMED.items()):
        g = k if kind == "ca" else 1
        params, win, enc = window_case(ly + 2 * g, lx + 2 if kind == "2d" else lx,
                                       800 + seed, (ly,))
        k_ms = time_ms(local_launch(kind, k, params, win, enc)[0], 50) / k
        p_ms = time_ms(local_launch(kind, k, params, win, enc, plain=True)[0], 3) / k
        b_ms, b_by = local_bound(kind, k, ly, lx)
        times[kind] = (k_ms, p_ms)
        say(f"[3l local] {kind} K={k} {ly}x{lx} time per step: kernel {k_ms * 1e3:.2f} us "
            f"({ly * lx / k_ms / 1e6:.3f} GLUPS), plain {p_ms * 1e3:.2f} us, bound "
            f"{b_ms * 1e3:.2f} us ({b_by}) | {card}")
        del win, enc
    return worst, times


# ---- timing of the sharded runs (phases 8, 12 and 14) ------------------------------

WARM_STEPS = 8  # the untimed run before each timed library run: a pass of stream
EXCHANGE_REPEAT = 200  # exchanges timed alone, for the ratio to a step


def timed_run(sim, counts: dict | None = None, **kw):
    """``sim.warmup(**kw)``, an untimed run of WARM_STEPS steps (first-touch
    allocations, NCCL's first messages), then the run of ``kw`` on the host
    clock, synchronised, its launches counted into ``counts``: (result,
    seconds).  Every timed library run of phases 8, 12 and 14 takes this
    rule, so that any two of them compare alike."""
    sim.warmup(**kw)
    sim.run(fetch=False, **{**kw, "n_iters": WARM_STEPS})
    with counted(counts) if counts is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        res = sim.run(fetch=False, **kw)
        dt = time.perf_counter() - t0
    return res, dt


def pallask_us(params_f, obst_f, iters: int) -> float:
    """us per step of single-device pallask on a deck (:func:`timed_run`)."""
    from advanced_hpc_lbm_tpu_torch import Simulation

    sim = Simulation.from_decks(params_f, obst_f, backend="pallask", device="cuda")
    _, dt = timed_run(sim, n_iters=iters)
    return dt / iters * 1e6


def sync_cards() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def exchange_us(mesh, ny: int, nx: int, g: int, repeat: int = EXCHANGE_REPEAT) -> float:
    """us per halo exchange of a run's windows (g ghost rows) on ``mesh``,
    the exchange alone: host clock, every card synchronised.  The windows
    are left as allocated: the copies move whatever they hold.  Its ratio
    to a step's time is that of two measurements, not a share traced
    inside one run."""
    from advanced_hpc_lbm_tpu_torch.parallel import halo

    win = halo._Windows(mesh, ny, nx, g)
    for b in range(4):
        win.exchange(b % 2)
    sync_cards()
    t0 = time.perf_counter()
    for t in range(repeat):
        win.exchange(t % 2)
    sync_cards()
    return (time.perf_counter() - t0) / repeat * 1e6


# ---- 8. the sharded path ----------------------------------------------------------

def sharded_expected(kernel: str, shards: int, torus: bool, iters: int, k: int = 1) -> dict:
    """Launches per kernel of a sharded run of ``iters`` steps."""
    from advanced_hpc_lbm_tpu_torch.ops import stream_kernel

    want = dict.fromkeys(kernel_counters(), 0)
    one = "local2d_kernel" if torus else "local_kernel"
    if kernel == "stream":
        passes, tail = divmod(iters, stream_kernel.K)
        want["stream_kernel"] = want["stream_snapshot"] = passes * shards
        want[one] = tail * shards
    elif k > 1:
        passes, tail = divmod(iters, k)
        want["local_ca_kernel"], want[one] = passes * shards, tail * shards
    else:
        want[one] = iters * shards
    return want


def phase_sharded_mini(card: str) -> None:
    """decks/mini_64x64 through the CLI on --backend sharded, a ring of the
    visible cards, against the golden; on 2 or more cards also against
    the same mesh laid on cuda:0 alone (0 differing values in both output
    files), timed beside it and single-device pallask."""
    from advanced_hpc_lbm_tpu_torch.utils import check

    decks = ROOT / "decks"
    mini = [str(decks / "mini_64x64.params"), str(decks / "mini_64x64.obstacles.dat")]
    n, iters = torch.cuda.device_count(), 500
    p_us = pallask_us(*mini, iters) if n >= 2 else None
    for flags, kw, kernel, k in MP_MINI:
        flags = ["--backend", "sharded", *flags]
        tag = f"[8 sharded mini] {' '.join(flags)}:"
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "cards"
            out.mkdir()
            rc, lines, counts = run_cli([*mini, *flags, "--out-dir", str(out)])
            if rc != 0:
                fail(f"{tag} CLI exited {rc}")
            want = sharded_expected(kernel, n, False, iters, k)
            if counts != want:
                fail(f"{tag} launches {counts}, expected {want}")
            block = check_block(lines, tag)
            stats = check.check_av_vels_only(
                str(decks / "mini_64x64.golden_av_vels.dat"), str(out / "av_vels.dat"))
            if not stats.passed(1.0):
                fail(f"{tag} av_vels fail the golden: {stats.max_diff_pcnt:.4g}%")
            same = ""
            if n >= 2:
                dt_one, _ = one_process(*mini, Path(tmp) / "one", iters, {"devices": n, **kw}, n)
                same_outputs(tag, out, Path(tmp) / "one")
                same = (f"; 0 values of final_state.dat and av_vels.dat differ from the same "
                        f"mesh on cuda:0; {block['compute'] / iters * 1e6:.2f} us per step "
                        f"(Compute), the mesh on cuda:0 {dt_one / iters * 1e6:.2f}, "
                        f"single-device pallask {p_us:.2f} | {card}")
        say(f"{tag} 64x64, {iters} steps on {n} card(s), one shard each: launches "
            f"{ {a: b for a, b in counts.items() if b} }, Reynolds {block['reynolds']:.6E}, golden "
            f"max diff {stats.max_diff_pcnt:.4g}% (limit 1%), Compute {block['compute']:.4f} s"
            + same)


def phase_sharded_full(card: str) -> None:
    """The 1024^2 deck of phase 5 on --backend sharded, a ring of the
    visible cards, through the CLI (the same output files as auto's) and
    the library (the same state as auto's, 0 differing values); on 2 or
    more cards the CLI run also against the same mesh laid on cuda:0 alone,
    timed beside it and auto, with the exchange timed alone."""
    from advanced_hpc_lbm_tpu_torch import Simulation
    from advanced_hpc_lbm_tpu_torch.parallel import mesh
    from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io

    nx = ny = 1024
    n_cards = torch.cuda.device_count()
    iters = 20_000
    tag = "[8 sharded full] --backend sharded:"
    with tempfile.TemporaryDirectory() as tmp:
        params_f, obst_f = write_full_deck(Path(tmp), nx, ny, iters)
        outs = {}
        for backend in ("auto", "sharded"):
            d = Path(tmp) / backend
            d.mkdir()
            rc, lines, n = run_cli([str(params_f), str(obst_f), "--backend", backend,
                                    "--out-dir", str(d)])
            if rc != 0:
                fail(f"{tag} CLI --backend {backend} exited {rc}")
            outs[backend] = (n, check_block(lines, tag), d)
        n, block, d = outs["sharded"]
        want = sharded_expected("pallas", torch.cuda.device_count(), False, iters)
        if n != want:
            fail(f"{tag} launches {n}, expected {want}")
        if (d / "final_state.dat").read_bytes() != (
                outs["auto"][2] / "final_state.dat").read_bytes():
            fail(f"{tag} final_state.dat differs from --backend auto's")
        av_s, av_a = (lbm_io.read_av_vels(outs[b][2] / "av_vels.dat") for b in ("sharded", "auto"))
        if not np.allclose(av_s, av_a, rtol=AV_RTOL, atol=0.0):
            fail(f"{tag} av_vels.dat differs from --backend auto's beyond rtol {AV_RTOL}")
        across = ""
        if n_cards >= 2:
            dt_one, _ = one_process(params_f, obst_f, Path(tmp) / "one", iters,
                                    {"devices": n_cards, "shard_kernel": "pallas"}, n_cards)
            same_outputs(tag, d, Path(tmp) / "one")
            step_us, one_us = block["compute"] / iters * 1e6, dt_one / iters * 1e6
            ex = exchange_us(mesh.make_y_mesh(n_cards), ny, nx, 1)
            across = (f"; 0 values of final_state.dat and av_vels.dat differ from the same mesh "
                      f"on cuda:0; {step_us:.2f} us per step (Compute) against {one_us:.2f} for "
                      f"the mesh on cuda:0 and {outs['auto'][1]['compute'] / iters * 1e6:.2f} "
                      f"for auto (Compute); the exchange timed alone {ex:.2f} us, "
                      f"{ex / step_us:.2f} of a step")
        ref = Simulation.from_decks(params_f, obst_f, device="cuda").run(fetch=False)
        sim = Simulation.from_decks(params_f, obst_f, backend="sharded", device="cuda")
        sim.warmup()
        counts: dict = {}
        with counted(counts):
            res = sim.run(fetch=False)
    diffs = sum(int((blk != ref.f_final[:, rows, cols].to(blk.device)).sum().item())
                for rows, cols, blk in res.f_final.blocks())
    if diffs or counts != want:
        fail(f"{tag} library run: {diffs} values differ from auto's state, launches {counts}")
    if not torch.allclose(res.av_vels, ref.av_vels, rtol=AV_RTOL, atol=0.0):
        fail(f"{tag} library av differs from auto's beyond rtol {AV_RTOL}")
    say(f"{tag} {ny}x{nx}, {iters} steps on {torch.cuda.device_count()} card(s), one shard "
        f"each: launches "
        f"{ {a: b for a, b in n.items() if b} }, final_state.dat equal to auto's, av_vels.dat "
        f"within rtol {AV_RTOL}, "
        f"Compute {block['compute']:.4f} s = {iters * nx * ny / block['compute'] / 1e9:.3f} "
        f"GLUPS (auto: {outs['auto'][1]['compute']:.4f} s); library run: 0 of "
        f"{ref.f_final.numel()} values differ from auto's state{across} | {card}")


SHARDED_BIG = (  # (label, run keywords, kernel, K)
    ("ring pallas", {"devices": 4, "shard_kernel": "pallas"}, "pallas", 1),
    ("ring pallas K=4", {"devices": 4, "shard_kernel": "pallas", "ca_steps": 4}, "pallas", 4),
    ("ring stream", {"devices": 4, "shard_kernel": "stream"}, "stream", 8),
    ("2x2 torus pallas", {"mesh": (2, 2), "shard_kernel": "pallas"}, "pallas", 1),
    ("2x2 torus stream", {"mesh": (2, 2), "shard_kernel": "stream"}, "stream", 8),
)


def phase_sharded_big(card: str) -> None:
    """An 8192^2 deck for 200 steps on SHARDED_BIG's configurations, on 4
    shards of the card and, where 2 or more cards are visible, across
    them (a ring of the cards, one shard each, and the same ring laid on
    cuda:0 alone; the tori on 4 cards), each against single-device
    pallask (0 differing values, av within rtol, exact launches, mass
    conserved); the cards' av equal to the same mesh's on cuda:0."""
    from advanced_hpc_lbm_tpu_torch import Simulation
    from advanced_hpc_lbm_tpu_torch.parallel import mesh

    n, iters = 8192, 200
    n_cards = torch.cuda.device_count()
    cuda0 = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        params_f, obst_f = write_full_deck(Path(tmp), n, n, iters)
        ref_sim = Simulation.from_decks(params_f, obst_f, backend="pallask", device="cuda")
        ref, dt = timed_run(ref_sim)
        p_us = dt / iters * 1e6
        mass0 = rest_mass(ref_sim.params)
        for label, kw, kernel, k in SHARDED_BIG:
            torus = "mesh" in kw
            places = [(kw, [cuda0] * 4)]  # (run keywords, shard devices; None: the cards)
            if n_cards >= 2 and (not torus or n_cards >= 4):
                kw_n = kw if torus else {**kw, "devices": n_cards}
                if not torus and n_cards != 4:
                    places.append((kw_n, [cuda0] * n_cards))
                places.append((kw_n, None))
            on_one = {}  # shards -> (av, us per step) of the mesh on cuda:0
            for run_kw, devs in places:
                shards = len(devs) if devs else (4 if torus else n_cards)
                where = (f"{shards} shards of one card" if devs else
                         f"{shards} cards, one shard each")
                tag = f"[8 sharded big] {n}x{n} {label}, {where}:"
                sim = Simulation.from_decks(params_f, obst_f, backend="sharded", device="cuda")
                counts: dict = {}
                res, dt = timed_run(sim, counts, **run_kw,
                                    **({"shard_devices": devs} if devs else {}))
                want = sharded_expected(kernel, shards, torus, iters, k)
                if counts != want:
                    fail(f"{tag} launches {counts}, expected {want}")
                diffs = 0
                mass = 0.0
                on = []
                for rows, cols, blk in res.f_final.blocks():
                    if not bool(torch.isfinite(blk).all().item()):
                        fail(f"{tag} non-finite state")
                    diffs += int((blk != ref.f_final[:, rows, cols].to(blk.device)).sum().item())
                    mass += device_mass(blk)
                    on.append(str(blk.device))
                drift = abs(mass - mass0) / mass0
                dav = ((res.av_vels - ref.av_vels).abs() / ref.av_vels.abs()).max().item()
                if diffs:
                    fail(f"{tag} {diffs} values differ from single-device pallask")
                if not torch.allclose(res.av_vels, ref.av_vels, rtol=AV_RTOL, atol=0.0):
                    fail(f"{tag} av differs from single-device pallask beyond rtol {AV_RTOL}")
                if drift > 1e-4:
                    fail(f"{tag} total density drifted by {drift:.3e} (limit 1e-4)")
                step_us = dt / iters * 1e6
                across = ""
                if devs:
                    on_one[shards] = (res.av_vels.cpu(), step_us)
                else:
                    if sorted(on) != [f"cuda:{i}" for i in range(shards)]:
                        fail(f"{tag} the shards lie on {on}, not one on each card")
                    one_av, one_us = on_one[shards]
                    if not torch.equal(res.av_vels.cpu(), one_av):
                        fail(f"{tag} av differs from the same mesh on cuda:0")
                    m = mesh.make_yx_mesh(2, 2) if torus else mesh.make_y_mesh(shards)
                    ex = exchange_us(m, n, n, k) / k  # k steps per exchange
                    across = (f", av equal to the same mesh's on cuda:0 ({one_us:.2f} us per "
                              f"step); the exchange timed alone {ex:.2f} us per step ({k} "
                              f"step(s) per exchange), {ex / step_us:.2f} of a step")
                say(f"{tag} {iters} steps: launches "
                    f"{ {a: b for a, b in counts.items() if b} }, 0 of {9 * n * n} values differ "
                    f"from single-device pallask, max rel dav {dav:.3e}, mass drift {drift:.3e}, "
                    f"{step_us:.2f} us per step (host clock, run synchronised; pallask "
                    f"{p_us:.2f}){across} | {card}")
                del res, sim


def phase_sharded_sweep(card: str) -> dict:
    """us per step of 4 ring shards of one card on pallas, pallas K = 4 and
    stream beside single-device pallask, 96 steps from the rest state, for
    the choice of ``auto``."""
    from advanced_hpc_lbm_tpu_torch import Simulation

    from advanced_hpc_lbm_tpu_torch import LBMParams

    four = [torch.device("cuda", 0)] * 4
    steps = 96
    times = {}
    for n in (2048, 4096, 8192):
        params = LBMParams(nx=n, ny=n, max_iters=steps, reynolds_dim=10,
                           density=0.1, accel=0.01, omega=1.85)
        obst = np.zeros((n, n), dtype=bool)  # write_full_deck's geometry, in memory
        obst[0] = obst[-1] = True
        obst[:, 0] = obst[:, -1] = True
        obst[: n // 2, n // 3] = True
        row = {}
        for label, backend, kw in (
                ("pallask", "pallask", {}),
                ("pallas", "sharded", {"devices": 4, "shard_kernel": "pallas"}),
                ("pallas K=4", "sharded", {"devices": 4, "shard_kernel": "pallas", "ca_steps": 4}),
                ("stream", "sharded", {"devices": 4, "shard_kernel": "stream"})):
            sim = Simulation(params, obst, backend=backend, device="cuda")
            extra = {"shard_devices": four} if backend == "sharded" else {}
            _, dt = timed_run(sim, n_iters=steps, **kw, **extra)
            row[label] = dt / steps
            del sim
        times[n] = row
        say(f"[8 sharded sweep] {n}x{n}, 4 ring shards of one card, {steps} steps: " + ", ".join(
            f"{label} {t * 1e6:.2f} us" for label, t in row.items())
            + f" per step (host clock, run synchronised) | {card}")
    return times


# ---- 9. checkpoint / resume ---------------------------------------------------------

def segment_launches(expected, segments: list[int]) -> dict:
    """Launches per kernel of runs of the given step counts, ``expected(n)``
    giving one run's."""
    total = collections.Counter()
    for n in segments:
        total.update(expected(n))
    return {name: total[name] for name in kernel_counters()}


def check_checkpointed(tag: str, out_dir: Path, ck_dir: Path, ref: dict) -> str:
    """A checkpointed CLI run against the straight run ``ref`` (its state,
    av and final_state.dat digest): the newest snapshot's state with 0
    differing values, the same final_state.dat, av within rtol 1e-5."""
    from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io
    from advanced_hpc_lbm_tpu_torch.utils.checkpoint import CheckpointManager

    step, f, av_snap, _ = CheckpointManager(ck_dir).latest()
    n_diff = int((f != ref["f"]).sum())
    if n_diff:
        fail(f"{tag} the last snapshot (step {step}) differs from the straight run in "
             f"{n_diff} values")
    if digest(out_dir / "final_state.dat") != ref["final_state"]:
        fail(f"{tag} final_state.dat differs from the straight run's")
    av = lbm_io.read_av_vels(out_dir / "av_vels.dat")
    if not (np.allclose(av, ref["av"], rtol=AV_RTOL, atol=0.0)
            and np.array_equal(av_snap, av.astype(np.float32))):
        fail(f"{tag} av_vels.dat differs from the straight run's beyond rtol {AV_RTOL} "
             f"or from the snapshot's history")
    dav = float(np.max(np.abs(av - ref["av"]) / np.abs(ref["av"])))
    return (f"0 of {f.size} values of the step-{step} snapshot differ from the straight run, "
            f"final_state.dat equal, max rel dav {dav:.3e} (limit {AV_RTOL})")


def straight_deck(tmp: Path, n: int, iters: int, backend: str = "auto") -> dict:
    """The deck's straight run: the library's state and av, and the CLI's
    final_state.dat digest."""
    from advanced_hpc_lbm_tpu_torch import Simulation

    params_f, obst_f = write_full_deck(tmp, n, n, iters)
    out = tmp / "straight"
    out.mkdir()
    rc, lines, _ = run_cli([str(params_f), str(obst_f), "--backend", backend,
                            "--out-dir", str(out)])
    if rc != 0:
        fail(f"[9 checkpoint] straight {n}x{n} run exited {rc}")
    check_block(lines, "[9 checkpoint]")
    res = Simulation.from_decks(params_f, obst_f, backend=backend, device="cuda").run()
    return {"f": res.f_final, "av": res.av_vels, "final_state": digest(out / "final_state.dat"),
            "deck": (params_f, obst_f)}


def phase_checkpoint(card: str, full: dict) -> None:
    from advanced_hpc_lbm_tpu_torch import Simulation

    segments = Simulation._segments
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the reference's 128^2 deck on auto (the banded resident kernel)
        ref = straight_deck(tmp, 128, 40_000)
        for i, (label, runs) in enumerate((
                ("128x128 auto, 40000 steps, --checkpoint-every 15000",
                 [(128, 40_000, 15_000, False)]),
                ("1024x1024 auto, 20000 steps, --checkpoint-every 7000",
                 [(1024, 20_000, 7_000, False)]),
                ("1024x1024 auto, killed at 10000, --resume to 20000, --checkpoint-every 5000",
                 [(1024, 10_000, 5_000, False), (1024, 20_000, 5_000, True)]))):
            tag = f"[9 checkpoint] {label}:"
            case = tmp / f"case{i}"
            case.mkdir()
            n = runs[0][0]
            params_f, obst_f = (ref["deck"] if n == 128
                                else write_full_deck(case, n, n, 20_000))
            want_ref = ref if n == 128 else full
            ck_dir, out_dir = case / "ck", case / "out"
            out_dir.mkdir()
            start, seconds, launches = 0, 0.0, []
            for _, iters, every, resume in runs:
                rc, lines, counts = run_cli(
                    [str(params_f), str(obst_f), "--iters", str(iters), "--checkpoint-every",
                     str(every), "--checkpoint-dir", str(ck_dir), "--out-dir", str(out_dir)]
                    + (["--resume"] if resume else []))
                if rc != 0:
                    fail(f"{tag} CLI exited {rc}")
                block = check_block(lines, tag)
                seconds += block["compute"]
                want = segment_launches(lambda k: expected_launches("auto", n, n, k),
                                        segments(start, iters, every))
                if counts != want:
                    fail(f"{tag} launches {counts}, expected {want} (segments "
                         f"{segments(start, iters, every)})")
                launches.append({a: b for a, b in counts.items() if b})
                start = iters
            say(f"{tag} {check_checkpointed(tag, out_dir, ck_dir, want_ref)}; launches "
                f"{' then '.join(map(str, launches))} (the segments' sum); Compute "
                f"{seconds:.4f} s in all (snapshots included) | {card}")
        phase_checkpoint_stream(card, tmp)
        phase_checkpoint_sharded(card, tmp)


def phase_checkpoint_stream(card: str, tmp: Path) -> None:
    """4096^2 on the in-place stream tier through Simulation, 2000 steps,
    checkpoint_every=1000: the straight run's state, no more device memory,
    and the seconds of the snapshots' writes."""
    from advanced_hpc_lbm_tpu_torch import Simulation
    from advanced_hpc_lbm_tpu_torch.models.d2q9_bgk import _to_host
    from advanced_hpc_lbm_tpu_torch.utils.checkpoint import CheckpointManager

    n, iters, every = 4096, 2000, 1000
    tag = f"[9 checkpoint] {n}x{n} stream in place, {iters} steps, checkpoint_every {every}:"
    case = tmp / "stream"
    case.mkdir()
    params_f, obst_f = write_full_deck(case, n, n, iters)
    sim = Simulation.from_decks(params_f, obst_f, backend="stream", device="cuda")
    sim.warmup()
    runs = {}
    save, writes = CheckpointManager.save, []

    def timed_save(self, *args, **kwargs):
        t0 = time.perf_counter()
        path = save(self, *args, **kwargs)
        writes.append(time.perf_counter() - t0)
        return path

    for label, kw in (("straight", {}),
                      ("checkpointed", {"checkpoint_every": every,
                                        "checkpoint_dir": str(case / "ck")})):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        counts: dict = {}
        CheckpointManager.save = timed_save
        try:
            with counted(counts):
                t0 = time.perf_counter()
                res = sim.run(fetch=False, **kw)
                dt = time.perf_counter() - t0
        finally:
            CheckpointManager.save = save
        runs[label] = (_to_host(res.f_final), _to_host(res.av_vels), counts, dt,
                       torch.cuda.max_memory_allocated() - before)
        del res
    (f_s, av_s, n_s, dt_s, peak_s), (f_c, av_c, n_c, dt_c, peak_c) = runs.values()
    want = segment_launches(lambda k: expected_launches("stream", n, n, k), [every] * 2)
    if n_s != expected_launches("stream", n, n, iters) or n_c != want:
        fail(f"{tag} launches {n_s} (straight), {n_c} (checkpointed), expected {want}")
    n_diff = int((f_c != f_s).sum())
    if n_diff or not np.allclose(av_c, av_s, rtol=AV_RTOL, atol=0.0):
        fail(f"{tag} {n_diff} values differ from the straight run, or av beyond rtol {AV_RTOL}")
    if peak_c > peak_s:
        fail(f"{tag} peak device memory {peak_c} B above the straight run's {peak_s} B")
    if len(writes) != 2:
        fail(f"{tag} {len(writes)} snapshots written, expected 2")
    say(f"{tag} 0 of {f_c.size} values differ from the straight run, launches "
        f"{ {a: b for a, b in n_c.items() if b} }; peak device memory {peak_c / 1e9:.4f} GB "
        f"(straight {peak_s / 1e9:.4f} GB); {dt_c:.4f} s (straight {dt_s:.4f} s, host clock, "
        f"run synchronised), of which the 2 snapshot writes ({f_c.nbytes / 1e9:.3f} GB each) "
        f"{sum(writes):.4f} s | {card}")


def phase_checkpoint_sharded(card: str, tmp: Path) -> None:
    """1024^2 on 4 shards of the card, checkpoint_every=300 of 1000 steps,
    against the straight sharded run."""
    from advanced_hpc_lbm_tpu_torch import Simulation

    n, iters, every = 1024, 1000, 300
    four = [torch.device("cuda", 0)] * 4
    case = tmp / "sharded"
    case.mkdir()
    params_f, obst_f = write_full_deck(case, n, n, iters)
    for label, kw, kernel, k in (
            ("ring pallas", {"devices": 4, "shard_kernel": "pallas"}, "pallas", 1),
            ("ring stream", {"devices": 4, "shard_kernel": "stream"}, "stream", 8),
            ("2x2 torus pallas", {"mesh": (2, 2), "shard_kernel": "pallas"}, "pallas", 1)):
        tag = f"[9 checkpoint] {n}x{n} {label}, {iters} steps, checkpoint_every {every}:"
        ck = {"checkpoint_every": every, "checkpoint_dir": str(case / label.replace(" ", "_"))}
        sim = Simulation.from_decks(params_f, obst_f, backend="sharded", device="cuda")
        sim.warmup(shard_devices=four, **kw)
        straight = sim.run(shard_devices=four, **kw)
        sim.warmup(shard_devices=four, **kw, **ck)
        counts: dict = {}
        with counted(counts):
            res = sim.run(shard_devices=four, **kw, **ck)
        segs = Simulation._segments(0, iters, every)
        want = segment_launches(lambda s: sharded_expected(kernel, 4, "mesh" in kw, s, k), segs)
        if counts != want:
            fail(f"{tag} launches {counts}, expected {want}")
        n_diff = int((res.f_final != straight.f_final).sum())
        if n_diff or not np.allclose(res.av_vels, straight.av_vels, rtol=AV_RTOL, atol=0.0):
            fail(f"{tag} {n_diff} values differ from the straight sharded run, or av beyond "
                 f"rtol {AV_RTOL}")
        say(f"{tag} 0 of {res.f_final.size} values differ from the straight sharded run, "
            f"launches { {a: b for a, b in counts.items() if b} } | {card}")


# ---- 10. profile -------------------------------------------------------------------------

# the device function of each launch counter (the trace's kernel names)
TRACE_NAMES = {"step_kernel": "step_kernel", "resident_kernel": "resident_kernel",
               "resident_banded_kernel": "resident_banded_kernel",
               "kstep_kernel": "kstep_kernel", "local_ca_kernel": "kstep_kernel",
               "stream_kernel": "stream_kernel", "stream_snapshot": "snapshot_kernel",
               "local_kernel": "local_step_kernel", "local2d_kernel": "local_step_kernel"}


def trace_check(tag: str, path, counts: dict) -> dict:
    """The trace's summary; fails unless each port kernel appears in it by
    name as many times as its launch counters counted."""
    from advanced_hpc_lbm_tpu_torch.utils import profiling

    summary = profiling.trace_summary(path)
    want = collections.Counter()
    for name, n in counts.items():
        want[TRACE_NAMES[name]] += n
    got = {name: summary["kernels"].get(name, [0])[0] for name in set(TRACE_NAMES.values())}
    if got != {name: want[name] for name in got}:
        fail(f"{tag} kernel events in the trace {got} differ from the launch counters' "
             f"{dict(want)} (all kernels in the trace: "
             f"{ {k: v[0] for k, v in summary['kernels'].items()} })")
    return summary


def host_ops_before(path, until_us: float, n: int = 3) -> str:
    """The host's outermost operator spans of a trace of profiling.trace
    from the window's start to ``until_us`` after it, summed by name, the
    longest n: what the host did before the device's work began."""
    from advanced_hpc_lbm_tpu_torch.utils import profiling

    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    t0 = next(float(e["ts"]) for e in events
              if e.get("name") == profiling.WINDOW and e.get("cat") == "user_annotation")
    ops = sorted((e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"
                  and t0 <= float(e["ts"]) < t0 + until_us),
                 key=lambda e: (float(e["ts"]), -float(e["dur"])))
    outer, ends = collections.Counter(), {}
    for e in ops:  # an op that starts after its thread's open span ends is outermost
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if a >= ends.get(e["tid"], -1.0):
            outer[e["name"]] += b - a
        ends[e["tid"]] = max(ends.get(e["tid"], -1.0), b)
    return ", ".join(f"{name} {us / 1e6:.4f} s" for name, us in outer.most_common(n))


def top_kernels(summary: dict, n: int = 4) -> str:
    return ", ".join(f"{name} {launches} x {us / launches:.2f} us = {us / 1e3:.3f} ms"
                     for name, (launches, us, _) in list(summary["kernels"].items())[:n])


def phase_profile(card: str) -> None:
    """--profile through the CLI: the trace exists, the ==done== block and
    the outputs are those of the run without it, the trace shows every
    launched port kernel by name as often as its counter, and the
    program's spans over the device's idle time; the device's busy share
    of the Compute window and the top kernels by device time."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for n, iters, backend in ((512, 2000, "pallask"), (128, 40_000, "auto")):
            tag = f"[10 profile] {n}x{n}, {iters} steps, --backend {backend}:"
            case = tmp / str(n)
            case.mkdir()
            params_f, obst_f = write_full_deck(case, n, n, iters)
            blocks, outs = {}, {}
            for label, extra in (("plain", []), ("profiled", ["--profile", str(case / "trace")])):
                out = case / label
                out.mkdir()
                rc, lines, counts = run_cli([str(params_f), str(obst_f), "--backend", backend,
                                             "--out-dir", str(out), *extra])
                if rc != 0:
                    fail(f"{tag} CLI exited {rc} ({label})")
                blocks[label] = check_block(lines, tag)
                outs[label] = [digest(out / name) for name in ("final_state.dat", "av_vels.dat")]
            if outs["plain"] != outs["profiled"]:
                fail(f"{tag} --profile changed the output files")
            traces = list((case / "trace").glob("*.pt.trace.json"))
            if len(traces) != 1:
                fail(f"{tag} {len(traces)} trace files in the trace directory, expected 1")
            summary = trace_check(tag, traces[0], counts)
            idle = summary["idle_by_span"]
            if not any(name.startswith("lbm.") for name in idle):
                fail(f"{tag} no program span over the device's idle time ({idle})")
            compute = blocks["profiled"]["compute"]
            say(f"{tag} trace {traces[0].name} ({traces[0].stat().st_size / 1e6:.2f} MB); "
                f"Compute {compute:.4f} s (without --profile {blocks['plain']['compute']:.4f} s), "
                f"window {summary['window_us'] / 1e6:.4f} s, device busy "
                f"{summary['busy_us'] / 1e6:.4f} s = {summary['busy_share']:.4f} of the window "
                f"(idle {1 - summary['busy_share']:.4f}); first device activity after "
                f"{summary['first_device_us'] / 1e3:.3f} ms; launches "
                f"{ {a: b for a, b in counts.items() if b} } = the trace's; by device time: "
                f"{top_kernels(summary)}; idle by program span: "
                f"{ {k: round(v / 1e3, 3) for k, v in idle.items()} } ms | {card}")


# ---- 11. batch ---------------------------------------------------------------------------

def phase_batch(card: str) -> None:
    """batch_run of 4 decks of 1024^2 for 200 steps on the card against 4
    sequential fused runs (rtol 1e-6), and the batch split over [cuda:0,
    cuda:0] against the unsplit batch."""
    from advanced_hpc_lbm_tpu_torch import LBMParams, Simulation
    from advanced_hpc_lbm_tpu_torch.parallel import batch

    n, iters, decks = 1024, 200, 4
    tag = f"[11 batch] {decks} decks of {n}x{n}, {iters} steps:"
    params = LBMParams(nx=n, ny=n, max_iters=iters, reynolds_dim=10,
                       density=0.1, accel=0.01, omega=1.85)
    rng = np.random.RandomState(11)
    masks = np.zeros((decks, n, n), dtype=bool)  # write_full_deck's geometry
    masks[:, 0] = masks[:, -1] = True
    masks[:, :, 0] = masks[:, :, -1] = True
    masks[:, : n // 2, n // 3] = True
    for b in range(decks):  # and each deck its own scattered obstacles
        masks[b, rng.randint(1, n - 1, 64), rng.randint(0, n, 64)] = True
    obst = torch.from_numpy(masks).cuda()
    runs = {}
    for label, devices in (("batch", None), ("split", ["cuda:0", "cuda:0"])):
        counts: dict = {}
        with counted(counts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fs, avs = batch.batch_run(batch.batch_initial_state(params, decks, "cuda"), obst,
                                      params, devices=devices)
            torch.cuda.synchronize()
            runs[label] = (fs, avs, time.perf_counter() - t0)
        if any(counts.values()):
            fail(f"{tag} the batch launched port kernels: {counts}")
    fs, avs, dt = runs["batch"]
    if not (torch.equal(runs["split"][0], fs) and torch.equal(runs["split"][1], avs)):
        fail(f"{tag} the batch split over two devices differs from the unsplit batch")
    seq_dt, worst_f, worst_av, n_diff = 0.0, 0.0, 0.0, 0
    for b in range(decks):
        sim = Simulation(params, masks[b], backend="fused", device="cuda")
        sim.warmup()
        t0 = time.perf_counter()
        res = sim.run(fetch=False)
        seq_dt += time.perf_counter() - t0
        if not (torch.allclose(fs[b], res.f_final, rtol=1e-6, atol=1e-8)
                and torch.allclose(avs[b], res.av_vels, rtol=1e-6, atol=0.0)):
            fail(f"{tag} deck {b} differs from its sequential fused run beyond rtol 1e-6")
        worst_f = max(worst_f, (fs[b] - res.f_final).abs().max().item())
        worst_av = max(worst_av, ((avs[b] - res.av_vels).abs() / res.av_vels.abs()).max().item())
        n_diff += int((fs[b] != res.f_final).sum().item())
        if not bool(torch.isfinite(fs[b]).all().item()):
            fail(f"{tag} deck {b}: non-finite state")
    say(f"{tag} against 4 sequential fused runs: max|df| {worst_f:.3e} ({n_diff} of "
        f"{fs.numel()} values differ), max rel dav {worst_av:.3e} (limit 1e-6); split over "
        f"[cuda:0, cuda:0] equal to the unsplit batch; batch {dt:.4f} s (split "
        f"{runs['split'][2]:.4f} s), sequential {seq_dt:.4f} s (host clock, synchronised) "
        f"| {card}")


# ---- 12. multi-process sharded runs ---------------------------------------------------

# each launch of phases 12 and 14; a hang fails the phase here
MP_TIMEOUT_S = 600


def rank_worker(spec_path: str) -> int:
    """One process of a launch of phase 12 or 14, started by
    ``torch.distributed.run``: forms the process group as the CLI does first
    thing, then runs each of the spec's runs in turn, the CLI (``cli``) or
    the library (``lib``, for a grid whose final_state.dat would take
    minutes to write), and writes what the parent checks into
    ``<out>/rank<r>.json``: its backend and device, and per run its exit
    code, stdout, launches and output writes; for ``lib`` also its run
    time (:func:`timed_run`), a digest of each own block and the av
    history.  It leaves the
    group standing: the library takes it down at exit, and the launch's
    exit code, which the parent checks, says whether that went cleanly."""
    from advanced_hpc_lbm_tpu_torch import Simulation, cli
    from advanced_hpc_lbm_tpu_torch.parallel import multihost
    from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io

    spec = json.loads(Path(spec_path).read_text())
    multihost.maybe_initialize(device_type="cuda")
    rank, device = multihost.process_index(), multihost.local_device("cuda")
    report = {"rank": rank, "world": multihost.process_count(), "backend": multihost.backend(),
              "device": str(device), "name": torch.cuda.get_device_name(device), "runs": {}}
    writes: collections.Counter = collections.Counter()

    def counting(fn, key):
        def write(*args, **kwargs):
            writes[key] += 1
            return fn(*args, **kwargs)
        return write

    lbm_io.write_final_state = counting(lbm_io.write_final_state, "final_state")
    lbm_io.write_av_vels = counting(lbm_io.write_av_vels, "av_vels")
    rc = 0
    for name, run in spec["runs"].items():
        writes.clear()
        counts: dict = {}
        out: dict = {}
        buf = io.StringIO()
        if "cli" in run:
            with counted(counts), contextlib.redirect_stdout(buf):
                out["rc"] = cli.main(run["cli"])
        else:
            lib = run["lib"]
            sim = Simulation.from_decks(lib["params"], lib["obstacles"], backend="sharded",
                                        device=device)
            res, out["seconds"] = timed_run(sim, counts, **lib["run"])
            out["blocks"] = {str(rows.start): block_digest(blk)
                             for rows, _, blk in res.f_final.blocks()}
            out["av"] = res.av_vels.cpu().tolist()
            out["rc"] = 0
            del res, sim
        out.update(stdout=buf.getvalue().splitlines(), launches=counts, writes=dict(writes))
        report["runs"][name] = out
        rc = rc or out["rc"]
    Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(report))
    return rc


def block_digest(blk: torch.Tensor) -> str:
    """sha256 of a shard's own block, plane by plane (each plane's own rows
    are contiguous)."""
    h = hashlib.sha256()
    for k in range(blk.shape[0]):
        h.update(blk[k].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def run_group(cmd: list[str], cwd: Path, timeout: float,
              tag: str = "[12 multiprocess]") -> subprocess.CompletedProcess:
    """Run ``cmd`` in a session of its own; on a timeout kill the whole
    session (the launcher and its workers)."""
    import os
    import signal

    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        fail(f"{tag} the launch did not end in {timeout} s; killed\n{err[-2000:]}")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def launch_processes(runs: dict, work: Path, n: int) -> list[dict]:
    """Run ``runs`` (name -> ``cli`` argv or ``lib``) in one launch of n
    processes; returns the ranks' reports."""
    spec = {"out": str(work), "runs": runs}
    (work / "spec.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    res = run_group([sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", str(n), str(ROOT / "chip_smoke.py"), "--rank-worker",
                     str(work / "spec.json")], work, MP_TIMEOUT_S)
    tag = "[12 multiprocess]"
    say(f"{tag} torch.distributed.run exit code {res.returncode}")
    if res.returncode != 0:
        fail(f"{tag} torch.distributed.run exited {res.returncode}\n"
             f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    reports = [json.loads((work / f"rank{r}.json").read_text()) for r in range(n)]
    say(f"{tag} one launch of {n} processes, {len(runs)} runs in "
        f"{time.perf_counter() - t0:.1f} s: backend {reports[0]['backend']} on "
        f"{group_cards(reports)} card(s); ranks on "
        + ", ".join(f"{r['device']} ({r['name']}, {r['backend']})" for r in reports))
    return reports


def group_cards(reports: list[dict]) -> int:
    """The cards the ranks of a launch ran on."""
    return len({r["device"] for r in reports})


def check_ranks(tag: str, reports: list[dict], name: str, expected: dict) -> tuple[list, dict]:
    """Every rank of run ``name``: exit 0, the launches ``expected`` each,
    the outputs written once and the ==done== block printed once, by rank
    0.  Returns rank 0's block (cli runs) and rank 0's run report."""
    runs = [rep["runs"][name] for rep in reports]
    for r, run in enumerate(runs):
        MAIN_LAUNCHES.update(run["launches"])
        if run["rc"] != 0:
            fail(f"{tag} rank {r} exited {run['rc']}")
        if run["launches"] != expected:
            fail(f"{tag} rank {r} launches {run['launches']}, expected {expected}")
    cli_run = "seconds" not in runs[0]
    want = [{"final_state": 1, "av_vels": 1} if cli_run and r == 0 else {}
            for r in range(len(runs))]
    if [run["writes"] for run in runs] != want:
        fail(f"{tag} output writes per rank {[run['writes'] for run in runs]}, expected {want}")
    if not cli_run:
        return [], runs[0]
    if any(run["stdout"] for run in runs[1:]) or runs[0]["stdout"].count("==done==") != 1:
        fail(f"{tag} stdout of the ranks: " + " | ".join(str(run["stdout"][:8]) for run in runs)
             + " (expected one ==done== block, from rank 0)")
    return runs[0]["stdout"], runs[0]


def one_process(params_f, obst_f, out: Path, iters: int, run_kw: dict,
                shards: int = 2) -> tuple[float, dict]:
    """The same configuration in this process on ``shards`` shards of
    cuda:0 (the same mesh shape): its outputs written into ``out``;
    returns (seconds of the run, :func:`timed_run`; launches)."""
    from advanced_hpc_lbm_tpu_torch import Simulation

    on_one = [torch.device("cuda", 0)] * shards
    sim = Simulation.from_decks(params_f, obst_f, backend="sharded", device="cuda")
    counts: dict = {}
    res, dt = timed_run(sim, counts, n_iters=iters, shard_devices=on_one, **run_kw)
    out.mkdir(parents=True, exist_ok=True)
    res.write(out)
    return dt, counts


def differing_values(a: Path, b: Path) -> int:
    """Values that differ between two output files of the same shape (0
    where the bytes are equal)."""
    x, y = a.read_bytes(), b.read_bytes()
    if x == y:
        return 0
    xs, ys = x.split(), y.split()
    return abs(len(xs) - len(ys)) + sum(p != q for p, q in zip(xs, ys))


def same_outputs(tag: str, two: Path, one: Path) -> None:
    for name in ("final_state.dat", "av_vels.dat"):
        n = differing_values(two / name, one / name)
        if n:
            fail(f"{tag} {n} values of {name} differ from the one-process run")
    if sorted(p.name for p in two.iterdir()) != ["av_vels.dat", "final_state.dat"]:
        fail(f"{tag} the output directory holds {sorted(p.name for p in two.iterdir())}")


MP_MINI = (  # (CLI flags, run keywords, kernel, K)
    (["--shard-kernel", "pallas"], {"shard_kernel": "pallas"}, "pallas", 1),
    (["--shard-kernel", "pallas", "--ca-steps", "4"], {"shard_kernel": "pallas", "ca_steps": 4},
     "pallas", 4),
    (["--shard-kernel", "stream"], {"shard_kernel": "stream"}, "stream", 8),
)
def mp_full(n: int) -> tuple:
    """(label, grid, steps, CLI flags, run keywords, kernel, torus) of phase
    12's 1024^2 runs on n processes: a ring of n, and a torus of 2 x n/2
    (n x 1 for odd n)."""
    my, mx = (2, n // 2) if n % 2 == 0 else (n, 1)
    return (("ring pallas", 1024, 20_000, ["--backend", "sharded", "--devices", str(n),
                                           "--shard-kernel", "pallas"],
             {"devices": n, "shard_kernel": "pallas"}, "pallas", False),
            (f"{my}x{mx} torus pallas", 1024, 1000, ["--mesh", f"{my}x{mx}", "--shard-kernel",
                                                     "pallas", "--iters", "1000"],
             {"mesh": (my, mx), "shard_kernel": "pallas"}, "pallas", True))


MP_BIG = (8192, 200, {"shard_kernel": "stream"})  # grid, steps, run keywords (a ring of all)
MP_AUTO = (128, 10_000)  # grid, steps of the --multihost run on auto


def phase_multiprocess(card: str) -> dict:
    """N processes in one launch of torch.distributed.run: two on cuda:0
    over gloo with one card, one on each card over nccl with two or more;
    each run held to the one-process run on the same mesh shape laid on
    cuda:0 alone, timed beside it (and on several cards beside
    single-device pallask)."""
    from advanced_hpc_lbm_tpu_torch import Simulation
    from advanced_hpc_lbm_tpu_torch.utils import check

    decks = ROOT / "decks"
    mini = [str(decks / "mini_64x64.params"), str(decks / "mini_64x64.obstacles.dat")]
    n_cards = torch.cuda.device_count()
    n_proc = n_cards if n_cards >= 2 else 2
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        full = write_full_deck(tmp, 1024, 1024, 20_000)
        n, iters, big_kw = MP_BIG
        big_kw = {"devices": n_proc, **big_kw}
        big = write_full_deck(tmp, n, n, iters)
        small = write_full_deck(tmp, MP_AUTO[0], MP_AUTO[0], MP_AUTO[1])
        runs = {}
        for i, (flags, _, _, _) in enumerate(MP_MINI):
            runs[f"mini{i}"] = {"cli": [*mini, "--backend", "sharded", "--devices", str(n_proc),
                                        *flags, "--out-dir", str(tmp / f"mini{i}" / "two")]}
        for label, _, _, flags, _, _, _ in mp_full(n_proc):
            runs[label] = {"cli": [*map(str, full), *flags, "--out-dir",
                                   str(tmp / label.replace(" ", "_") / "two")]}
        runs["big"] = {"lib": {"params": str(big[0]), "obstacles": str(big[1]), "run": big_kw}}
        runs["auto"] = {"cli": [*map(str, small), "--multihost", "--out-dir",
                                str(tmp / "auto" / "two")]}
        for run in runs.values():
            if "cli" in run:
                Path(run["cli"][-1]).mkdir(parents=True)
        reports = launch_processes(runs, tmp, n_proc)
        backends = [rep["backend"] for rep in reports]
        if n_cards >= 2 and (backends != ["nccl"] * n_proc or group_cards(reports) != n_proc):
            fail(f"[12 multiprocess] the ranks ran {backends} on {group_cards(reports)} "
                 f"card(s), expected nccl on {n_proc}")
        where = (f"{n_proc} processes on {group_cards(reports)} card(s) over "
                 f"{reports[0]['backend']}")
        p_us = ({"full": pallask_us(*full, 20_000), "big": pallask_us(*big, iters)}
                if n_cards >= 2 else None)

        for i, (flags, kw, kernel, k) in enumerate(MP_MINI):
            tag = (f"[12 multiprocess] mini --backend sharded --devices {n_proc} "
                   f"{' '.join(flags)}:")
            block, _ = check_ranks(tag, reports, f"mini{i}",
                                   sharded_expected(kernel, 1, False, 500, k))
            block = check_block(block, tag)
            two, one = tmp / f"mini{i}" / "two", tmp / f"mini{i}" / "one"
            one_process(*mini, one, 500, {"devices": n_proc, **kw}, n_proc)
            same_outputs(tag, two, one)
            stats = check.check_av_vels_only(str(decks / "mini_64x64.golden_av_vels.dat"),
                                             str(two / "av_vels.dat"))
            if not stats.passed(1.0):
                fail(f"{tag} av_vels fail the golden: {stats.max_diff_pcnt:.4g}%")
            say(f"{tag} {where}, 500 steps: launches per rank "
                f"{ {a: b for a, b in reports[0]['runs'][f'mini{i}']['launches'].items() if b} }, "
                f"0 values of final_state.dat and av_vels.dat differ from the one-process "
                f"{n_proc}-shard run, golden max diff {stats.max_diff_pcnt:.4g}% (limit 1%), one "
                f"==done== block and the outputs written once, by rank 0, Compute "
                f"{block['compute']:.4f} s")

        for label, n, iters, _, kw, kernel, torus in mp_full(n_proc):
            tag = f"[12 multiprocess] {n}x{n} {label}, {iters} steps:"
            block, run = check_ranks(tag, reports, label,
                                     sharded_expected(kernel, 1, torus, iters))
            block = check_block(block, tag)
            two = tmp / label.replace(" ", "_") / "two"
            dt_one, _ = one_process(*full, two.parent / "one", iters, kw, n_proc)
            same_outputs(tag, two, two.parent / "one")
            # on one card both runs do the same kernels' work: the rest is
            # the exchange's (one per step)
            staging = (block["compute"] - dt_one) / iters
            times[label] = (block["compute"] / iters, dt_one / iters)
            say(f"{tag} {where}: launches per rank "
                f"{ {a: b for a, b in run['launches'].items() if b} }, 0 values of "
                f"final_state.dat and av_vels.dat differ from the one-process run, Compute "
                f"{block['compute']:.4f} s = {block['compute'] / iters * 1e6:.2f} us per step "
                f"(one process, {n_proc} shards of cuda:0: {dt_one / iters * 1e6:.2f} us, "
                f"host clock, run synchronised"
                + (f"; single-device pallask {p_us['full']:.2f})" if p_us else
                   f"); the difference per exchange {staging * 1e6:.2f} us") + f" | {card}")

        # an 8192^2 ring on stream, through the library (its final_state.dat
        # would take minutes to write): each own block's digest and the av
        # history against the one-process ring of as many shards
        n, iters, _ = MP_BIG
        tag = f"[12 multiprocess] {n}x{n} ring stream, {iters} steps:"
        _, run = check_ranks(tag, reports, "big", sharded_expected("stream", 1, False, iters))
        sim = Simulation.from_decks(*big, backend="sharded", device="cuda")
        res, dt_one = timed_run(sim, shard_devices=[torch.device("cuda", 0)] * n_proc, **big_kw)
        want = {str(rows.start): block_digest(blk) for rows, _, blk in res.f_final.blocks()}
        av = res.av_vels.cpu().tolist()
        del res, sim
        ranks = [rep["runs"]["big"] for rep in reports]
        if any(r["av"] != av for r in ranks):
            fail(f"{tag} a rank's av history differs from the one-process run's")
        if {h: d for r in ranks for h, d in r["blocks"].items()} != want:
            fail(f"{tag} the own blocks differ from the one-process run's")
        dt_two = max(r["seconds"] for r in ranks)
        times["8192 ring stream"] = (dt_two / iters, dt_one / iters)
        say(f"{tag} {where}: launches per rank "
            f"{ {a: b for a, b in run['launches'].items() if b} }, every own block bitwise the "
            f"one-process {n_proc}-shard ring's (sha256), av history equal on every rank; "
            f"{dt_two / iters * 1e6:.2f} us per step (slowest rank; one process, {n_proc} "
            f"shards of cuda:0: {dt_one / iters * 1e6:.2f} us"
            + (f"; single-device pallask {p_us['big']:.2f}" if p_us else "")
            + f"; each after an untimed {WARM_STEPS}-step run, host clock, run synchronised)"
            + ("" if p_us else f"; the difference per exchange of 8 rows "
               f"{(dt_two - dt_one) / (iters // 8) * 1e3:.3f} ms") + f" | {card}")

        # a single-device backend under --multihost: each process runs the
        # 128^2 deck on auto, rank 0 prints and writes
        n, iters = MP_AUTO
        tag = f"[12 multiprocess] {n}x{n} --multihost --backend auto, {iters} steps:"
        block, run = check_ranks(tag, reports, "auto", expected_launches("auto", n, n, iters))
        check_block(block, tag)
        one = tmp / "auto" / "one"
        one.mkdir()
        rc, _, _ = run_cli([*map(str, small), "--out-dir", str(one)])
        if rc != 0:
            fail(f"{tag} the one-process CLI run exited {rc}")
        same_outputs(tag, tmp / "auto" / "two", one)
        say(f"{tag} each of {n_proc} processes ran the deck: launches per rank "
            f"{ {a: b for a, b in run['launches'].items() if b} }, rank 0's outputs equal "
            f"the one-process run's (0 differing values), written once | {card}")
    return times


# ---- 13. the overlapped ring, the matrix collide, viz --------------------------------

def phase_overlap(card: str, final_state: Path) -> None:
    from advanced_hpc_lbm_tpu_torch import LBMParams
    from advanced_hpc_lbm_tpu_torch.ops import kernel_common, mxu_collide, reference
    from advanced_hpc_lbm_tpu_torch.parallel import halo
    from advanced_hpc_lbm_tpu_torch.utils import viz

    n, iters = 1024, 1000
    tag = f"[13 overlap] {n}x{n}, {iters} steps, jnp on 4 shards of one card:"
    params = LBMParams(nx=n, ny=n, max_iters=iters, reynolds_dim=10,
                       density=0.1, accel=0.01, omega=1.85)
    obst = np.zeros((n, n), dtype=bool)  # write_full_deck's geometry, in memory
    obst[0] = obst[-1] = True
    obst[:, 0] = obst[:, -1] = True
    obst[: n // 2, n // 3] = True
    four = [torch.device("cuda", 0)] * 4
    runs, seconds = {}, {}
    for overlap in (False, True):  # first touch of the allocations and streams
        halo.run_sharded(None, obst, params, n_iters=20, devices=four, overlap=overlap)
    for overlap in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[overlap] = halo.run_sharded(None, obst, params, devices=four, overlap=overlap)
        torch.cuda.synchronize()
        seconds[overlap] = time.perf_counter() - t0
    (f_d, av_d), (f_o, av_o) = runs[False], runs[True]
    diffs = sum(int((a != b).sum().item())
                for (_, _, a), (_, _, b) in zip(f_d.blocks(), f_o.blocks()))
    if diffs or not torch.equal(av_d, av_o):
        fail(f"{tag} the overlapped run differs from the default: {diffs} values of the "
             f"state, av equal {torch.equal(av_d, av_o)}")
    del runs, f_d, f_o
    say(f"{tag} overlap=True bitwise equal to overlap=False (state and av); "
        f"{seconds[True] / iters * 1e6:.2f} us per step overlapped against "
        f"{seconds[False] / iters * 1e6:.2f} (overlapped first, each after a 20-step run; "
        f"host clock, runs synchronised) | {card}")

    # the matrix collide on a seeded 1024^2 state, in full float32
    tag = f"[13 mxu_collide] {n}x{n}:"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.RandomState(185)
    f0 = reference.initial_state(params, "cpu").numpy() * rng.uniform(
        0.7, 1.3, (9, n, n)).astype(np.float32)
    mask = rng.rand(n, n) < 0.15
    flat = torch.from_numpy(f0.reshape(9, -1)).cuda()
    obst_flat = torch.from_numpy(mask.reshape(-1)).cuda()
    planes = list(flat.reshape(9, n, n))
    obst_t = obst_flat.reshape(n, n)
    out, usq = mxu_collide.collide_flat(flat, obst_flat, params)
    ref, ref_usq = kernel_common.collide(planes, obst_t, params)
    ref = torch.stack(ref)
    torch.cuda.synchronize()
    if not torch.allclose(out.reshape(9, n, n), ref, rtol=2e-5, atol=2e-7):
        fail(f"{tag} collide_flat differs from kernel_common.collide beyond rtol 2e-5 / "
             "atol 2e-7")
    if not torch.allclose(usq.reshape(n, n), ref_usq, rtol=5e-4, atol=1e-12):
        fail(f"{tag} u_sq differs beyond rtol 5e-4")
    err = float((out.reshape(9, n, n) - ref).abs().max().item())
    mxu_ms = time_ms(lambda: mxu_collide.collide_flat(flat, obst_flat, params), 20)
    vec_ms = time_ms(lambda: kernel_common.collide(planes, obst_t, params), 20)
    say(f"{tag} collide_flat (a float32 torch.matmul, TF32 off) within rtol 2e-5 / atol 2e-7 "
        f"of kernel_common.collide (max abs err {err:.3e}), u_sq within rtol 5e-4; "
        f"{mxu_ms:.4f} ms per call against the plain vector collide's {vec_ms:.4f} ms "
        f"(CUDA events, 20 calls) | {card}")

    # the heatmap of phase 5's final_state.dat (a PGM where matplotlib is missing)
    tag = "[13 viz] phase 5's final_state.dat:"
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = viz.main([str(final_state), "-o", str(Path(tmp) / "final_state.png")])
        path = Path(buf.getvalue().strip())
        if rc != 0 or not path.exists():
            fail(f"{tag} viz.main returned {rc}, wrote {path}")
        data = path.read_bytes()
        if path.suffix == ".pgm":
            head = f"P5 {n} {n} 255\n".encode()
            if not data.startswith(head) or len(data) != len(head) + n * n:
                fail(f"{tag} the PGM is not a {n}x{n} image: {data[:20]!r}, {len(data)} bytes")
        elif not data.startswith(b"\x89PNG"):
            fail(f"{tag} {path.name} is not a PNG")
    say(f"{tag} viz.main wrote {path.name}, a {n}x{n} heatmap of ||u|| ({len(data)} bytes)")


# ---- 14. the sharded path across cards ------------------------------------------------

CARDS_TORUS = (1024, 1000)  # grid, steps of the 2x2 torus of 4 cards
CARDS_HUGE = (49152, 64)  # grid, steps: one state 87.0 GB, on a ring of 4 cards


def cards_topology(n: int) -> None:
    """Peer access of each ordered pair of cards, and nvidia-smi's
    topology matrix."""
    pairs = [f"{i}->{j} {'yes' if torch.cuda.can_device_access_peer(i, j) else 'no'}"
             for i in range(n) for j in range(n) if i != j]
    say(f"[14 cards] {n} cards visible; peer access: " + ", ".join(pairs))
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                          timeout=60, check=False)
    for ln in (topo.stdout or topo.stderr).strip().splitlines():
        say(f"[14 cards] topo | {ln.rstrip()}")


def device_digest(blk: torch.Tensor, rows: int = 1024) -> str:
    """A digest of a shard's own block computed on its card: per plane and
    block of rows, the int64 sums (mod 2^64) of the values' bits and of the
    bits times their position in the plane + 1; only those sums leave the
    card, hashed together."""
    h = hashlib.sha256()
    _, ly, lx = blk.shape
    for k in range(blk.shape[0]):
        for r in range(0, ly, rows):
            bits = blk[k, r:r + rows].contiguous().view(torch.int32).to(torch.int64)
            pos = torch.arange(r * lx + 1, r * lx + 1 + bits.numel(), dtype=torch.int64,
                               device=blk.device).view(bits.shape)
            h.update(torch.stack([bits.sum(), (bits * pos).sum()]).cpu().numpy().tobytes())
    return h.hexdigest()


def cards_torus(tmp: Path, card: str) -> None:
    """The 1024^2 deck through the CLI on a 2x2 torus of 4 cards, held to
    the same mesh laid on cuda:0 alone (0 differing values in both output
    files), timed beside it and single-device pallask."""
    from advanced_hpc_lbm_tpu_torch.parallel import mesh

    size, iters = CARDS_TORUS
    params_f, obst_f = write_full_deck(tmp, size, size, iters)
    p_us = pallask_us(params_f, obst_f, iters)
    tag = f"[14 cards] {size}x{size} 2x2 torus pallas, {iters} steps:"
    (tmp / "cards").mkdir()
    rc, lines, counts = run_cli([str(params_f), str(obst_f), "--backend", "sharded", "--mesh",
                                 "2x2", "--shard-kernel", "pallas", "--out-dir",
                                 str(tmp / "cards")])
    if rc != 0:
        fail(f"{tag} CLI exited {rc}")
    want = sharded_expected("pallas", 4, True, iters)
    if counts != want:
        fail(f"{tag} launches {counts}, expected {want}")
    block = check_block(lines, tag)
    dt_one, _ = one_process(params_f, obst_f, tmp / "one", iters,
                            {"mesh": (2, 2), "shard_kernel": "pallas"}, 4)
    same_outputs(tag, tmp / "cards", tmp / "one")
    step_us, one_us = block["compute"] / iters * 1e6, dt_one / iters * 1e6
    ex = exchange_us(mesh.make_yx_mesh(2, 2), size, size, 1)
    say(f"{tag} 4 cards, one shard each: launches "
        f"{ {a: b for a, b in counts.items() if b} }, 0 values of final_state.dat and "
        f"av_vels.dat differ from the same mesh on cuda:0; {step_us:.2f} us per step "
        f"(Compute) against {one_us:.2f} for the mesh on cuda:0 and {p_us:.2f} for "
        f"single-device pallask; the exchange timed alone {ex:.2f} us, {ex / step_us:.2f} of "
        f"a step | {card}")


def cards_exchange_split(n: int, tmp: Path, card: str) -> None:
    """scripts/torch_mp_exchange.py on the 1024^2 ring, N processes over
    nccl: where an exchange's time goes."""
    tag = f"[14 cards] scripts/torch_mp_exchange.py, 1024x1024 ring of {n} processes:"
    res = run_group([sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", str(n), str(ROOT / "scripts" / "torch_mp_exchange.py"),
                     "--grid", "1024", "--repeat", "2000"], tmp, MP_TIMEOUT_S, tag)
    line = next((ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")), None)
    if res.returncode != 0 or line is None:
        fail(f"{tag} exited {res.returncode}\n{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    out = json.loads(line[len("RESULT "):])
    if out["backend"] != "nccl" or out["cards"] != n:
        fail(f"{tag} ran over {out['backend']} on {out['cards']} card(s), expected nccl on {n}")
    say(f"{tag} over {out['backend']} on {out['cards']} cards, us per step: " + ", ".join(
        f"{k} {v:.2f}" if not isinstance(v, list) else f"{k} " + "/".join(f"{x:.2f}" for x in v)
        for k, v in out["us_per_step"].items()) + f" | {card}")


def cards_huge(card: str) -> None:
    """A 49152^2 grid, more than one card holds, for 64 steps on a ring of
    4 cards with pallas and with stream: the two runs' own blocks equal by
    a digest computed on each card, mass conserved, each card's peak
    memory; nothing of the state is gathered to the host."""
    from advanced_hpc_lbm_tpu_torch import LBMParams, Simulation
    from advanced_hpc_lbm_tpu_torch.parallel import mesh

    size, iters = CARDS_HUGE
    params = LBMParams(nx=size, ny=size, max_iters=iters, reynolds_dim=10,
                       density=0.1, accel=0.01, omega=1.85)
    obst = np.zeros((size, size), dtype=bool)  # write_full_deck's geometry, in memory
    obst[0] = obst[-1] = True
    obst[:, 0] = obst[:, -1] = True
    obst[: size // 2, size // 3] = True
    mass0 = rest_mass(params)
    cards = [torch.device("cuda", i) for i in range(4)]
    digests = {}
    torch.cuda.empty_cache()  # what earlier phases left cached on the cards
    for kernel, g in (("pallas", 1), ("stream", 8)):
        tag = f"[14 cards] {size}x{size} ring {kernel}, {iters} steps on 4 cards:"
        kw = {"devices": 4, "shard_kernel": kernel}
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        sim = Simulation(params, obst, backend="sharded", device="cuda")
        t0 = time.perf_counter()
        sim.warmup(**kw)
        setup = time.perf_counter() - t0
        counts: dict = {}
        with counted(counts):
            t0 = time.perf_counter()
            res = sim.run(fetch=False, **kw)
            dt = time.perf_counter() - t0
        peak = [torch.cuda.max_memory_allocated(d) / 1e9 for d in cards]
        want = sharded_expected(kernel, 4, False, iters, g)
        if counts != want:
            fail(f"{tag} launches {counts}, expected {want}")
        if not bool(torch.isfinite(res.av_vels).all().item()):
            fail(f"{tag} non-finite av")
        # comprehensions only: a loop variable left holding a block would
        # keep its 21.7 GB window on the card through the next run
        blocks = [blk for _, _, blk in res.f_final.blocks()]
        if [blk.device for blk in blocks] != cards:
            fail(f"{tag} the shards lie on {[str(b.device) for b in blocks]}")
        if not all(bool(torch.isfinite(blk[k]).all().item())
                   for blk in blocks for k in range(blk.shape[0])):
            fail(f"{tag} non-finite state")
        drift = abs(sum(device_mass(blk) for blk in blocks) - mass0) / mass0
        if drift > 1e-4:
            fail(f"{tag} total density drifted by {drift:.3e} (limit 1e-4)")
        digests[kernel] = [device_digest(blk) for blk in blocks]
        del res, sim, blocks
        ex = exchange_us(mesh.make_y_mesh(4), size, size, g, repeat=20) / g
        torch.cuda.empty_cache()  # the next run's windows are a few rows taller
        step_us = dt / iters * 1e6
        say(f"{tag} launches { {a: b for a, b in counts.items() if b} }, finite, mass drift "
            f"{drift:.3e} (limit 1e-4), peak memory per card "
            + " / ".join(f"{p:.2f}" for p in peak) + f" GB; set-up {setup:.2f} s, "
            f"{step_us:.2f} us per step (host clock, run synchronised, the first run of its "
            f"runner; no single card holds the grid); the exchange timed alone {ex:.2f} us per "
            f"step ({g} step(s) per exchange), {ex / step_us:.2f} of a step | {card}")
    if digests["pallas"] != digests["stream"]:
        fail(f"[14 cards] {size}x{size}: the pallas and stream runs' own blocks differ "
             f"(on-card digests {digests})")
    say(f"[14 cards] {size}x{size}: the pallas and stream runs' own blocks equal shard by "
        f"shard (on-card digests {', '.join(h[:12] for h in digests['pallas'])})")


def phase_cards(card: str) -> None:
    """What the sharded path does only across cards, beyond phases 8 and
    12 (which take every visible card): peer access and topology, on 4
    cards a 2x2 torus and a grid no card holds, the NCCL split; skipped
    where one card is visible."""
    n = torch.cuda.device_count()
    if n < 2:
        say(f"[14 cards] skipped: {n} card visible")
        return
    cards_topology(n)
    with tempfile.TemporaryDirectory() as tmp:
        if n >= 4:
            timed(cards_torus, Path(tmp), card)
        timed(cards_exchange_split, n, Path(tmp), card)
    if n >= 4:
        timed(cards_huge, card)


# ---- main -------------------------------------------------------------------

def timed(phase, *args):
    """Run a phase and print its wall time (the script's time limit is
    shared by every phase)."""
    t0 = time.perf_counter()
    out = phase(*args)
    label = f" {args[1]}" if phase is phase_big else ""
    say(f"[time] {phase.__name__}{label}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-worker":
        return rank_worker(sys.argv[2])  # one process of a phase-12 or -14 launch
    t0 = time.perf_counter()
    keep = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    atexit.register(shutil.rmtree, keep, True)
    card = phase_card()
    timed(phase_build)
    worst_step, step_times = timed(phase_kernel, card)
    worst_res, res_times = timed(phase_resident, card)
    worst_k, k_times = timed(phase_kstep, card, res_times)
    worst_s, s_times = timed(phase_stream, card)
    worst_l, l_times = timed(phase_local, card)
    timed(retime, card, step_times, k_times, s_times, l_times)
    timed(phase_mini)
    full = timed(phase_full, card, res_times, keep)
    timed(phase_reference, card)
    timed(phase_mid, card)
    timed(phase_cli_big, card)
    timed(phase_big, card, "6 big", 4096, ("pallask", "step"))
    timed(phase_big, card, "6s big stream", 8192, ("stream", "pallask"))
    timed(phase_capacity, card)
    timed(phase_sharded_mini, card)
    timed(phase_sharded_full, card)
    timed(phase_sharded_big, card)
    timed(phase_sharded_sweep, card)
    timed(phase_checkpoint, card, full)
    timed(phase_profile, card)
    timed(phase_batch, card)
    timed(phase_multiprocess, card)
    timed(phase_overlap, card, keep / "final_state.dat")
    timed(phase_cards, card)
    say(f"[result] all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"main-path launches {dict(MAIN_LAUNCHES)}; K-step kernel's by K "
        f"{dict(sorted(MAIN_K_LAUNCHES.items()))}")
    for name in kernel_counters():
        if MAIN_LAUNCHES[name] <= 0:
            fail(f"[result] {name} was not launched on the main path")
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel, stream_kernel

    k_ms, p_ms = step_times[(1024, 1024)]
    r_ms, _, rp_ms = res_times[(128, 128)][:3]  # the reference's 128x128 deck
    cp_ms, coop_ms = res_times[(1024, 1024)][2:4]  # the 1024x1024 deck
    best = kstep_kernel.best_k(4096, 4096)
    big = k_times[(4096, 4096)]
    st = s_times[(4096, 4096)]
    src = "advanced_hpc_lbm_tpu_torch/csrc/"
    # times per step: step at 1024^2, the resident kernel's banded form at
    # 128^2 and its cooperative form at 1024^2 (one launch of RUN_STEPS
    # steps), K-step and stream at 4096^2; no single PyTorch call computes a
    # D2Q9 step, so library_ms is null
    entries = [
        ("step_kernel", "step_kernel.cu", "advanced_hpc_lbm_tpu/ops/pallas_step.py:112", {},
         worst_step, k_ms, p_ms, bound(1024 * 1024, 1)),
        ("resident_kernel", "resident_kernel.cu", "advanced_hpc_lbm_tpu/ops/resident.py:88", {},
         worst_res["cooperative"], coop_ms, cp_ms, bound(1024 * 1024, RUN_STEPS)),
        ("resident_banded_kernel", "resident_kernel.cu",
         "advanced_hpc_lbm_tpu/ops/resident.py:88", {},
         worst_res["banded"], r_ms, rp_ms, bound(128 * 128, RUN_STEPS)),
        ("kstep_kernel", "kstep_kernel.cu", "advanced_hpc_lbm_tpu/ops/pallas_k.py:208",
         {"also_replaces": ["advanced_hpc_lbm_tpu/ops/pallas_k.py:143",
                            "advanced_hpc_lbm_tpu/ops/pallas_multi.py:97"],
          "launches_by_k": {str(k): n for k, n in sorted(MAIN_K_LAUNCHES.items())},
          "ms_k2": big[2]},
         worst_k, big[best], big["plain"], bound(4096 * 4096, best)),
        ("stream_kernel", "stream_kernel.cu", "advanced_hpc_lbm_tpu/ops/pallas_stream.py:104",
         {"also_replaces": ["advanced_hpc_lbm_tpu/ops/kernel_common.py:207"]},
         max(worst_s, worst_l["stream"], worst_l["stream2d"]), st["stream"], st["plain"],
         bound(4096 * 4096, stream_kernel.K)),
    ]
    # the local kernels per step at the main path's shard shapes (8192^2 over
    # 4 shards: 2048x8192 ring shards, 4096x4096 torus shards)
    for name, source, replaces, kind in (
            ("local_kernel", "local_kernel.cu", "advanced_hpc_lbm_tpu/ops/pallas_local.py:53", "1d"),
            ("local2d_kernel", "local_kernel.cu", "advanced_hpc_lbm_tpu/ops/pallas_local.py:189",
             "2d"),
            ("local_ca_kernel", "kstep_kernel.cu", "advanced_hpc_lbm_tpu/ops/pallas_local.py:401",
             "ca")):
        k, ly, lx = LOCAL_TIMED[kind]
        entries.append((name, source, replaces, {}, worst_l[kind], *l_times[kind],
                        local_bound(kind, k, ly, lx)))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + source, "replaces": replaces, **extra,
         "launches": MAIN_LAUNCHES[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        for name, source, replaces, extra, err, ms, plain_ms, (b_ms, b_by) in entries
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
