#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

It needs one CUDA card, nvcc (``/usr/local/cuda`` or on PATH) and nothing
else of the repository but ``advanced_hpc_lbm_tpu_torch/`` and ``decks/``;
it imports no JAX.  Each case prints one line; the first failure exits
non-zero and prints no result:

  1. card    the card's name and power limit (nvidia-smi), torch and CUDA
  2. build   nvcc builds the kernel library from csrc/ (or finds it built)
             and every kernel is loaded onto the card
  3. kernel  the step kernel against its plain PyTorch version on the card,
             from seeded states, at 1024x1024, 64x64, 100x130 and 17x23,
             1 and 50 steps, plus a forcing row that fails the guard
  3r. resident  the resident kernel against the step kernel (0 differing
             values) and its plain version, 1024^2 to 17x23: 1 and 50 steps
             in one chunk, 17 steps in chunks of 6 with a guard-failing
             row; then its time per step beside the step kernel's run loop
  3k. kstep  the K-step kernel (K = 2, 4, 8 and best_k of the shape, the K
             pallask runs there) against the step kernel (0 differing
             values) and its plain version at 4096^2, 1024^2, 256^2,
             128x256, 64^2, 100x130 and 17x23, 1 pass and 3 passes with a
             guard-failing row; then its time per step for K = 2..6, 8 at
             4096^2 down to 64^2, beside the step and resident kernels
  4. mini    decks/mini_64x64 through the CLI with auto, pallas, resident,
             pallask and pallas2: exact launches per kernel, the ==done==
             block, and the golden at 1%
  5. full    the 1024x1024 deck (20 000 steps) through the CLI with auto
             and with resident: finite, positive av history, mass
             conserved, GLUPS of the run and of the kernel alone
  6. big     a 4096x4096 deck for 2000 steps through Simulation with
             pallask and with step: finite, mass conserved, the same state
             bit for bit, GLUPS of both
  result     a JSON line of the kernels, then the device JSON line last

Launch counts: every kernel module counts its launches; each run of
phases 4-6 (the main path) sets the counts to 0 just before it and reads
them just after, and the kernels line reports their sum.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
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

# launches of each kernel over the main-path runs of phases 4-6
MAIN_LAUNCHES: collections.Counter = collections.Counter()


def kernel_modules() -> dict:
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel, resident, step_kernel

    return {"step_kernel": step_kernel, "resident_kernel": resident,
            "kstep_kernel": kstep_kernel}


@contextlib.contextmanager
def counted(into: dict):
    """Set every launch count to 0, run the body, then read the counts into
    ``into`` and add them to MAIN_LAUNCHES."""
    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
    yield
    into.update({name: m.launches for name, m in mods.items()})
    MAIN_LAUNCHES.update(into)


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

def phase_build() -> None:
    from advanced_hpc_lbm_tpu_torch.ops import _build, kstep_kernel, resident, step_kernel

    t0 = time.perf_counter()
    path, cached = _build.build()
    step_kernel.prepare("cuda")
    resident.prepare("cuda")
    for k in kstep_kernel.K_RANGE:
        kstep_kernel.prepare("cuda", k)
    dt = time.perf_counter() - t0
    log = path.with_suffix(".log")
    report, name = [], "?"
    for ln in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "registers" in ln:
            report.append(f"{name}: {ln.split(':', 1)[1].strip()}")
        elif "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill"):
            report.append(f"{name}: {ln.strip()}")
    report = " | ".join(report)
    say(f"[2 build] {path.name} {'from cache' if cached else 'built by nvcc'} "
        f"in {dt:.2f} s | ptxas: {report or 'no report'}")


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


def phase_resident(card: str) -> tuple[float, dict]:
    from advanced_hpc_lbm_tpu_torch.ops import resident, step_kernel

    shapes = ((1024, 1024), (256, 256), (128, 128), (64, 64), (100, 130), (17, 23))
    worst = 0.0
    for seed, (ny, nx) in enumerate(shapes):
        for n, chunk, guard in ((1, resident.CHUNK, False), (50, resident.CHUNK, False),
                                (17, 6, True)):
            params, mask, f = on_card(ny, nx, 100 + seed, guard)
            tag = f"[3r resident] {ny}x{nx} {n} step(s), chunk {chunk}" + (
                ", guard-failing row" if guard else "")
            resident.launches = 0
            fr, avr = resident.resident_run(f, mask, params, n_iters=n, chunk=chunk)
            torch.cuda.synchronize()
            if resident.launches != -(-n // chunk):
                fail(f"{tag}: {resident.launches} launches, expected {-(-n // chunk)}")
            fs, avs = step_kernel.run(f, mask, params, n_iters=n)
            fp, avp = plain_resident(f, mask, params, n, chunk)
            torch.cuda.synchronize()
            worst = max(worst, diff_line(fr, fp)[0])
            say(f"{tag}: {resident.launches} launch(es); "
                f"{check_against(tag, fr, avr, fs, avs, 'step kernel', True)}; "
                f"{check_against(tag, fr, avr, fp, avp, 'plain version', False)}")
    return worst, time_whole_runs(card)


def time_whole_runs(card: str) -> dict:
    """us per step of the resident kernel, the step kernel's run loop and
    the plain step at grids from 64^2 to 4096^2 (one chunk of RUN_STEPS
    steps per timed run; the plain step one call at a time)."""
    from advanced_hpc_lbm_tpu_torch.ops import resident, step_kernel

    times = {}
    for seed, n in enumerate((64, 128, 256, 512, 768, 1024, 2048, 4096)):
        params, mask, f = on_card(n, n, 200 + seed)
        steps = RUN_STEPS if n <= 2048 else RUN_STEPS // 4
        reps = 3 if n <= 2048 else 1
        r_ms = time_ms(lambda: resident.resident_run(f, mask, params, n_iters=steps), reps) / steps
        s_ms = time_ms(lambda: step_kernel.run(f, mask, params, n_iters=steps), reps) / steps
        p_ms = (time_ms(step_timer(step_kernel.plain_step, params, mask, f), 20)
                if n in (128, 1024) else float("nan"))
        times[(n, n)] = (r_ms, s_ms, p_ms)
        say(f"[3r resident] {n}x{n} time per step ({steps} steps, one chunk): resident "
            f"{r_ms * 1e3:.2f} us ({n * n / r_ms / 1e6:.3f} GLUPS), step run loop "
            f"{s_ms * 1e3:.2f} us ({n * n / s_ms / 1e6:.3f} GLUPS), plain "
            + (f"{p_ms * 1e3:.2f} us" if p_ms == p_ms else "not timed")
            + f" | {card}")
    return times


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


def phase_kstep(card: str, res_times: dict) -> tuple[float, dict]:
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel, step_kernel

    worst = 0.0
    shapes = ((4096, 4096), (1024, 1024), (256, 256), (128, 256), (64, 64),
              (100, 130), (17, 23))
    for seed, (ny, nx) in enumerate(shapes):
        # the K the pallask backend runs at this shape, and 2, 4, 8
        for k in sorted({2, 4, 8, kstep_kernel.best_k(ny, nx)}):
            for passes, guard in ((1, False), (3, True)):
                params, mask, f = on_card(ny, nx, 300 + seed, guard)
                n = k * passes
                tag = f"[3k kstep] {ny}x{nx} K={k}, {passes} pass(es)" + (
                    ", guard-failing row" if guard else "")
                kstep_kernel.launches = 0
                fk, avk = kstep_kernel.run(f, mask, params, n_iters=n, k=k)
                torch.cuda.synchronize()
                if kstep_kernel.launches != passes:
                    fail(f"{tag}: {kstep_kernel.launches} launches, expected {passes}")
                fs, avs = step_kernel.run(f, mask, params, n_iters=n)
                fp, avp = plain_kstep(f, mask, params, k, passes)
                torch.cuda.synchronize()
                worst = max(worst, diff_line(fk, fp)[0])
                say(f"{tag}: {check_against(tag, fk, avk, fs, avs, 'step kernel', True)}; "
                    f"{check_against(tag, fk, avk, fp, avp, 'plain version', False)}")
                del fp, avp
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
            k = kstep_kernel.best_k(size, size)
            out = torch.empty_like(f)
            part = torch.empty(k, kstep_kernel.num_tiles(size, size), device=f.device)
            row["plain"] = time_ms(lambda: kstep_kernel.plain_multi_step(
                f, mask, params, k, out=out, partials=part), 2) / k
        times[(size, size)] = row
        ks = " ".join(f"K={k} {row[k] * 1e3:.2f} us ({size * size / row[k] / 1e6:.3f} GLUPS)"
                      for k in TIMED_K)
        plain = (f", plain K={kstep_kernel.best_k(size, size)} {row['plain'] * 1e3:.2f} us"
                 if "plain" in row else "")
        say(f"[3k kstep] {size}x{size} time per step ({n} steps): {ks}; step run loop "
            f"{s_ms * 1e3:.2f} us ({size * size / s_ms / 1e6:.3f} GLUPS){plain} | {card}")
    return times


def check_auto(card: str, res_times: dict, k_times: dict) -> None:
    """One line per timed grid: each backend's us per step and what auto and
    best_k choose there (a report; the choice is fixed in the code)."""
    from advanced_hpc_lbm_tpu_torch.models import d2q9_bgk
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel

    for (ny, nx), row in sorted(k_times.items()):
        k = min(TIMED_K, key=row.get)
        t = {"step": row["step"], "resident": res_times[(ny, nx)][0],
             "pallask": row[kstep_kernel.best_k(ny, nx)]}
        auto = d2q9_bgk.AUTO_BACKEND
        fastest = min(t, key=t.get)
        say(f"[3k auto] {ny}x{nx}: step {t['step'] * 1e3:.2f} us, resident "
            f"{t['resident'] * 1e3:.2f} us, pallask (K={kstep_kernel.best_k(ny, nx)}) "
            f"{t['pallask'] * 1e3:.2f} us, fastest K here {k}; auto picks {auto}, "
            f"{'the fastest' if auto == fastest else 'fastest was ' + fastest} | {card}")


# ---- 4./5./6. the main path: decks through the CLI and the library --------------

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
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel, resident

    backend = d2q9_bgk.AUTO_BACKEND if backend == "auto" else backend
    want = {"step_kernel": 0, "resident_kernel": 0, "kstep_kernel": 0}
    if backend in ("step", "pallas"):
        want["step_kernel"] = iters
    elif backend == "resident":
        want["resident_kernel"] = -(-iters // resident.CHUNK)
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
    for backend in ("auto", "pallas", "resident", "pallask", "pallas2"):
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


def phase_full(card: str, times: dict) -> None:
    from advanced_hpc_lbm_tpu_torch import Simulation
    from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io

    nx = ny = 1024
    iters = 20_000
    with tempfile.TemporaryDirectory() as tmp:
        params_f, obst_f = write_full_deck(Path(tmp), nx, ny, iters)
        histories = {}
        for backend in ("auto", "resident"):
            tag = f"[5 full] --backend {backend}:"
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
            glups = iters * nx * ny / block["compute"] / 1e9
            say(f"{tag} {ny}x{nx}, {iters} steps: launches {n}, Compute "
                f"{block['compute']:.4f} s = {glups:.3f} GLUPS (host loop included), "
                f"Init {block['init']:.3f} s, Collate {block['collate']:.3f} s, Reynolds "
                f"{block['reynolds']:.6E}, final av {av_cli[-1]:.6E} | {card}")

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
    r_ms, s_ms, p_ms = times[(ny, nx)]
    say(f"[5 full] library run ({sim.backend}): launches {counts}, mass drift {drift:.3e} "
        f"(limit 1e-4), av within rtol 1e-5 of both CLI runs; auto and resident av "
        f"{'bitwise equal' if same else 'within rtol 1e-5'} | {card}")
    say(f"[5 full] {ny}x{nx} kernels alone: resident {nx * ny / r_ms / 1e6:.3f} GLUPS "
        f"({r_ms * 1e3:.2f} us/step), step run loop {nx * ny / s_ms / 1e6:.3f} GLUPS "
        f"({s_ms * 1e3:.2f} us/step), plain step {nx * ny / p_ms / 1e6:.3f} GLUPS "
        f"({p_ms * 1e3:.2f} us/step) | {card}")


def phase_big(card: str) -> None:
    from advanced_hpc_lbm_tpu_torch import Simulation

    nx = ny = 4096
    iters = 2000
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        params_f, obst_f = write_full_deck(Path(tmp), nx, ny, iters)
        for backend in ("pallask", "step"):
            sim = Simulation.from_decks(params_f, obst_f, backend=backend, device="cuda")
            sim.warmup()
            counts: dict = {}
            with counted(counts):
                t0 = time.perf_counter()
                res = sim.run(fetch=False)  # waits for the device
                dt = time.perf_counter() - t0
            want = expected_launches(backend, ny, nx, iters)
            if counts != want:
                fail(f"[6 big] {backend}: launches {counts}, expected {want}")
            f = res.f_final
            if not bool(torch.isfinite(f).all().item()) or not bool(
                    torch.isfinite(res.av_vels).all().item()):
                fail(f"[6 big] {backend}: non-finite result")
            mass0 = float(sim.initial_state().double().sum().item())
            drift = abs(float(f.double().sum().item()) - mass0) / mass0
            if drift > 1e-4:
                fail(f"[6 big] {backend}: total density drifted by {drift:.3e} (limit 1e-4)")
            runs[backend] = res
            say(f"[6 big] {ny}x{nx}, {iters} steps, --backend {backend}"
                + (f" (K={sim._k()})" if backend == "pallask" else "")
                + f": launches {counts}, {dt:.4f} s = {iters * nx * ny / dt / 1e9:.3f} GLUPS "
                f"(host clock, run synchronised), mass drift {drift:.3e} (limit 1e-4) | {card}")
    k, s = runs["pallask"], runs["step"]
    tag = f"[6 big] {ny}x{nx} pallask vs step"
    say(f"{tag}: {check_against(tag, k.f_final, k.av_vels, s.f_final, s.av_vels, 'step backend', True)}")


# ---- main -------------------------------------------------------------------

def main() -> int:
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    worst_step, step_times = phase_kernel(card)
    worst_res, res_times = phase_resident(card)
    worst_k, k_times = phase_kstep(card, res_times)
    phase_mini()
    phase_full(card, res_times)
    phase_big(card)
    say(f"[result] all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"main-path launches {dict(MAIN_LAUNCHES)}")
    for name in ("step_kernel", "resident_kernel", "kstep_kernel"):
        if MAIN_LAUNCHES[name] <= 0:
            fail(f"[result] {name} was not launched on the main path")
    from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel

    k_ms, p_ms = step_times[(1024, 1024)]
    r_ms, _, rp_ms = res_times[(128, 128)]  # the reference's 128x128 deck
    best = kstep_kernel.best_k(4096, 4096)
    big = k_times[(4096, 4096)]
    src = "advanced_hpc_lbm_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "step_kernel", "route": "cuda", "source": src + "step_kernel.cu",
         "replaces": "advanced_hpc_lbm_tpu/ops/pallas_step.py:112",
         "launches": MAIN_LAUNCHES["step_kernel"], "max_abs_err": worst_step,
         "ms": k_ms, "plain_ms": p_ms},
        {"name": "resident_kernel", "route": "cuda", "source": src + "resident_kernel.cu",
         "replaces": "advanced_hpc_lbm_tpu/ops/resident.py:88",
         "launches": MAIN_LAUNCHES["resident_kernel"], "max_abs_err": worst_res,
         "ms": r_ms, "plain_ms": rp_ms},
        {"name": "kstep_kernel", "route": "cuda", "source": src + "kstep_kernel.cu",
         "replaces": "advanced_hpc_lbm_tpu/ops/pallas_k.py:208",
         "also_replaces": ["advanced_hpc_lbm_tpu/ops/pallas_k.py:143",
                           "advanced_hpc_lbm_tpu/ops/pallas_multi.py:97"],
         "launches": MAIN_LAUNCHES["kstep_kernel"], "max_abs_err": worst_k,
         "ms": big[best], "plain_ms": big["plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
