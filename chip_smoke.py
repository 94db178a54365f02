#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

It needs one CUDA card, nvcc (``/usr/local/cuda`` or on PATH) and nothing
else of the repository but ``advanced_hpc_lbm_tpu_torch/`` and ``decks/``;
it imports no JAX.  Each phase prints one line; the first failure exits
non-zero and prints no result:

  1. card    the card's name and power limit (nvidia-smi), torch and CUDA
  2. build   nvcc builds the kernel library from csrc/ (or finds it built)
  3. kernel  the step kernel against its plain PyTorch version on the card,
             from seeded states, at 1024x1024, 64x64, 100x130 and 17x23,
             1 and 50 steps, plus a forcing row that fails the guard
  4. mini    decks/mini_64x64 through the CLI: 500 counted kernel launches,
             the ==done== block, and the golden at 1%
  5. full    the 1024x1024 deck (20 000 steps) through the CLI: finite,
             positive av history, mass conserved, GLUPS of the run and of
             the kernel and the plain version alone
  6. result  a JSON line of the kernels, then the device JSON line last
"""

from __future__ import annotations

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
    from advanced_hpc_lbm_tpu_torch.ops import _build, step_kernel

    t0 = time.perf_counter()
    path, cached = _build.build()
    step_kernel.prepare("cuda")
    dt = time.perf_counter() - t0
    log = path.with_suffix(".log")
    report = ""
    if log.exists():
        report = " | ".join(
            ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln
        )
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


# ---- 4./5. decks through the CLI ---------------------------------------------

def run_cli(argv: list[str]) -> tuple[int, list[str], int]:
    """``cli.main(argv)`` in-process: (rc, stdout lines, kernel launches)."""
    from advanced_hpc_lbm_tpu_torch import cli
    from advanced_hpc_lbm_tpu_torch.ops import step_kernel

    buf = io.StringIO()
    step_kernel.launches = 0
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    launches = step_kernel.launches
    return rc, buf.getvalue().splitlines(), launches


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
    with tempfile.TemporaryDirectory() as tmp:
        rc, lines, n = run_cli([str(decks / "mini_64x64.params"),
                                str(decks / "mini_64x64.obstacles.dat"),
                                "--out-dir", tmp])
        if rc != 0:
            fail(f"[4 mini] CLI exited {rc}")
        if n != 500:
            fail(f"[4 mini] {n} step-kernel launches, expected 500")
        block = check_block(lines, "[4 mini]")
        stats = check.check_av_vels_only(
            str(decks / "mini_64x64.golden_av_vels.dat"), str(Path(tmp) / "av_vels.dat"))
        if not stats.passed(1.0):
            fail(f"[4 mini] av_vels fail the golden: {stats.max_diff_pcnt:.4g}%")
    say(f"[4 mini] 64x64, 500 steps: {n} kernel launches, Reynolds "
        f"{block['reynolds']:.6E}, golden max diff {stats.max_diff_pcnt:.4g}% "
        f"(limit 1%), Compute {block['compute']:.4f} s")


def write_full_deck(d: Path, nx: int, ny: int, iters: int) -> tuple[Path, Path]:
    """The 1024x1024 benchmark deck: a closed box and a half-height wall at
    x = nx // 3 (the same geometry as bench.py's build_deck)."""
    params = d / "full.params"
    params.write_text(f"{nx}\n{ny}\n{iters}\n10\n0.1\n0.01\n1.85\n")
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[:, 0] = mask[:, -1] = True
    mask[: ny // 2, min(nx - 1, nx // 3)] = True
    yy, xx = np.nonzero(mask)
    obst = d / "full.obstacles.dat"
    obst.write_text("".join(f"{x} {y} 1\n" for x, y in zip(xx.tolist(), yy.tolist())))
    return params, obst


def phase_full(card: str, k_ms: float, p_ms: float) -> int:
    from advanced_hpc_lbm_tpu_torch import Simulation
    from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io

    nx = ny = 1024
    iters = 20_000
    with tempfile.TemporaryDirectory() as tmp:
        params_f, obst_f = write_full_deck(Path(tmp), nx, ny, iters)
        rc, lines, n = run_cli([str(params_f), str(obst_f), "--out-dir", tmp])
        if rc != 0:
            fail(f"[5 full] CLI exited {rc}")
        if n != iters:
            fail(f"[5 full] {n} step-kernel launches, expected {iters}")
        block = check_block(lines, "[5 full]")
        av_cli = lbm_io.read_av_vels(Path(tmp) / "av_vels.dat")
        if av_cli.shape != (iters,) or not np.all(np.isfinite(av_cli)) or not np.all(av_cli > 0):
            fail("[5 full] av history is not finite and positive")

        # the same deck through the library entry points, for the state
        sim = Simulation.from_decks(params_f, obst_f, device="cuda")
        sim.warmup()
        res = sim.run(check_finite=True)
    mass0 = float(sim.initial_state().double().sum().item())
    mass1 = float(res.f_final.astype(np.float64).sum())
    drift = abs(mass1 - mass0) / mass0
    if drift > 1e-4:
        fail(f"[5 full] total density drifted by {drift:.3e} (limit 1e-4)")
    av_lib = res.av_vels.astype(np.float64)
    same = bool(np.array_equal(np.float32(av_cli), res.av_vels))
    if not np.allclose(av_lib, av_cli, rtol=1e-5, atol=0.0):
        fail("[5 full] library rerun disagrees with the CLI's av history")
    glups = iters * nx * ny / block["compute"] / 1e9
    say(f"[5 full] {ny}x{nx}, {iters} steps: {n} kernel launches, Compute "
        f"{block['compute']:.4f} s = {glups:.3f} GLUPS (host loop included), "
        f"Init {block['init']:.3f} s, Collate {block['collate']:.3f} s, Reynolds "
        f"{block['reynolds']:.6E}, final av {av_cli[-1]:.6E}, mass drift "
        f"{drift:.3e} (limit 1e-4), rerun {'bitwise equal' if same else 'within rtol 1e-5'} "
        f"| {card}")
    say(f"[5 full] {ny}x{nx} GLUPS: CLI run {glups:.3f}, kernel alone "
        f"{nx * ny / k_ms / 1e6:.3f} ({k_ms * 1e3:.2f} us/step), plain version "
        f"{nx * ny / p_ms / 1e6:.3f} ({p_ms * 1e3:.2f} us/step, 200 steps) | {card}")
    return n


# ---- main -------------------------------------------------------------------

def main() -> int:
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    worst_f, times = phase_kernel(card)
    phase_mini()
    k_ms, p_ms = times[(1024, 1024)]
    launches = phase_full(card, k_ms, p_ms)
    say(f"[6 result] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "step_kernel",
        "route": "cuda",
        "source": "advanced_hpc_lbm_tpu_torch/csrc/step_kernel.cu",
        "replaces": "advanced_hpc_lbm_tpu/ops/pallas_step.py:112",
        "launches": launches,
        "max_abs_err": worst_f,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
