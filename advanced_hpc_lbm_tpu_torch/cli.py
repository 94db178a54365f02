"""Command-line entry point — the same contract as ``advanced_hpc_lbm_tpu.cli``.

``python -m advanced_hpc_lbm_tpu_torch <paramfile> <obstaclefile>`` runs the
deck, prints the ``==done==`` / Reynolds / four-timer block and writes
final_state.dat + av_vels.dat (in the cwd, or ``--out-dir``).

Optional flags:
  --backend       auto (default) | step | pallas | resident | pallask |
                  pallas2 | fused | pipeline
  --device        cuda (default) | cpu | cuda:N
  --debug         per-step av-velocity + total-density prints
  --out-dir       where to write outputs (default: cwd)
  --iters         override maxIters from the deck
  --check-finite  fail loudly if the run produced NaN/Inf
"""

from __future__ import annotations

import argparse
import sys

import torch

from advanced_hpc_lbm_tpu_torch.models.d2q9_bgk import BACKENDS, Simulation
from advanced_hpc_lbm_tpu_torch.utils.timers import PhaseTimers


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="advanced_hpc_lbm_tpu_torch",
        description="D2Q9-BGK lattice Boltzmann solver (PyTorch/CUDA port)",
    )
    p.add_argument("paramfile")
    p.add_argument("obstaclefile")
    p.add_argument(
        "--backend", default="auto",
        help=f"one of {', '.join(BACKENDS)}; auto runs pallask; the CUDA "
             "kernels run their plain PyTorch versions on the CPU",
    )
    p.add_argument("--device", default="cuda", help="torch device to run on")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument(
        "--check-finite", action="store_true",
        help="fail loudly if the run produced NaN/Inf (numerical sanitizer)",
    )
    return p


def _device(name: str) -> torch.device:
    """The requested device, or an error message that the CLI prints."""
    try:
        device = torch.device(name)
    except RuntimeError as e:
        raise ValueError(f"bad --device {name!r}: {e}") from None
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(
            f"--device {name} asks for CUDA, but no CUDA device is available "
            "to PyTorch here (use --device cpu)"
        )
    return device


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    timers = PhaseTimers()

    with timers.phase("init"):
        try:
            sim = Simulation.from_decks(
                args.paramfile, args.obstaclefile,
                backend=args.backend, device=_device(args.device),
            )
        except (OSError, ValueError) as e:  # DeckError is a ValueError
            print(f"Error: {e}", file=sys.stderr)
            return 1
        # build and load the kernel here, so Compute times the steps alone
        sim.warmup()

    with timers.phase("compute"):
        # leave results on the device: the CLI times the device->host
        # transfer as the Collate phase
        result = sim.run(
            n_iters=args.iters, debug=args.debug,
            check_finite=args.check_finite, fetch=False,
        )

    with timers.phase("collate"):
        # a deferred --check-finite runs on the collated arrays
        try:
            result.collate()
        except FloatingPointError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    if args.debug:
        for tt, (av, dens) in enumerate(zip(result.av_vels, result.densities)):
            print(f"==timestep: {tt}==")
            print(f"av velocity: {av:.12E}")
            print(f"tot density: {dens:.12E}")

    # Reynolds is computed after the total timer stops, so it stays untimed
    reynolds = result.reynolds
    print("==done==")
    print(f"Reynolds number:\t\t{reynolds:.12E}")
    for line in timers.report_lines():
        print(line)
    result.write(args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
