"""Command-line entry point — the same contract as ``advanced_hpc_lbm_tpu.cli``.

``python -m advanced_hpc_lbm_tpu_torch <paramfile> <obstaclefile>`` runs the
deck, prints the ``==done==`` / Reynolds / four-timer block and writes
final_state.dat + av_vels.dat (in the cwd, or ``--out-dir``).

Optional flags:
  --backend       auto (default) | step | pallas | resident | pallask |
                  pallas2 | stream | fused | pipeline | sharded
  --device        cuda (default) | cpu | cuda:N
  --devices       shard over N devices (1-D ring): the visible cards on
                  CUDA, N shards on the CPU with --device cpu
  --mesh          MYxMX: shard over a 2-D torus of devices instead
  --shard-kernel  auto (default) | jnp | pallas | stream: the shards' kernel
  --ca-steps      K: steps per halo exchange on the sharded path
  --debug         per-step av-velocity + total-density prints
  --out-dir       where to write outputs (default: cwd)
  --iters         override maxIters from the deck
  --check-finite  fail loudly if the run produced NaN/Inf
  --checkpoint-every  N: snapshot the state every N steps into
                  --checkpoint-dir (default checkpoints)
  --resume        continue from the newest readable snapshot there
  --profile       TRACE_DIR: a torch.profiler trace of the Compute phase,
                  written there as a Chrome trace (utils/profiling.py)
  --multihost     form the torch.distributed process group even where the
                  environment shows no multi-process launch (torchrun and
                  Slurm launches are detected: parallel/multihost.py)

Under a multi-process launch (``torchrun --nproc-per-node N -m
advanced_hpc_lbm_tpu_torch ...``, or ``srun`` with several tasks) every
process runs this; ``--device cuda`` is each process's own card
(``multihost.local_device``), the sharded mesh spans the processes, and
only the primary process (rank 0) prints the ``==done==`` block and the
``--debug`` lines and writes the outputs.  Errors print on every process.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import torch
import torch.distributed as dist

from advanced_hpc_lbm_tpu_torch.models.d2q9_bgk import BACKENDS, Simulation
from advanced_hpc_lbm_tpu_torch.parallel import multihost
from advanced_hpc_lbm_tpu_torch.parallel.halo import SHARD_KERNELS
from advanced_hpc_lbm_tpu_torch.utils import profiling
from advanced_hpc_lbm_tpu_torch.utils.timers import PhaseTimers


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="advanced_hpc_lbm_tpu_torch",
        description="D2Q9-BGK lattice Boltzmann solver (PyTorch/CUDA port)",
    )
    p.add_argument("paramfile")
    p.add_argument("obstaclefile")
    p.add_argument(
        "--backend", default="auto", choices=BACKENDS,
        help="auto runs resident where its banded form takes the grid on the "
             "card (the small decks), else pallask, or stream where pallask's two "
             "state buffers do not fit on the card; the CUDA kernels run their "
             "plain PyTorch versions on the CPU",
    )
    p.add_argument("--device", default="cuda", help="torch device to run on")
    p.add_argument("--debug", action="store_true")
    p.add_argument(
        "--profile", metavar="TRACE_DIR", default=None,
        help="write a torch.profiler trace of the Compute phase into TRACE_DIR "
             "(a Chrome trace: chrome://tracing, Perfetto, TensorBoard)",
    )
    p.add_argument("--out-dir", default=".")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument(
        "--check-finite", action="store_true",
        help="fail loudly if the run produced NaN/Inf (numerical sanitizer)",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=None, metavar="N",
        help="snapshot the distribution array every N steps",
    )
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument(
        "--resume", action="store_true",
        help="resume from the latest snapshot in --checkpoint-dir",
    )
    p.add_argument(
        "--devices", type=int, default=None,
        help="shard over N devices (1-D y ring); with --device cpu every shard "
             "lies on the CPU, on CUDA the shards take the visible cards",
    )
    p.add_argument(
        "--shard-kernel", default="auto", choices=SHARD_KERNELS,
        help="the shards' local step on the sharded path: auto (jnp on the CPU, "
             "pallas on CUDA, stream on CUDA shards of 2^24 cells or more; "
             "parallel/halo.resolve_shard_kernel), jnp (plain "
             "PyTorch), pallas (the hand-written local kernels, with --ca-steps K "
             "the K-step one), stream (the stream kernel on ghost windows, 8 steps "
             "per exchange)",
    )
    p.add_argument(
        "--mesh", default=None, metavar="MYxMX", type=_parse_mesh,
        help="2-D torus decomposition for the sharded path, e.g. 2x4 (rows x "
             "columns of devices)",
    )
    p.add_argument(
        "--ca-steps", type=int, default=1, metavar="K",
        help="steps per halo exchange on the sharded path (communication-"
             "avoiding ghost zones; 1-D ring or 2-D torus; with --shard-kernel "
             "pallas the K-step local kernel, 1-D only)",
    )
    p.add_argument(
        "--multihost", action="store_true",
        help="form the torch.distributed process group (normally detected from "
             "the environment: torchrun's MASTER_ADDR/WORLD_SIZE/RANK, Slurm "
             "multi-task launches; parallel/multihost.py); outputs are written by "
             "process 0 only",
    )
    return p


def _parse_mesh(text: str) -> tuple[int, int]:
    """``MYxMX`` as (my, mx)."""
    try:
        my, mx = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"--mesh wants MYxMX, e.g. 2x4, got {text!r}") from None
    return my, mx


def _device(name: str) -> torch.device:
    """The requested device, or an error message that the CLI prints; a
    bare ``cuda`` in a process group is the process's own card."""
    try:
        device = torch.device(name)
    except RuntimeError as e:
        raise ValueError(f"bad --device {name!r}: {e}") from None
    if device.type == "cuda" and device.index is None and multihost.process_count() > 1:
        device = multihost.local_device("cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(
            f"--device {name} asks for CUDA, but no CUDA device is available "
            "to PyTorch here (use --device cpu)"
        )
    return device


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    # first thing, before any device is used: under a multi-process launch
    # this forms the process group (a no-op in a single process); a group
    # formed here is taken down on the way out
    formed = not dist.is_initialized() and multihost.maybe_initialize(
        force=args.multihost, device_type=args.device.split(":")[0])
    try:
        return _main(args)
    finally:
        if formed:
            dist.destroy_process_group()


def _main(args: argparse.Namespace) -> int:
    primary = multihost.is_primary()
    timers = PhaseTimers()
    sharding = dict(n_iters=args.iters, debug=args.debug, devices=args.devices,
                    shard_kernel=args.shard_kernel, mesh=args.mesh, ca_steps=args.ca_steps,
                    checkpoint_every=args.checkpoint_every,
                    checkpoint_dir=args.checkpoint_dir, resume=args.resume)

    with timers.phase("init"):
        try:
            sim = Simulation.from_decks(
                args.paramfile, args.obstaclefile,
                backend=args.backend, device=_device(args.device),
            )
            # build and load the kernel here, so Compute times the steps
            # alone; a negative --iters, a grid that does not fit on the
            # card, a bad decomposition or a segment length it refuses
            # stops here
            sim.warmup(**sharding)
        except (OSError, ValueError) as e:  # DeckError is a ValueError
            print(f"Error: {e}", file=sys.stderr)
            return 1

    trace = profiling.trace(args.profile) if args.profile else contextlib.nullcontext()
    with trace, timers.phase("compute"):
        # leave results on the device: the CLI times the device->host
        # transfer as the Collate phase (a checkpointed run has gathered
        # them already, and checks finiteness here)
        try:
            result = sim.run(check_finite=args.check_finite, fetch=False, **sharding)
        except (FloatingPointError, ValueError) as e:
            # the device-memory gate, a refused tail, a resume point past
            # the target
            print(f"Error: {e}", file=sys.stderr)
            return 1

    with timers.phase("collate"):
        # a deferred --check-finite runs on the collated arrays
        try:
            result.collate()
        except FloatingPointError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    if args.debug and primary:
        for tt, (av, dens) in enumerate(zip(result.av_vels, result.densities)):
            print(f"==timestep: {tt}==")
            print(f"av velocity: {av:.12E}")
            print(f"tot density: {dens:.12E}")

    # Reynolds is computed after the total timer stops, so it stays untimed
    reynolds = result.reynolds
    # one process speaks and writes: the reference's rank-0 collate and
    # write; a single process is always the primary
    if primary:
        print("==done==")
        print(f"Reynolds number:\t\t{reynolds:.12E}")
        for line in timers.report_lines():
            print(line)
    result.write(args.out_dir)  # every process calls it, the primary writes
    return 0


if __name__ == "__main__":
    sys.exit(main())
