"""Where the time of a multi-process ring step goes.

A ring of N shards of an n x n deck, one shard per process, each process
on its own device (``multihost.local_device``).  Where every process has a
card of its own the process group runs nccl and the halos are staged in
buffers on the card; where processes share a card (on a one-card machine
all take cuda:0) it runs gloo and stages them through pinned host buffers
(``parallel/multihost.choose_backend``, ``halo._staging``).  Each phase
runs ``--repeat`` times and is timed on the host clock, the device
synchronised at its end:

  exchange  the halo exchange alone (``_Windows.exchange``): the edge rows
            to the staging buffers, the sends and receives, the ghost rows
            from the staging buffers
  wire      the sends and receives of those staging buffers alone (nccl:
            between the cards; gloo: between host buffers)
  copies    the exchange's copies alone: the edge rows to the staging
            buffers, the synchronisation before the wire where they are
            host buffers, the buffers back to the ghost rows
  compute   the 1-step local kernel on each process's own shard, without
            an exchange: every process's kernel at once
  pipeline  exchange + a launch of the local kernel, per step: what a
            ``pallas`` ring run does (without its ||u|| sums)
  alone     the compute phase with the other processes idle at a barrier
            (rank 0 steps, then rank 1, ...)

Run from the root of a checkout:

    torchrun --standalone --nproc-per-node N scripts/torch_mp_exchange.py \
        [--grid 1024] [--repeat 2000] [--device cuda|cpu]

Rank 0 prints ``RESULT`` and one JSON object: us per step of each phase,
the backend, the processes, the cards they ran on, the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from advanced_hpc_lbm_tpu_torch.ops import local_kernel  # noqa: E402
from advanced_hpc_lbm_tpu_torch.params import LBMParams  # noqa: E402
from advanced_hpc_lbm_tpu_torch.parallel import halo, mesh, multihost  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--grid", type=int, default=1024)
    p.add_argument("--repeat", type=int, default=2000)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    if not multihost.maybe_initialize(device_type=a.device):
        raise SystemExit("run under torchrun with 2 or more processes")
    device = multihost.local_device(a.device)
    cuda = device.type == "cuda"
    rank = multihost.process_index()
    n = a.grid
    params = LBMParams(nx=n, ny=n, max_iters=a.repeat, reynolds_dim=10, density=0.1,
                       accel=0.01, omega=1.85)
    obst = np.zeros((n, n), dtype=bool)  # chip_smoke.write_full_deck's geometry
    obst[0] = obst[-1] = True
    obst[:, 0] = obst[:, -1] = True
    obst[: n // 2, n // 3] = True
    world = multihost.process_count()
    ring = mesh.make_y_mesh(world, [device])
    win = halo._Windows(ring, n, n, 1)
    win.load(params, None)
    masks = halo._window_masks(ring, n, n, 1, obst, exclude_ghosts=False)
    (s,) = win.local
    if cuda:
        local_kernel.prepare(device)
    step = [local_kernel.step_launcher(win.halo1(win.bufs[b][s]), win.halo1(masks[s]), params,
                                       win.own(1 - b, s)) for b in range(2)]
    part = torch.empty(local_kernel.num_partials(win.ly, win.lx), device=device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def timed(body) -> float:
        for t in range(10):  # warm-up
            body(t)
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for t in range(a.repeat):
            body(t)
        sync()
        dt = (time.perf_counter() - t0) / a.repeat
        dist.barrier()
        return dt

    def wire(t):
        for phase in win.phases[t % 2]:
            ops = sorted([(tag, dist.P2POp(dist.isend, buf, peer, tag=tag))
                          for _, buf, peer, tag in phase.sends]
                         + [(tag, dist.P2POp(dist.irecv, buf, peer, tag=tag))
                            for _, buf, peer, tag in phase.recvs], key=lambda op: op[0])
            for w in dist.batch_isend_irecv([op for _, op in ops]):
                w.wait()

    def copies(t):
        for phase in win.phases[t % 2]:
            for src, buf, _, _ in phase.sends:
                buf.copy_(src, non_blocking=True)
            for d in phase.host_staged:  # as _Phase.post: host buffers only
                torch.cuda.current_stream(d).synchronize()
            for dst, buf, _, _ in phase.recvs:
                dst.copy_(buf, non_blocking=True)

    out = {
        "exchange": timed(lambda t: win.exchange(t % 2)),
        "wire": timed(wire),
        "copies": timed(copies),
        "compute": timed(lambda t: step[t % 2](part)),
        "pipeline": timed(lambda t: (win.exchange(t % 2), step[t % 2](part))),
    }
    alone = []
    for r in range(world):
        if r == rank:
            alone.append(timed_alone(step, part, a.repeat, sync))
        dist.barrier()
    times = [None] * world
    dist.all_gather_object(times, alone[0])
    out["alone"] = times
    devices = [None] * world
    dist.all_gather_object(devices, str(device))
    if rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=False).stdout.strip() if cuda else "cpu"
        print("RESULT " + json.dumps({
            "n": n, "steps": a.repeat, "backend": multihost.backend(), "processes": world,
            "devices": devices, "cards": len(set(devices)) if cuda else 0, "card": smi, "us_per_step": {k: (v * 1e6 if not isinstance(v, list)
                                             else [x * 1e6 for x in v])
                                         for k, v in out.items()}}), flush=True)
    dist.destroy_process_group()
    return 0


def timed_alone(step, part, steps: int, sync) -> float:
    """The compute phase of this process while the other waits."""
    for t in range(10):
        step[t % 2](part)
    sync()
    t0 = time.perf_counter()
    for t in range(steps):
        step[t % 2](part)
    sync()
    return (time.perf_counter() - t0) / steps


if __name__ == "__main__":
    sys.exit(main())
