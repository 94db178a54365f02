"""How many processes of a multi-process run die on their way out.

Starts ``--launches`` launches of ``--world`` processes, one launch after
another (with ``--at-once`` all together, so that they load the host as a
busy test suite does), each with the explicit ``MASTER_ADDR`` form on a
free port of this host.  Each process forms the group through the port's
``multihost.maybe_initialize(force=True, device_type=--device)`` (with
``--world 1`` a group of one process), runs 20 checked ``all_reduce``s,
leaves ``--in-flight`` more in flight, and returns without tearing the
group down.  A process that exits with any other code than 0 (SIGABRT
gives -6) counts as an abort.

On the CPU the group runs gloo.  With ``--device cuda`` each process takes
its own card (``LOCAL_RANK``), so the group runs NCCL; that needs
``--world`` cards.  ``--tree`` names the checkout whose package the
processes import (default: this one), so that two commits are counted by
the same script:

    python scripts/torch_exit_check.py [--launches 8] [--world 2] \
        [--in-flight 4] [--at-once] [--device cpu|cuda] [--tree DIR]

Prints ``RESULT`` and one JSON object: the exit codes of every launch, the
count of aborts, the count of processes whose stderr warns that the group
was not destroyed, the seconds of the whole count and the host's card
(``nvidia-smi`` name and power limit) or ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NOT_DESTROYED = "destroy_process_group() was not called"
TIMEOUT_S = 120  # each process of a launch; a hang counts as a failure of the script

WORKER = r"""
import sys
import torch
import torch.distributed as dist
from advanced_hpc_lbm_tpu_torch.parallel import multihost

device_type, in_flight = sys.argv[1], int(sys.argv[2])
assert multihost.maybe_initialize(force=True, device_type=device_type)
world = multihost.process_count()
x = torch.ones(64, device=multihost.local_device(device_type))
for _ in range(20):
    dist.all_reduce(x)
    x /= world
assert bool((x == 1).all())
for _ in range(in_flight):
    dist.all_reduce(torch.ones_like(x), async_op=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(a: argparse.Namespace) -> list[dict]:
    port = free_port()
    base = dict(os.environ)
    base["PYTHONPATH"] = str(Path(a.tree).resolve()) + os.pathsep + base.get("PYTHONPATH", "")
    base.setdefault("OMP_NUM_THREADS", "1")
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(a.world),
                LOCAL_WORLD_SIZE=str(a.world))
    argv = [sys.executable, "-c", WORKER, a.device, str(a.in_flight)]
    procs = [subprocess.Popen(argv, cwd=a.tree, env={**base, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(a.world)]
    outs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            outs.append({"rc": p.returncode, "not_destroyed": NOT_DESTROYED in err,
                         "tail": err.strip().splitlines()[-1:] if p.returncode else []})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--launches", type=int, default=8)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--in-flight", type=int, default=0)
    p.add_argument("--at-once", action="store_true")
    p.add_argument("--device", default="cpu")
    p.add_argument("--tree", default=str(ROOT))
    a = p.parse_args()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(a.launches if a.at_once else 1) as pool:
        runs = list(pool.map(lambda _: launch(a), range(a.launches)))
    seconds = time.perf_counter() - t0
    card = "cpu"
    if a.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=False).stdout.strip()
    procs = [q for run in runs for q in run]
    print("RESULT " + json.dumps({
        "tree": str(Path(a.tree).resolve()), "device": a.device, "world": a.world,
        "launches": a.launches, "in_flight": a.in_flight, "at_once": a.at_once,
        "processes": len(procs), "aborts": sum(q["rc"] != 0 for q in procs),
        "not_destroyed": sum(q["not_destroyed"] for q in procs),
        "rcs": [[q["rc"] for q in run] for run in runs],
        "tails": sorted({line for q in procs for line in q["tail"]}),
        "seconds": seconds, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
