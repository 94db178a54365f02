"""Multi-process bootstrap: the ``torch.distributed`` process group.

The counterpart of ``advanced_hpc_lbm_tpu.parallel.multihost``.  The
reference's Slurm scripts reserve multi-rank nodes (``--ntasks-per-node``
14 and 28), its MPI growth path.  Here that is one process per rank, with
``torch.distributed.init_process_group`` forming the group.  After it, a
mesh spans the processes (``parallel/mesh.py``: each process's own devices
in rank order), each process drives only its own shards, and the halos
between two processes travel as point-to-point sends and receives
(``parallel/halo.py``).

Detection ladder (the first hit wins), as in the JAX module:

1. ``MASTER_ADDR`` with ``WORLD_SIZE`` and ``RANK`` (or their Slurm
   fallbacks ``SLURM_NTASKS`` and ``SLURM_PROCID``) and ``MASTER_PORT``:
   torchrun's ``env://`` convention, the explicit form that works on any
   cluster (the JAX module's ``JAX_COORDINATOR_ADDRESS``).
2. Slurm multi-task (``SLURM_NTASKS`` > 1): the coordinator is the first
   host of ``SLURM_STEP_NODELIST``, the rank ``SLURM_PROCID``.
3. The JAX module's third rung, a TPU pod's ``TPU_WORKER_HOSTNAMES``, has
   no counterpart: a GPU host publishes no such list.

A malformed integer in those variables gives a ``UserWarning`` and a
single-process run, never a crash.

Backend, by one rule (:func:`choose_backend`): ``nccl`` where the run is
on CUDA and every process of a node has a card of its own; ``gloo``
otherwise, that is on the CPU or where two processes share a card (NCCL
refuses two ranks on one GPU).  Gloo moves host tensors only, so the halo
exchange stages CUDA rows through pinned host buffers there.  The group
has a timeout (``TIMEOUT``), so that a lost peer fails the run instead of
hanging it.

Single-process runs never touch ``torch.distributed``: :func:`maybe_initialize`
is a no-op unless the environment says multi-process (or ``force``).
Exactly one process prints the results block and writes files:
:func:`is_primary` (rank 0), which the CLI asks.

A group that :func:`maybe_initialize` forms is taken down when the
interpreter exits (an ``atexit`` handler, registered once), so a caller need
not tear it down itself; one that does (``dist.destroy_process_group()``)
leaves the handler nothing to do.  Left standing, the group's worker threads
race the interpreter's finalisation, and a process that finished its work
can die of SIGABRT on its way out ("terminate called without an active
exception"), which ``torchrun`` reports as a failed run.  The handler holds
no barrier: a survivor of a dead peer exits without waiting out ``TIMEOUT``.
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import os
import re
import subprocess
import warnings

import torch
import torch.distributed as dist

DEFAULT_PORT = "29500"  # torchrun's default MASTER_PORT
# a collective or a point-to-point transfer that waits longer than this
# fails the run (the longest wait of a run is the primary's first kernel
# build, about 20 s with nvcc, while the others hold at a barrier)
TIMEOUT = datetime.timedelta(seconds=300)
_teardown_registered = False


def _first_slurm_host(nodelist: str) -> str:
    """First hostname of a Slurm nodelist.  Prefers ``scontrol show
    hostnames`` (every bracket syntax); falls back to expanding the leading
    entry of simple ``prefix[a-b,c]`` lists textually."""
    try:
        out = subprocess.run(["scontrol", "show", "hostnames", nodelist],
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.split()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    m = re.match(r"([^\[,]+)\[([^\]]+)\]", nodelist)
    if m:
        prefix, ranges = m.groups()
        return prefix + ranges.split(",")[0].split("-")[0]
    return nodelist.split(",")[0]


def _int(env, *names: str) -> int | None:
    """The first of ``names`` set in ``env`` as an int: None when none is
    set; raises ValueError naming the variable when it is malformed."""
    for name in names:
        text = env.get(name)
        if text is not None and text != "":
            try:
                return int(text)
            except ValueError:
                raise ValueError(f"{name}={text!r} is not an integer") from None
    return None


def _leading_int(text: str | None) -> int | None:
    """The leading count of a Slurm per-node field such as ``2(x3)``."""
    m = re.match(r"\s*(\d+)", text or "")
    return int(m.group(1)) if m else None


def detect(env=None) -> dict | None:
    """The ``init_process_group`` arguments of a multi-process launch
    (``init_method``, ``world_size``, ``rank``), or None for a single
    process.  A malformed integer warns and gives None."""
    env = os.environ if env is None else env
    try:
        addr = env.get("MASTER_ADDR")
        if addr:
            n = _int(env, "WORLD_SIZE", "SLURM_NTASKS")
            rank = _int(env, "RANK", "SLURM_PROCID")
            port = _int(env, "MASTER_PORT")
            if n is None or n < 2:
                return None
            return {"init_method": f"tcp://{addr}:{DEFAULT_PORT if port is None else port}",
                    "world_size": n, "rank": 0 if rank is None else rank}
        n = _int(env, "SLURM_NTASKS")
        if n is not None and n > 1:
            nodelist = env.get("SLURM_STEP_NODELIST") or env.get("SLURM_JOB_NODELIST", "")
            port = _int(env, "MASTER_PORT")
            rank = _int(env, "SLURM_PROCID")
            return {"init_method": f"tcp://{_first_slurm_host(nodelist)}:"
                                   f"{DEFAULT_PORT if port is None else port}",
                    "world_size": n, "rank": 0 if rank is None else rank}
    except ValueError as e:
        warnings.warn(f"multi-process launch not detected ({e}); running as a single "
                      "process", UserWarning, stacklevel=2)
        return None
    return None


def local_rank(env=None) -> int:
    """This process's rank on its node (``LOCAL_RANK``, ``SLURM_LOCALID``;
    0 when neither is set or one is malformed)."""
    env = os.environ if env is None else env
    try:
        return _int(env, "LOCAL_RANK", "SLURM_LOCALID") or 0
    except ValueError as e:
        warnings.warn(f"{e}; taking local rank 0", UserWarning, stacklevel=2)
        return 0


def local_world_size(env=None, world_size: int = 1) -> int:
    """Processes on this node: ``LOCAL_WORLD_SIZE`` (torchrun), else the
    leading count of ``SLURM_NTASKS_PER_NODE`` / ``SLURM_TASKS_PER_NODE``,
    else ``world_size`` (every process may share this node)."""
    env = os.environ if env is None else env
    text = env.get("LOCAL_WORLD_SIZE")
    if text is not None and text.strip().isdigit():
        return int(text)
    for name in ("SLURM_NTASKS_PER_NODE", "SLURM_TASKS_PER_NODE"):
        n = _leading_int(env.get(name))
        if n:
            return n
    return world_size


def choose_backend(device_type: str, local_processes: int, cards: int) -> str:
    """``nccl`` where the run is on CUDA and each of the node's
    ``local_processes`` has a card of its own (at most ``cards`` of them),
    else ``gloo``: the CPU, or processes sharing a card.  Every process
    reads the same launch variables, so every process chooses alike."""
    return "nccl" if device_type == "cuda" and 0 < local_processes <= cards else "gloo"


def maybe_initialize(env=None, *, force: bool = False, device_type: str = "cuda") -> bool:
    """Form the process group iff the environment is a multi-process launch
    (or ``force``: then, with no launch in the environment, a group of
    this one process).  Idempotent; returns True when the group is (now)
    initialized.  ``device_type`` is where the run's tensors live, for the
    backend rule.  The CLI calls it first thing."""
    if dist.is_initialized():
        return True
    env = os.environ if env is None else env
    kw = detect(env)
    if kw is None and not force:
        return False
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    world = kw["world_size"] if kw else 1
    backend = choose_backend(device_type, local_world_size(env, world), cards)
    if backend == "nccl":
        torch.cuda.set_device(local_rank(env) % cards)
    if kw is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, timeout=TIMEOUT, **kw)
    global _teardown_registered
    if not _teardown_registered:
        atexit.register(_destroy_at_exit)
        _teardown_registered = True
    return True


def _destroy_at_exit() -> None:
    """Take the group down before the interpreter finalises, unless the
    caller already has.  No barrier, so a dead peer holds no one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the one process that prints the results and writes the
    outputs (rank 0; always true in a single process)."""
    return process_index() == 0


def backend() -> str | None:
    """The process group's backend, or None in a single process."""
    return dist.get_backend() if dist.is_initialized() else None


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's own device: ``cuda:(LOCAL_RANK % cards)`` on CUDA, so
    that processes beyond the cards of a node share them; the CPU
    otherwise."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", local_rank() % max(1, torch.cuda.device_count()))


@contextlib.contextmanager
def primary_first():
    """Run the body on the primary process first, then on the others (a
    barrier between): the kernel library is built once, by rank 0, and
    loaded by the rest.  The body must not communicate.  A primary whose
    body raises still releases the others, which then meet the error
    themselves instead of waiting out the timeout."""
    many = process_count() > 1
    if many and not is_primary():
        dist.barrier()
    try:
        yield
    finally:
        if many and is_primary():
            dist.barrier()
