"""Device meshes: a 1-D ring or a (my, mx) torus of ``torch.device``s.

The counterpart of ``advanced_hpc_lbm_tpu.parallel.mesh`` (``make_y_mesh``,
``make_yx_mesh``).  A mesh is a row-major list of devices in which a device
may appear more than once: several shards then live on one device, in
separate allocations, with real halo copies between them.  That lays a
ring or a torus over the CPU (the tests) or over one card, as the JAX tests
lay one over ``--xla_force_host_platform_device_count`` virtual devices.
By default a mesh takes the visible CUDA cards, one shard each.

A mesh may span processes (``parallel/multihost.py``): its device list is
then each process's own devices in rank order, gathered once when the mesh
is made, and ``ranks`` records the process that owns each shard.  A
process drives only its own shards (``parallel/halo.py``).  In a single
process every shard is its own, and nothing is gathered.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch
import torch.distributed as dist

from advanced_hpc_lbm_tpu_torch.parallel import multihost


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` (my, mx) devices, row-major in ``devices``.  A 1-D ring is
    (n, 1) with ``torus`` False: rows sharded, x periodic on every shard.
    A torus shards rows over my and columns over mx.  ``ranks[s]`` is the
    process that owns shard s (empty: every shard is this process's)."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, int]
    torus: bool
    ranks: tuple[int, ...] = ()

    @property
    def size(self) -> int:
        return len(self.devices)

    def index(self, i: int, j: int = 0) -> int:
        """Flat index of the shard at mesh position (i, j), both periodic."""
        my, mx = self.shape
        return (i % my) * mx + j % mx

    def owner(self, s: int) -> int:
        """The rank of the process that owns shard s."""
        return self.ranks[s] if self.ranks else 0

    def is_local(self, s: int) -> bool:
        return self.owner(s) == multihost.process_index()

    @property
    def spans_processes(self) -> bool:
        return len(set(self.ranks)) > 1


def local_devices() -> list[torch.device]:
    """This process's own CUDA cards: every card PyTorch sees in a single
    process; in a process group, its ``multihost.local_device``."""
    if multihost.process_count() > 1:
        return [multihost.local_device("cuda")] if torch.cuda.is_available() else []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _gather(local: list[torch.device]) -> tuple[list[torch.device], tuple[int, ...]]:
    """(devices, owning ranks): each process's ``local`` list in rank
    order.  Collective in a process group: every process calls it."""
    if multihost.process_count() == 1:
        return local, (0,) * len(local)
    lists: list = [None] * multihost.process_count()
    dist.all_gather_object(lists, [str(d) for d in local])
    devs = [torch.device(d) for names in lists for d in names]
    return devs, tuple(r for r, names in enumerate(lists) for _ in names)


def visible_devices() -> list[torch.device]:
    """The CUDA cards of the mesh's default device list: this process's
    own cards, and in a process group every process's, in rank order."""
    return _gather(local_devices())[0]


def _device_list(devices: Sequence[torch.device | str] | None
                 ) -> tuple[list[torch.device], tuple[int, ...]]:
    """The devices and owning ranks of a mesh: ``devices`` (default: the
    visible CUDA cards) are this process's own, gathered in rank order."""
    local = local_devices() if devices is None else [torch.device(d) for d in devices]
    return _gather(local)


def make_y_mesh(n_devices: int | None = None,
                devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """1-D ring over the y (row) axis: the first ``n_devices`` of
    ``devices`` (default: the visible CUDA cards; all of them when
    ``n_devices`` is None).  In a process group ``devices`` are this
    process's own, and the mesh takes the first ``n_devices`` of every
    process's, in rank order."""
    devs, ranks = _device_list(devices)
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"requested {n} devices, only {len(devs)} available")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    return Mesh(tuple(devs[:n]), (n, 1), torus=False, ranks=ranks[:n])


def make_yx_mesh(my: int, mx: int,
                 devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """2-D torus: rows sharded over ``my`` devices, columns over ``mx``,
    from the first my * mx of ``devices`` (default: the visible CUDA
    cards)."""
    devs, ranks = _device_list(devices)
    if my * mx > len(devs):
        raise ValueError(f"requested {my}x{mx} devices, only {len(devs)} available")
    if my < 1 or mx < 1:
        raise ValueError(f"a mesh needs at least one device per axis, got {my}x{mx}")
    return Mesh(tuple(devs[: my * mx]), (my, mx), torus=True, ranks=ranks[: my * mx])
