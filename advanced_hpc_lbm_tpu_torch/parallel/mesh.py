"""Device meshes: a 1-D ring or a (my, mx) torus of ``torch.device``s.

The counterpart of ``advanced_hpc_lbm_tpu.parallel.mesh`` (``make_y_mesh``,
``make_yx_mesh``).  A mesh is a row-major list of devices in which a device
may appear more than once: several shards then live on one device, in
separate allocations, with real halo copies between them.  That lays a
ring or a torus over the CPU (the tests) or over one card, as the JAX tests
lay one over ``--xla_force_host_platform_device_count`` virtual devices.
By default a mesh takes the visible CUDA cards, one shard each.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` (my, mx) devices, row-major in ``devices``.  A 1-D ring is
    (n, 1) with ``torus`` False: rows sharded, x periodic on every shard.
    A torus shards rows over my and columns over mx."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, int]
    torus: bool

    @property
    def size(self) -> int:
        return len(self.devices)

    def index(self, i: int, j: int = 0) -> int:
        """Flat index of the shard at mesh position (i, j), both periodic."""
        my, mx = self.shape
        return (i % my) * mx + j % mx


def visible_devices() -> list[torch.device]:
    """The CUDA cards PyTorch sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device_list(devices: Sequence[torch.device | str] | None) -> list[torch.device]:
    return visible_devices() if devices is None else [torch.device(d) for d in devices]


def make_y_mesh(n_devices: int | None = None,
                devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """1-D ring over the y (row) axis: the first ``n_devices`` of
    ``devices`` (default: the visible CUDA cards; all of them when
    ``n_devices`` is None)."""
    devs = _device_list(devices)
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"requested {n} devices, only {len(devs)} available")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    return Mesh(tuple(devs[:n]), (n, 1), torus=False)


def make_yx_mesh(my: int, mx: int,
                 devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """2-D torus: rows sharded over ``my`` devices, columns over ``mx``,
    from the first my * mx of ``devices`` (default: the visible CUDA
    cards)."""
    devs = _device_list(devices)
    if my * mx > len(devs):
        raise ValueError(f"requested {my}x{mx} devices, only {len(devs)} available")
    if my < 1 or mx < 1:
        raise ValueError(f"a mesh needs at least one device per axis, got {my}x{mx}")
    return Mesh(tuple(devs[: my * mx]), (my, mx), torus=True)
