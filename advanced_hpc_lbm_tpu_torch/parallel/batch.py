"""Batched independent runs: the data-parallel axis.

The counterpart of ``advanced_hpc_lbm_tpu.parallel.batch``.  The
reference replicates whole runs at the cluster level (its array job runs
independent executions of the same deck as separate Slurm tasks); here B
decks run side by side along a leading batch axis:

* on one device, the ``fused`` step over ``(B, 9, ny, nx)`` states and
  ``(B, ny, nx)`` obstacle masks, one set of batched PyTorch ops per step
  for all B decks (where the JAX package ``vmap``s its jnp ``fused_step``);
* over several devices, the batch axis cut into equal contiguous parts,
  one per device (a device may repeat), each integrating its own decks
  with no exchange between them; the launches of all parts are issued
  before any result is gathered, so the devices run side by side.

All decks of a batch share ``params``; they differ by obstacle geometry
and/or initial state.  The hand-written kernels belong to the single-run
backends: a step function of a kernel module is refused, as the JAX
module refuses a Pallas step.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from advanced_hpc_lbm_tpu_torch.ops import fused, reference
from advanced_hpc_lbm_tpu_torch.params import LBMParams

__all__ = ["batch_initial_state", "batch_run", "replicate"]

# the modules of the hand-written kernels' wrappers
_KERNEL_MODULES = tuple(
    f"advanced_hpc_lbm_tpu_torch.ops.{name}"
    for name in ("step_kernel", "resident", "kstep_kernel", "stream_kernel", "local_kernel")
)


def batch_initial_state(params: LBMParams, batch: int,
                        device: torch.device | str = "cuda") -> torch.Tensor:
    """(B, 9, ny, nx) equilibrium-at-rest states on ``device``: every
    reference run starts identically."""
    f0 = reference.initial_state(params, device)
    return f0[None].expand(batch, *f0.shape).contiguous()


def replicate(obstacles: torch.Tensor | np.ndarray, batch: int) -> torch.Tensor:
    """Stack one (ny, nx) obstacle mask B times: the reference array job's
    identical runs."""
    obst = torch.as_tensor(np.asarray(obstacles) if isinstance(obstacles, np.ndarray)
                           else obstacles)
    return obst[None].expand(batch, *obst.shape).contiguous()


def batch_run(
    f0: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    *,
    n_iters: int | None = None,
    step_fn=fused.fused_step,
    devices: Sequence[torch.device | str] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Integrate B independent decks.

    Args:
      f0: (B, 9, ny, nx) initial distributions (``batch_initial_state``).
      obstacles: (B, ny, nx) bool masks (``replicate`` or distinct decks).
      params: shared run parameters.
      n_iters: steps (default ``params.max_iters``).
      step_fn: the single-step function of the loop, which must take a
        leading batch axis (the ``fused`` step by default).
      devices: optional data parallelism: the batch axis cut into
        ``len(devices)`` equal parts, part i on ``devices[i]`` (a device
        may repeat).  B must divide evenly over them.  Default: ``f0``'s
        device.

    Returns:
      (f_finals (B, 9, ny, nx), av_vels (B, n_iters)), batch order
      preserved, on ``devices[0]`` (or ``f0``'s device).
    """
    if f0.dim() != 4 or obstacles.dim() != 3 or f0.shape[0] != obstacles.shape[0]:
        raise ValueError(
            f"expected batched (B,9,ny,nx) f0 and (B,ny,nx) obstacles, got "
            f"{tuple(f0.shape)} and {tuple(obstacles.shape)}"
        )
    if getattr(step_fn, "__module__", "") in _KERNEL_MODULES:
        raise ValueError(
            f"step_fn {step_fn.__name__!r} is a hand-written kernel's wrapper and "
            "takes no batch axis; use the fused_step (default): the kernels belong "
            "to the single-run backends"
        )
    obstacles = obstacles.to(torch.bool)
    if devices is None:
        devices = [f0.device]
    devices = [torch.device(d) for d in devices]
    if f0.shape[0] % len(devices):
        raise ValueError(
            f"batch {f0.shape[0]} not divisible over {len(devices)} devices"
        )
    part = f0.shape[0] // len(devices)
    outs = []
    with torch.no_grad():
        for i, d in enumerate(devices):
            rows = slice(i * part, (i + 1) * part)
            outs.append(fused.run_simulation(f0[rows].to(d), obstacles[rows].to(d), params,
                                             n_iters=n_iters, step_fn=step_fn))
    home = devices[0]
    return (torch.cat([f.to(home) for f, _ in outs]),
            torch.cat([av.to(home) for _, av in outs]))
