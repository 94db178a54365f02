"""One fused D2Q9-BGK step per launch: the hand-written CUDA kernel, its
wrapper and its plain PyTorch version.

The port's counterpart of ``advanced_hpc_lbm_tpu.ops.pallas_step``
(``pallas_fused_step`` and its kernel ``_step_kernel``).  :func:`step` is
the wrapper: on a CUDA tensor it launches ``csrc/step_kernel.cu`` (built at
first use by :mod:`._build`) and adds one to :data:`launches`; on a CPU
tensor it runs :func:`plain_step`, the same math in plain PyTorch
(:mod:`.kernel_common` plus ``torch.roll``).  A CUDA tensor never falls back
to the plain version: the launch happens or the wrapper raises.

Each step writes the next state out of place and one ||u|| partial sum per
kernel thread block (BLOCK_X x BLOCK_Y cells, pre-collision moments, fluid
cells only) in row-major block order.  :func:`run` runs it under
:func:`.loop.run_passes`, one launch per step.
"""

from __future__ import annotations

import contextlib
import itertools

import torch
import torch.nn.functional as F

from advanced_hpc_lbm_tpu_torch.ops import kernel_common, lattice, library, loop
from advanced_hpc_lbm_tpu_torch.params import LBMParams

# Thread-block shape of the kernel (kBlockX, kBlockY in csrc/step_kernel.cu;
# _library() checks that the two agree).  One ||u|| partial per block.
BLOCK_X, BLOCK_Y = 32, 8
_library = library.checked(("lbm_step_block_shape", (BLOCK_X, BLOCK_Y), "kernel block"))

CHUNK = loop.CHUNK

# Kernel launches made by this module since the count was last reset.
launches = 0


def num_partials(ny: int, nx: int) -> int:
    """Partial sums one step writes: one per thread block."""
    return -(-ny // BLOCK_Y) * -(-nx // BLOCK_X)


def prepare_obstacles(obstacles: torch.Tensor) -> torch.Tensor:
    """The (ny, nx) obstacle mask as the kernel takes it: contiguous uint8,
    nonzero = blocked; a uint8 mask is taken as prepared.  Cast once,
    outside the run loop."""
    return obstacles if obstacles.dtype == torch.uint8 else obstacles.to(torch.uint8).contiguous()


def block_sums(norm: torch.Tensor, by: int = BLOCK_Y, bx: int = BLOCK_X) -> torch.Tensor:
    """Sum a (ny, nx) plane over tiles of by x bx cells (the kernel's
    thread blocks by default), row-major."""
    ny, nx = norm.shape
    gy, gx = -(-ny // by), -(-nx // bx)
    padded = F.pad(norm, (0, gx * bx - nx, 0, gy * by - ny))
    return padded.reshape(gy, by, gx, bx).sum(dim=(1, 3)).reshape(-1)


def plain_step(
    f: torch.Tensor,
    mask: torch.Tensor,
    params: LBMParams,
    *,
    out: torch.Tensor,
    partials: torch.Tensor,
) -> None:
    """The kernel's step in plain PyTorch, on any device: force row ny-2 of
    the pre-stream state, pull-stream with periodic wrap, then the pairwise
    BGK relaxation and bounce-back of :func:`kernel_common.collide`."""
    ny = f.shape[1]
    obst = mask != 0
    accel_row = (torch.arange(ny, device=f.device) == ny - 2)[:, None]
    planes = kernel_common.forced(list(f.unbind(0)), obst, accel_row, params)
    streamed = [
        torch.roll(p, shifts=(int(lattice.CY[k]), int(lattice.CX[k])), dims=(0, 1))
        for k, p in enumerate(planes)
    ]
    new, u_sq = kernel_common.collide(streamed, obst, params)
    torch.stack(new, out=out)
    partials.copy_(block_sums(torch.where(obst, 0.0, torch.sqrt(u_sq))))


def prepare(device: torch.device | str) -> None:
    """Build and load the kernel library and load the kernel onto ``device``
    without launching it, so that the first step pays no build or load."""
    library.on_device(device, lambda: _library().lbm_step_prepare(), "loading the step kernel")


def _launcher(f: torch.Tensor, mask: torch.Tensor, params: LBMParams):
    """A function ``(src, dst, partials_row) -> None`` that runs one step on
    tensors shaped like ``f``: the kernel on CUDA, the plain version on the
    CPU.  Arguments are validated by the caller, once."""
    if f.device.type == "cpu":
        def one(src, dst, prow):
            plain_step(src, mask, params, out=dst, partials=prow)
        return one
    if f.device.type != "cuda":
        raise ValueError(f"no step kernel for device {f.device}")
    lib = _library()
    _, ny, nx = f.shape
    consts = library.consts(params)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    mask_ptr = mask.data_ptr()

    def one(src, dst, prow):
        global launches
        err = lib.lbm_step(src.data_ptr(), dst.data_ptr(), mask_ptr,
                           prow.data_ptr(), ny, nx, *consts, stream)
        library.check(err, "step kernel launch")
        launches += 1
    return one


def step(
    f: torch.Tensor,
    mask: torch.Tensor,
    params: LBMParams,
    *,
    out: torch.Tensor,
    partials: torch.Tensor,
) -> None:
    """One step, out of place: ``out`` gets the next state and ``partials``
    (``num_partials(ny, nx)`` float32) the per-block ||u|| sums.  Launches
    the kernel for a CUDA tensor, runs :func:`plain_step` for a CPU one."""
    library.validate_pass(f, mask, out, partials, (num_partials(*f.shape[1:]),))
    with torch.cuda.device(f.device) if f.is_cuda else contextlib.nullcontext():
        _launcher(f, mask, params)(f, out, partials)


def fused_step(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    n_fluid: torch.Tensor,
    params: LBMParams,
    *,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for :func:`fused.fused_step` backed by the kernel: returns
    (f_next, av_vel).  Takes a bool or a prepared uint8 mask."""
    mask = prepare_obstacles(obstacles)
    out = torch.empty_like(f) if out is None else out
    partials = torch.empty(num_partials(*f.shape[1:]), dtype=torch.float32, device=f.device)
    step(f, mask, params, out=out, partials=partials)
    return out, partials.sum() / n_fluid


def run(
    f0: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    *,
    n_iters: int | None = None,
    collect_density: bool = False,
    chunk: int = CHUNK,
    donate: bool = False,
    spare: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """Run the main loop, one kernel launch per step, ping-ponging two
    state buffers.  ``f0`` is not modified, unless ``donate`` (see
    :func:`.library.buffers`).

    Returns (f_final, av_vels[(n_iters,)]), plus the per-step total
    densities when ``collect_density``; all stay on ``f0``'s device.
    """
    iters = params.max_iters if n_iters is None else n_iters
    mask = prepare_obstacles(obstacles)
    _, ny, nx = f0.shape
    bufs = library.buffers(f0, donate, spare)
    library.validate(bufs[0], mask, bufs[1])
    dens = torch.empty(iters, dtype=torch.float32, device=f0.device) if collect_density else None

    def launcher():
        one = _launcher(bufs[0], mask, params)
        if not collect_density:
            return one
        t = itertools.count()

        def one_and_density(src, dst, prow):
            one(src, dst, prow)
            dens[next(t)] = dst.sum()
        return one_and_density

    f_final, av = loop.run_passes(bufs, launcher, iters, (mask == 0).sum().to(torch.float32),
                                  tiles=num_partials(ny, nx), counter=lambda: launches,
                                  chunk=chunk)
    return (f_final, av, dens) if collect_density else (f_final, av)
