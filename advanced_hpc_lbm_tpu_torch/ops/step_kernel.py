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
cells only) in row-major block order.  :func:`run` keeps CHUNK steps of
partials on the device and sums them per step once a chunk is full, so the
run loop neither syncs with the host nor allocates.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from advanced_hpc_lbm_tpu_torch.ops import _build, kernel_common, lattice
from advanced_hpc_lbm_tpu_torch.params import LBMParams

# Thread-block shape of the kernel (kBlockX, kBlockY in csrc/step_kernel.cu;
# _library() checks that the two agree).  One ||u|| partial per block.
BLOCK_X, BLOCK_Y = 32, 8

# Steps of ||u|| partials held before they are summed (as resident.py's
# chunked whole-run kernel holds its per-step totals).
CHUNK = 1000

# Kernel launches made by this module since the count was last reset.
launches = 0


def num_partials(ny: int, nx: int) -> int:
    """Partial sums one step writes: one per thread block."""
    return -(-ny // BLOCK_Y) * -(-nx // BLOCK_X)


def prepare_obstacles(obstacles: torch.Tensor) -> torch.Tensor:
    """The (ny, nx) obstacle mask as the kernel takes it: contiguous uint8,
    nonzero = blocked.  Cast once, outside the run loop."""
    return obstacles.to(torch.uint8).contiguous()


def _block_sums(norm: torch.Tensor, by: int = BLOCK_Y, bx: int = BLOCK_X) -> torch.Tensor:
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
    partials.copy_(_block_sums(torch.where(obst, 0.0, torch.sqrt(u_sq))))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load()
    bx, by = ctypes.c_int(), ctypes.c_int()
    lib.lbm_step_block_shape(ctypes.byref(bx), ctypes.byref(by))
    if (bx.value, by.value) != (BLOCK_X, BLOCK_Y):
        raise RuntimeError(
            f"kernel block {bx.value}x{by.value} != wrapper's {BLOCK_X}x{BLOCK_Y}"
        )
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        name = lib.lbm_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({name})")


def prepare(device: torch.device | str) -> None:
    """Build and load the kernel library and load the kernel onto ``device``
    without launching it, so that the first step pays no build or load."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    lib = _library()
    with torch.cuda.device(device):
        torch.zeros(1, device=device)  # create the context first
        _raise_on(lib, lib.lbm_step_prepare(), "loading the step kernel")


def _consts(params: LBMParams) -> tuple[float, ...]:
    c = kernel_common.step_constants(params)
    names = ("w0_omega", "w1_omega", "w2_omega", "one_minus_omega",
             "accel_w1", "accel_w2")
    return tuple(float(c[n]) for n in names)


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
    consts = _consts(params)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    mask_ptr = mask.data_ptr()

    def one(src, dst, prow):
        global launches
        err = lib.lbm_step(src.data_ptr(), dst.data_ptr(), mask_ptr,
                           prow.data_ptr(), ny, nx, *consts, stream)
        _raise_on(lib, err, "step kernel launch")
        launches += 1
    return one


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def _validate(f: torch.Tensor, mask: torch.Tensor, *bufs: torch.Tensor) -> None:
    if f.dim() != 3 or f.shape[0] != lattice.NSPEEDS or f.dtype != torch.float32:
        raise ValueError(f"f must be (9, ny, nx) float32, got {tuple(f.shape)} {f.dtype}")
    if not f.is_contiguous():
        raise ValueError("f must be contiguous")
    if mask.shape != f.shape[1:] or mask.dtype != torch.uint8 or not mask.is_contiguous():
        raise ValueError(
            f"mask must be contiguous uint8 {tuple(f.shape[1:])}, "
            f"got {mask.dtype} {tuple(mask.shape)}"
        )
    for t in (mask, *bufs):
        if t.device != f.device:
            raise ValueError(f"tensors on {t.device} and {f.device}")
    for b in bufs:
        if _overlap(b, f):
            raise ValueError("an output buffer aliases f: the step is out of place")


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
    _validate(f, mask, out, partials)
    _, ny, nx = f.shape
    if out.shape != f.shape or out.dtype != f.dtype or not out.is_contiguous():
        raise ValueError("out must be a contiguous tensor shaped like f")
    if (partials.shape != (num_partials(ny, nx),) or partials.dtype != torch.float32
            or not partials.is_contiguous()):
        raise ValueError(f"partials must be ({num_partials(ny, nx)},) float32")
    with torch.cuda.device(f.device) if f.is_cuda else contextlib.nullcontext():
        _launcher(f, mask, params)(f, out, partials)


def buffers(f0: torch.Tensor, donate: bool = False,
            spare: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The two ping-pong state buffers of a run loop: a copy of ``f0`` and
    a new tensor; with ``donate``, ``f0`` itself (which the run then
    overwrites; it must be contiguous) and ``spare``, or a new tensor.
    Donating keeps a run at two states on the device instead of three."""
    if not donate:
        return (f0.clone(memory_format=torch.contiguous_format),
                torch.empty_like(f0, memory_format=torch.contiguous_format))
    if not f0.is_contiguous():
        raise ValueError("a donated f0 must be contiguous")
    return f0, torch.empty_like(f0) if spare is None else spare


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
    mask = obstacles if obstacles.dtype == torch.uint8 else prepare_obstacles(obstacles)
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
    :func:`buffers`).

    Returns (f_final, av_vels[(n_iters,)]), plus the per-step total
    densities when ``collect_density``; all stay on ``f0``'s device.
    """
    iters = params.max_iters if n_iters is None else n_iters
    mask = obstacles if obstacles.dtype == torch.uint8 else prepare_obstacles(obstacles)
    _, ny, nx = f0.shape
    n_fluid = (mask == 0).sum().to(torch.float32)
    bufs = buffers(f0, donate, spare)
    rows = max(1, min(chunk, iters))
    partials = torch.empty((rows, num_partials(ny, nx)), dtype=torch.float32, device=f0.device)
    av = torch.empty(iters, dtype=torch.float32, device=f0.device)
    dens = torch.empty(iters, dtype=torch.float32, device=f0.device) if collect_density else None
    _validate(bufs[0], mask, bufs[1], partials)

    with torch.cuda.device(f0.device) if f0.is_cuda else contextlib.nullcontext():
        one = _launcher(bufs[0], mask, params)
        for t in range(iters):
            dst = bufs[(t + 1) % 2]
            one(bufs[t % 2], dst, partials[t % rows])
            if collect_density:
                dens[t] = dst.sum()
            if (t + 1) % rows == 0 or t + 1 == iters:
                t0 = t - t % rows
                torch.sum(partials[: t + 1 - t0], dim=1, out=av[t0 : t + 1])
    av /= n_fluid
    f_final = bufs[iters % 2]
    return (f_final, av, dens) if collect_density else (f_final, av)

