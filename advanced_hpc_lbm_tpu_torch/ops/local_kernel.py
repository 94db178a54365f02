"""One step, or K steps, of one shard of a device mesh: the hand-written
CUDA kernels, their wrappers and their plain PyTorch versions.

The port's counterpart of ``advanced_hpc_lbm_tpu.ops.pallas_local``
(``local_step``, ``local_step_2d``, ``local_ca_steps`` and the kernels
``_local_kernel``, ``_local2d_kernel``, ``_local_ca_kernel``).  On a CUDA
tensor each wrapper launches its kernel and adds one to its count
(:data:`launches`, :data:`launches_2d`, :data:`ca_launches`); on a CPU
tensor it runs its plain version (:func:`plain_local_step`,
:func:`plain_local_ca_steps`).  A CUDA tensor never falls back to the
plain version: the launch happens or the wrapper raises.

Each wrapper takes the shard's ghosted window, as ``parallel/halo.py``
keeps it, where the TPU kernels take halo operands:

  local_step      (9, ly+2, nx): rows 0 and ly+1 are the halo rows (the
                  TPU kernel's ``top_halo`` / ``bot_halo``), x periodic;
                  ``csrc/local_kernel.cu``
  local_step_2d   (9, ly+2, lx+2): also columns 0 and lx+1, the
                  row-extended edge columns of the x neighbours, corners
                  included (where the TPU kernel takes six pre-shifted
                  columns); ``csrc/local_kernel.cu``
  local_ca_steps  (9, ly+2K, nx): own rows [K, K+ly), K ghost rows each
                  side; the K-step kernel's local form,
                  ``csrc/kstep_kernel.cu``

Windows and outputs may be views with any plane and row strides (each row
contiguous), so that the runner hands over slices of its window buffers
and nothing is copied.  ``mask`` is the window's uint8 encoded mask, the
spatial shape of the window: +1 obstacle, +2 forcing cell
(:func:`stream_kernel.encode_masks`) -- the TPU kernels' obstacle operand,
their ``accel_local_row`` (-1 off-shard) and their forcing plane in one.
Forcing is a row property (row ny-2; ``encode_masks`` marks whole rows):
the 1-step forms read a row's +2 from its column 0.  Every kernel forces at
the pull source, so a pull from a halo cell of row ny-2 is forced from that
cell's own bits and values, as a pull from an own cell is.

Partials: the 1-step forms write one ||u|| sum per BLOCK_X x BLOCK_Y block
of own cells (:func:`num_partials`), the K-step form one per step and
TILE_X x TILE_Y tile of own cells ((K, :func:`num_tiles`)), from the
pre-collision moments.
"""

from __future__ import annotations

import torch

from advanced_hpc_lbm_tpu_torch.ops import (
    kernel_common, kstep_kernel, lattice, library, step_kernel,
)
from advanced_hpc_lbm_tpu_torch.ops.stream_kernel import FORCING, OBSTACLE
from advanced_hpc_lbm_tpu_torch.params import LBMParams

BLOCK_X, BLOCK_Y = step_kernel.BLOCK_X, step_kernel.BLOCK_Y
TILE_X, TILE_Y = kstep_kernel.TILE_X, kstep_kernel.TILE_Y
K_RANGE = kstep_kernel.K_RANGE
_library = library.checked(("lbm_local_block_shape", (BLOCK_X, BLOCK_Y), "local kernel block"),
                           ("lbm_kstep_tile_shape", (TILE_X, TILE_Y), "kernel tile"))

# Kernel launches made by this module since the counts were last reset:
# the 1-D and 2-D step forms, and the K-step form.
launches = 0
launches_2d = 0
ca_launches = 0


def num_partials(ly: int, lx: int) -> int:
    """Partial sums one step of a (ly, lx) block writes: one per block."""
    return step_kernel.num_partials(ly, lx)


def num_tiles(ly: int, nx: int) -> int:
    """Tiles of one K-step pass of a (ly, nx) shard: one partial each per
    step."""
    return kstep_kernel.num_tiles(ly, nx)


def plain_local_step(
    window: torch.Tensor,
    mask: torch.Tensor,
    params: LBMParams,
    *,
    out: torch.Tensor,
    partials: torch.Tensor,
    torus: bool = False,
) -> None:
    """The 1-step kernels in plain PyTorch, on any device: force the
    window's rows whose mask says +2 in column 0 (the guard at each cell),
    pull the own block from them (rows from the halo rows; columns rolled
    periodically on a ring, from the halo columns on a torus), then the
    pairwise BGK relaxation and bounce-back of
    :func:`kernel_common.collide`."""
    _, h, w = window.shape
    ly = h - 2
    lx, c0 = (w - 2, 1) if torus else (w, 0)
    obst = (mask & OBSTACLE) != 0
    accel = (mask[:, :1] & FORCING) != 0  # a row property, read from column 0
    planes = kernel_common.forced(list(window.unbind(0)), obst, accel, params)
    streamed = []
    for k, p in enumerate(planes):
        cy, cx = int(lattice.CY[k]), int(lattice.CX[k])
        rows = p[1 - cy:1 - cy + ly]
        streamed.append(rows[:, 1 - cx:1 - cx + lx] if torus
                        else torch.roll(rows, shifts=cx, dims=1))
    own_obst = obst[1:1 + ly, c0:c0 + lx]
    new, u_sq = kernel_common.collide(streamed, own_obst, params)
    out.copy_(torch.stack(new))
    partials.copy_(step_kernel.block_sums(torch.where(own_obst, 0.0, torch.sqrt(u_sq))))


def plain_local_ca_steps(
    window: torch.Tensor,
    mask: torch.Tensor,
    params: LBMParams,
    k: int,
    *,
    out: torch.Tensor,
    partials: torch.Tensor,
) -> None:
    """The K-step kernel's local form in plain PyTorch, on any device, as
    the TPU kernel computes it: K calls of
    :func:`kernel_common.lean_window_step` over the whole (ly+2K, nx)
    window, whose wrapping rolls leave garbage only in rows that the
    shrinking valid region gives up; then the own rows to ``out`` and
    their fluid cells' ||u|| per step and tile to ``partials`` (k,
    tiles)."""
    _, h, nx = window.shape
    ly = h - 2 * k
    obst, accel = (mask & OBSTACLE) != 0, (mask & FORCING) != 0
    own_obst = obst[k:k + ly]
    src = window.clone(memory_format=torch.contiguous_format)
    dst = torch.empty_like(src)
    for s in range(k):
        u_sq = kernel_common.lean_window_step(src, dst, obst, accel, params, h, nx)
        norm = torch.where(own_obst, 0.0, torch.sqrt(u_sq[k:k + ly]))
        partials[s] = step_kernel.block_sums(norm, TILE_Y, TILE_X)
        src, dst = dst, src
    out.copy_(src[:, k:k + ly])


def prepare(device: torch.device | str, ks: tuple[int, ...] = ()) -> None:
    """Build and load the kernel library and load the 1-step forms (and the
    K-step form for each K in ``ks``) onto ``device`` without launching
    them."""
    for k in ks:
        kstep_kernel.prepare(device, k)
    library.on_device(device, lambda: _library().lbm_local_prepare(),
                      "loading the local kernel")


def _span(t: torch.Tensor) -> tuple[int, int]:
    """Byte range [start, end) that a strided view touches."""
    end = t.data_ptr() + t.element_size() * (
        1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride())))
    return t.data_ptr(), end


def _validate(window: torch.Tensor, mask: torch.Tensor, out: torch.Tensor,
              out_shape: tuple[int, ...]) -> None:
    if window.dim() != 3 or window.shape[0] != lattice.NSPEEDS or window.dtype != torch.float32:
        raise ValueError(f"window must be (9, h, w) float32, got {tuple(window.shape)} "
                         f"{window.dtype}")
    if mask.shape != window.shape[1:] or mask.dtype != torch.uint8:
        raise ValueError(f"mask must be uint8 {tuple(window.shape[1:])}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if tuple(out.shape) != out_shape or out.dtype != torch.float32:
        raise ValueError(f"out must be {out_shape} float32, got {tuple(out.shape)}")
    for t in (window, mask, out):
        if t.stride(-1) != 1:
            raise ValueError("window, mask and out rows must be contiguous")
        if t.device != window.device:
            raise ValueError(f"tensors on {t.device} and {window.device}")
    (a0, a1), (b0, b1) = _span(window), _span(out)
    if a0 < b1 and b0 < a1:
        raise ValueError("out overlaps the window: the step is out of place")
    if window.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no local kernel for device {window.device}")


def _checked(one, shape: tuple[int, ...], device: torch.device):
    """``one(partials)`` with the partials' shape, type and device checked."""
    def run(partials: torch.Tensor) -> None:
        if (tuple(partials.shape) != shape or partials.dtype != torch.float32
                or not partials.is_contiguous() or partials.device != device):
            raise ValueError(f"partials must be contiguous {shape} float32 on {device}")
        one(partials)
    return run


def step_launcher(window: torch.Tensor, mask: torch.Tensor, params: LBMParams,
                  out: torch.Tensor, *, torus: bool = False):
    """A function ``(partials) -> None`` that runs one step of the 1-D
    (``torus`` False) or 2-D local kernel from ``window`` into ``out``,
    validated once here: the kernel on CUDA, the plain version on the
    CPU.  The run loop builds one per shard and buffer."""
    _, h, w = window.shape
    ly, lx = h - 2, (w - 2 if torus else w)
    _validate(window, mask, out, (lattice.NSPEEDS, ly, lx))
    shape = (num_partials(ly, lx),)
    if window.device.type == "cpu":
        return _checked(lambda part: plain_local_step(window, mask, params, out=out,
                                                      partials=part, torus=torus),
                        shape, window.device)
    lib = _library()
    # forcing is a row property (encode_masks marks whole rows): the kernel
    # reads it once per row, from column 0 of the mask
    accel_rows = (mask[:, 0] & FORCING).contiguous()
    stream = torch.cuda.current_stream(window.device).cuda_stream
    head = (window.data_ptr(), window.stride(0), window.stride(1), mask.data_ptr(),
            mask.stride(0), accel_rows.data_ptr(), out.data_ptr(), out.stride(0), out.stride(1))
    tail = (ly, lx, int(torus), *library.consts(params), stream)
    what = f"local {'2-D ' if torus else ''}kernel launch"

    def one(partials: torch.Tensor) -> None:
        global launches, launches_2d
        with torch.cuda.device(window.device):  # the stream's device
            err = lib.lbm_local_step(*head, partials.data_ptr(), *tail)
        library.check(err, what)
        if torus:
            launches_2d += 1
        else:
            launches += 1
    one.accel_rows = accel_rows  # lives as long as the launcher
    return _checked(one, shape, window.device)


def ca_launcher(window: torch.Tensor, mask: torch.Tensor, params: LBMParams, k: int,
                out: torch.Tensor):
    """A function ``(partials) -> None`` that runs K steps of the K-step
    kernel's local form from ``window`` into ``out``, validated once."""
    kstep_kernel.check_k(k)
    _, h, nx = window.shape
    ly = h - 2 * k
    if ly < 1:
        raise ValueError(f"a ({h}, {nx}) window holds no own rows at K={k}")
    _validate(window, mask, out, (lattice.NSPEEDS, ly, nx))
    for t, name in ((window, "window"), (mask, "mask"), (out, "out")):
        if t.stride(-2) != nx:
            raise ValueError(f"{name} rows must be contiguous along each plane")
    shape = (k, num_tiles(ly, nx))
    if window.device.type == "cpu":
        return _checked(lambda part: plain_local_ca_steps(window, mask, params, k, out=out,
                                                          partials=part),
                        shape, window.device)
    lib = _library()
    stream = torch.cuda.current_stream(window.device).cuda_stream
    head = (window.data_ptr(), window.stride(0), out.data_ptr(), out.stride(0), mask.data_ptr())
    tail = (ly, nx, k, *library.consts(params), stream)

    def one(partials: torch.Tensor) -> None:
        global ca_launches
        with torch.cuda.device(window.device):  # the stream's device
            err = lib.lbm_local_ca(*head, partials.data_ptr(), *tail)
        library.check(err, f"local K={k} kernel launch")
        ca_launches += 1
    return _checked(one, shape, window.device)


def local_step(
    window: torch.Tensor,
    mask: torch.Tensor,
    params: LBMParams,
    *,
    out: torch.Tensor,
    partials: torch.Tensor,
) -> None:
    """One step of a shard of a 1-D ring, out of place: ``window`` (9,
    ly+2, nx) is the own rows with a halo row above and below, ``out`` (9,
    ly, nx) gets the next own rows and ``partials`` (``num_partials(ly,
    nx)``) the per-block ||u|| sums.  Launches the kernel for a CUDA
    tensor, runs :func:`plain_local_step` for a CPU one."""
    step_launcher(window, mask, params, out)(partials)


def local_step_2d(
    window: torch.Tensor,
    mask: torch.Tensor,
    params: LBMParams,
    *,
    out: torch.Tensor,
    partials: torch.Tensor,
) -> None:
    """One step of a shard of a 2-D torus, out of place: ``window`` (9,
    ly+2, lx+2) is the own block with halo rows and halo columns (corners
    included), ``out`` (9, ly, lx) gets the next own block and ``partials``
    (``num_partials(ly, lx)``) the per-block ||u|| sums."""
    step_launcher(window, mask, params, out, torus=True)(partials)


def local_ca_steps(
    window: torch.Tensor,
    mask: torch.Tensor,
    params: LBMParams,
    k: int,
    *,
    out: torch.Tensor,
    partials: torch.Tensor,
) -> None:
    """K steps of a shard of a 1-D ring from its ghost window: ``window``
    (9, ly+2K, nx) holds own rows [K, K+ly) and K ghost rows each side,
    ``out`` (9, ly, nx) gets the own rows K steps on and ``partials`` ((k,
    ``num_tiles(ly, nx)``)) the per-step, per-tile ||u|| sums of own
    cells.  Launches the kernel for a CUDA tensor, runs
    :func:`plain_local_ca_steps` for a CPU one."""
    ca_launcher(window, mask, params, k, out)(partials)
