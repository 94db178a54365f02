"""The whole run in one launch per chunk: the cooperative persistent CUDA
kernel, its wrapper and its plain PyTorch version.

The port's counterpart of ``advanced_hpc_lbm_tpu.ops.resident``
(``resident_run`` and its kernel ``_chunk_kernel``).  :func:`resident_run`
is the wrapper: on a CUDA tensor it launches ``csrc/resident_kernel.cu``
once per chunk of at most ``chunk`` steps and adds one to :data:`launches`
per launch; on a CPU tensor it runs :func:`plain_run`, a loop of
``step_kernel.plain_step``.  A CUDA tensor never falls back to the plain
version: the launch happens or the wrapper raises (a device without
cooperative launches, a grid too large to be co-resident, a failed launch).

Each step runs the step kernel's per-cell code on the step kernel's 32x8
tiles and writes the same per-tile ||u|| partials, so the state and the av
history equal the ``step`` backend's bit for bit.  The JAX kernel keeps
the state in VMEM and clamps a chunk to 1500 steps for its SMEM budget;
here the state ping-pongs between two buffers in device memory, and the
chunk only bounds the (chunk, tiles) partials buffer.
"""

from __future__ import annotations

import contextlib

import torch

from advanced_hpc_lbm_tpu_torch.ops import step_kernel
from advanced_hpc_lbm_tpu_torch.params import LBMParams

# Steps per launch: bounds the partials buffer (16 MB at 1024x1024).
CHUNK = 1000

# Kernel launches made by this module since the count was last reset.
launches = 0

prepare_obstacles = step_kernel.prepare_obstacles


def prepare(device: torch.device | str) -> None:
    """Build and load the kernel library and load the resident kernel onto
    ``device`` without launching it; raises if the device takes no
    cooperative launches."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    lib = step_kernel._library()
    with torch.cuda.device(device):
        torch.zeros(1, device=device)  # create the context first
        step_kernel._raise_on(lib, lib.lbm_resident_prepare(), "loading the resident kernel")


def plain_run(
    bufs: tuple[torch.Tensor, torch.Tensor],
    mask: torch.Tensor,
    params: LBMParams,
    n_steps: int,
    partials: torch.Tensor,
) -> None:
    """One chunk in plain PyTorch: ``n_steps`` plain steps on the state in
    ``bufs[0]``, ping-ponging with ``bufs[1]`` (the state ends in
    ``bufs[n_steps % 2]``), partials row t for step t, as the kernel."""
    for t in range(n_steps):
        step_kernel.plain_step(bufs[t % 2], mask, params,
                               out=bufs[(t + 1) % 2], partials=partials[t])


def _chunk_launcher(f: torch.Tensor, mask: torch.Tensor, params: LBMParams,
                    blocks: int = 0):
    """A function ``(bufs, n_steps, partials) -> None`` that runs one chunk
    on tensors shaped like ``f``: the kernel on CUDA, the plain version on
    the CPU.  ``blocks`` is a test hook: > 0 overrides the cooperative
    grid size (otherwise the co-resident limit), the only way to make the
    card refuse a launch; ``resident_run`` never passes it."""
    if f.device.type == "cpu":
        return lambda bufs, n, part: plain_run(bufs, mask, params, n, part)
    if f.device.type != "cuda":
        raise ValueError(f"no resident kernel for device {f.device}")
    lib = step_kernel._library()
    _, ny, nx = f.shape
    consts = step_kernel._consts(params)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    mask_ptr = mask.data_ptr()

    def chunk(bufs, n, part):
        global launches
        err = lib.lbm_resident_chunk(bufs[0].data_ptr(), bufs[1].data_ptr(), mask_ptr,
                                     part.data_ptr(), ny, nx, n, blocks,
                                     *consts, stream)
        step_kernel._raise_on(lib, err, "resident kernel launch")
        launches += 1
    return chunk


def resident_run(
    f0: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    *,
    n_iters: int | None = None,
    chunk: int = CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the whole main loop, one launch per chunk of at most ``chunk``
    steps.  ``f0`` is not modified.

    Returns (f_final, av_vels[(n_iters,)]) on ``f0``'s device, like the
    JAX ``resident_run``.
    """
    iters = params.max_iters if n_iters is None else n_iters
    mask = obstacles if obstacles.dtype == torch.uint8 else prepare_obstacles(obstacles)
    _, ny, nx = f0.shape
    n_fluid = (mask == 0).sum().to(torch.float32)
    bufs = (f0.clone(memory_format=torch.contiguous_format),
            torch.empty_like(f0, memory_format=torch.contiguous_format))
    rows = max(1, min(chunk, iters))
    partials = torch.empty((rows, step_kernel.num_partials(ny, nx)),
                           dtype=torch.float32, device=f0.device)
    av = torch.empty(iters, dtype=torch.float32, device=f0.device)
    step_kernel._validate(bufs[0], mask, bufs[1], partials)

    with torch.cuda.device(f0.device) if f0.is_cuda else contextlib.nullcontext():
        run_chunk = _chunk_launcher(bufs[0], mask, params)
        for t0 in range(0, iters, rows):
            n = min(rows, iters - t0)
            # the chunk starts on the buffer that holds step t0's state
            run_chunk((bufs[t0 % 2], bufs[(t0 + 1) % 2]), n, partials)
            torch.sum(partials[:n], dim=1, out=av[t0:t0 + n])
    av /= n_fluid
    return bufs[iters % 2], av
