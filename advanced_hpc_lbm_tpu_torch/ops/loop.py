"""The run loop under every single-device kernel: the step, K-step,
stream and resident kernels' runs all go through :func:`run_passes`, so
that their per-step ||u|| sums, and with them the bit-exact agreement of
their av histories, have one form.
"""

from __future__ import annotations

import contextlib
from collections.abc import Callable

import torch

from advanced_hpc_lbm_tpu_torch.utils import profiling

# Steps of ||u|| partials held before they are summed.
CHUNK = 1000


def chunk_passes(passes: int, steps: int, chunk: int = CHUNK) -> int:
    """Passes of ``steps`` steps whose partials a chunk holds: ``chunk //
    steps``, or the run's ``passes`` where fewer, and at least one.  A
    ``whole`` launch of :func:`run_passes` takes a chunk's passes."""
    return max(1, min(chunk // steps, passes))


def run_passes(
    bufs: tuple[torch.Tensor, torch.Tensor],
    launcher: Callable[[], Callable],
    iters: int,
    n_fluid: torch.Tensor,
    *,
    tiles: int,
    counter: Callable[[], int],
    steps: int = 1,
    whole: bool = False,
    chunk: int = CHUNK,
    tail: Callable | None = None,
    **attrs,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``iters`` steps from ``bufs[0]``: (f_final, av_vels (iters,)).

    A pass takes the state ``steps`` steps on from one buffer into the
    other (one tensor twice: in place), writing ``tiles`` ||u|| partials
    a step.  ``launcher()`` (under the device guard, once a run) gives
    ``launch(src, dst, partials)``: a pass, ``partials`` (tiles,) or
    (steps, tiles); with ``whole``, the next n passes of a chunk
    (:func:`chunk_passes`), ``src`` into ``dst`` and back, ``partials`` (n,
    tiles) or (n, steps, tiles): the resident kernels' 1-step passes, the
    K-step kernel's K-step ones.  A chunk's partials stay on the device
    until it is full, so the loop neither syncs nor allocates.  The last
    ``iters % steps`` steps run on ``tail(f, spare, n) -> (f, av)``, the
    step kernel's run with the other buffer spare (None in place).  The
    span carries ``attrs`` and, as ``launches``, the growth of
    ``counter()``, the module's launch counts.
    """
    device = bufs[0].device
    passes = iters // steps
    rows = chunk_passes(passes, steps, chunk)
    per = rows if whole else 1  # passes per launch
    partials = torch.empty((rows, tiles) if steps == 1 else (rows, steps, tiles),
                           dtype=torch.float32, device=device)
    av = torch.empty(iters, dtype=torch.float32, device=device)
    with (profiling.span("lbm.ops.loop", **attrs) as sp,
          torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()):
        before = counter()
        launch = launcher()
        for p in range(0, passes, per):
            n, r = min(per, passes - p), p % rows
            launch(bufs[p % 2], bufs[(p + 1) % 2], partials[r:r + n] if whole else partials[r])
            if r + n == rows or p + n == passes:
                done = partials[:r + n]
                torch.sum(done, dim=done.dim() - 1,
                          out=av[(p - r) * steps:(p + n) * steps].view(done.shape[:-1]))
        sp.set(launches=counter() - before)
    av[:passes * steps] /= n_fluid
    f = bufs[passes % 2]
    if passes * steps < iters:
        spare = None if bufs[0] is bufs[1] else bufs[(passes + 1) % 2]
        f, av[passes * steps:] = tail(f, spare, iters - passes * steps)
    return f, av
