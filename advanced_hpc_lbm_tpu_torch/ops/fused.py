"""The fused timestep in plain PyTorch, and the run loop around a step.

The counterpart of ``advanced_hpc_lbm_tpu.ops.fused``: :func:`fused_step`
composes the reference ops in one pass (forcing, pull-stream, BGK collide,
bounce-back) and reduces ||u|| over the *post*-collision moments, as the
JAX function does.  :func:`run_simulation` runs ``max_iters`` such steps as
a Python loop that ping-pongs two preallocated state buffers and keeps the
av history on the device.  Both take an optional leading batch axis of
independent decks (``parallel/batch.py``).  The hand-written kernel's own
loop is :func:`advanced_hpc_lbm_tpu_torch.ops.step_kernel.run`.
"""

from __future__ import annotations

import torch

from advanced_hpc_lbm_tpu_torch.ops import lattice, reference
from advanced_hpc_lbm_tpu_torch.params import LBMParams

_OPP = torch.from_numpy(lattice.OPP).long()


def fused_step(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    n_fluid: torch.Tensor,
    params: LBMParams,
    *,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused collide-and-stream step.

      1. forcing on row ny-2 of the *pre-stream* state;
      2. pull-stream with periodic wrap;
      3. obstacle cells take the reflected pull, fluid cells relax toward
         the equilibrium of the streamed moments;
      4. av-velocity is the mean ||u|| of the *post-collision* state over
         fluid cells.

    Args:
      f: (..., 9, ny, nx) float32 distributions: one deck, or a batch of
        independent decks along a leading axis.
      obstacles: (..., ny, nx) bool.
      n_fluid: float32 (...) tensor, the count of fluid cells of each deck.
      params: run parameters.
      out: optional buffer like ``f`` for the next state (must not be f).

    Returns (f_next, av_vel), av_vel a float32 (...) tensor.
    """
    f = reference.accelerate_flow(f, obstacles, params.accel_w1, params.accel_w2)
    streamed = reference.stream_pull(f)

    rho, u_x, u_y = reference.macroscopic(streamed)
    feq = reference.equilibrium(rho, u_x, u_y)
    relaxed = streamed + float(params.omega_f32) * (feq - streamed)

    reflected = streamed[..., _OPP.to(streamed.device), :, :]
    if out is None:
        out = torch.empty_like(streamed)
    torch.where(obstacles[..., None, :, :], reflected, relaxed, out=out)

    _, v_x, v_y = reference.macroscopic(out)
    norm = torch.where(obstacles, 0.0, torch.sqrt(v_x * v_x + v_y * v_y))
    if norm.dim() == 2:
        return out, torch.sum(norm) / n_fluid
    # each deck of a batch summed on its own, as one deck is: a reduction
    # over the batched tensor splits its sums by the batch's size on a
    # card, so a deck's av would depend on the batch it ran in
    decks = norm.reshape(-1, *norm.shape[-2:])
    tot_u = torch.stack([torch.sum(d) for d in decks]).reshape(norm.shape[:-2])
    return out, tot_u / n_fluid


def pipeline_step(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    n_fluid: torch.Tensor,
    params: LBMParams,
    *,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`reference.timestep_pipeline` with the step signature of
    :func:`fused_step` (the ``pipeline`` backend)."""
    del n_fluid
    f_next, av = reference.timestep_pipeline(f, obstacles, params)
    if out is None:
        return f_next, av
    return out.copy_(f_next), av


def run_simulation(
    f0: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    *,
    n_iters: int | None = None,
    step_fn=fused_step,
    collect_density: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Run the main loop on ``f0``'s device.  ``f0`` is not modified.
    With a leading batch axis (``f0`` (B, 9, ny, nx), ``obstacles`` (B, ny,
    nx)) the decks run side by side, for a step function that takes one
    (``fused_step``).

    Returns (f_final, av_vels[(..., n_iters)]), plus the per-step total
    densities when ``collect_density`` (one deck).  Nothing is brought to
    the host.
    """
    iters = params.max_iters if n_iters is None else n_iters
    n_fluid = torch.sum(~obstacles, dim=(-2, -1)).to(torch.float32)
    bufs = (f0.clone(), torch.empty_like(f0))
    av = torch.empty((*f0.shape[:-3], iters), dtype=torch.float32, device=f0.device)
    dens = torch.empty(iters, dtype=torch.float32, device=f0.device) if collect_density else None
    for t in range(iters):
        dst = bufs[(t + 1) % 2]
        _, av[..., t] = step_fn(bufs[t % 2], obstacles, n_fluid, params, out=dst)
        if collect_density:
            dens[t] = reference.total_density(dst)
    f_final = bufs[iters % 2]
    return (f_final, av, dens) if collect_density else (f_final, av)
