"""Halo-exchanged domain decomposition of the step over a device mesh.

The counterpart of ``advanced_hpc_lbm_tpu.parallel.halo``.  The grid is
cut into row slabs over a 1-D ring (:func:`run_sharded`) or into blocks
over a (my, mx) torus (:func:`run_sharded_2d`); global periodicity is the
ring's (or torus's) wrap.  Where the JAX package runs one SPMD program
(``shard_map`` + ``jit``, ``ppermute`` for halos, ``psum`` for the
||u|| sums), this package is single-controller: one Python loop drives
every shard, per-shard tensors live on the mesh's devices, halos travel as
tensor copies between them, and the per-shard ||u|| sums are added in a
fixed shard order on the mesh's first device and divided by the global
fluid count.  Shard kernels (``kernel``):

  jnp     the JAX package's name for its XLA-fused local step, here plain
          PyTorch like the ``fused`` backend: the 1-step form reduces
          ||u|| from the post-collision moments (``_av_partial``), the
          K-step (``ca_steps``) and torus forms from the pre-collision
          ones, as the JAX functions do
  pallas  the hand-written local kernels (``ops/local_kernel.py``): one
          step per launch, or with ``ca_steps`` = K > 1 (ring only) K
          steps per exchange on the K-step kernel's local form
  stream  the stream kernel out of place on each shard's +-8 ghost window
          (``stream_kernel.window_ca_steps`` / ``_2d``), 8 steps per
          exchange
  auto    :func:`resolve_shard_kernel`

On the CPU the kernels run their plain versions.  The ``pallas`` and
``stream`` shards keep their state in ghosted window buffers (``_Windows``,
two per shard, ping-ponged): the exchange copies the neighbours' edge rows
(then, on a torus, the edge columns of the row-extended windows, which
carries the corners) into the ghost rows and columns, and the kernels read
the window in place.  The last ``n % K`` steps of a K-step run, and a
``--debug`` run of ``pallas`` with ``ca_steps`` or of ``stream``, run the
1-step local kernel (the JAX package runs its ``jnp`` step there).

Exchange ordering.  The kernels write the next window's own cells and read
the current one; the exchange writes the current window's ghost cells from
the neighbours' current own cells, after the launches that wrote them and
before the launches that read them.  On one device one stream orders all
of it.  Across devices, PyTorch's copy between two devices runs on the
source device's current stream after waiting for the destination's, and
makes the destination's current stream wait for the copy (``copy_`` of
CUDA tensors on two devices), which is the event ordering the exchange
needs.  That multi-card path has not run on more than one card.

Checkpointed sharded runs go through ``Simulation.run(checkpoint_every=...)``:
each segment is a runner call from the host copy of the state that the
last snapshot gathered.  Batches of independent decks are
``parallel/batch.py``.  Not ported: ``overlap`` (the overlapped 1-step
jnp schedule) and multi-process runs (``parallel/multihost.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Sequence

import numpy as np
import torch

from advanced_hpc_lbm_tpu_torch.ops import (
    kernel_common, lattice, local_kernel, reference, step_kernel, stream_kernel,
)
from advanced_hpc_lbm_tpu_torch.params import LBMParams
from advanced_hpc_lbm_tpu_torch.parallel.mesh import Mesh, make_y_mesh, make_yx_mesh

SHARD_KERNELS = ("auto", "jnp", "pallas", "stream")

# Steps of ||u|| partials held per shard before they are summed.
CHUNK = step_kernel.CHUNK

_OPP = torch.from_numpy(lattice.OPP).long()


# ---- the state of a sharded run ----------------------------------------------------

@dataclasses.dataclass
class ShardedState:
    """The (9, ny, nx) state of a sharded run, left on the mesh:
    ``shards[s]`` is the own block of shard s (row-major over the mesh), a
    view into its device's buffer."""

    mesh: Mesh
    shards: list[torch.Tensor]

    @property
    def shape(self) -> tuple[int, int, int]:
        my, mx = self.mesh.shape
        _, ly, lx = self.shards[0].shape
        return lattice.NSPEEDS, my * ly, mx * lx

    def blocks(self):
        """(rows, columns, own block) of every shard: the block is the
        state's [:, rows, columns]."""
        _, ly, lx = self.shards[0].shape
        for s, t in enumerate(self.shards):
            i, j = divmod(s, self.mesh.shape[1])
            yield slice(i * ly, (i + 1) * ly), slice(j * lx, (j + 1) * lx), t

    def numpy(self) -> np.ndarray:
        """The whole state on the host, gathered plane by plane and shard by
        shard, so that no device holds more than its own shards."""
        out = np.empty(self.shape, dtype=np.float32)
        for rows, cols, t in self.blocks():
            for k in range(lattice.NSPEEDS):
                torch.from_numpy(out[k, rows, cols]).copy_(t[k])
        return out


def _shard_sum(values: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Sum per-shard tensors in shard order on ``device``."""
    tot = values[0].to(device)
    for v in values[1:]:
        tot = tot + v.to(device)
    return tot


def _extended(x: np.ndarray, i: int, j: int, ly: int, lx: int, gy: int, gx: int) -> np.ndarray:
    """Block (i, j) of a (ny, nx) host array with gy rows and gx columns of
    its periodic neighbourhood on each side (gx = 0 and lx = nx on a ring):
    what the ring exchange builds for a loop-invariant mask, taken once
    from the whole mask."""
    ny, nx = x.shape
    x = np.take(x, (i * ly - gy + np.arange(ly + 2 * gy)) % ny, axis=0)
    if gx or lx != nx:
        x = np.take(x, (j * lx - gx + np.arange(lx + 2 * gx)) % nx, axis=1)
    return x


# ---- the jnp shard kernel: plain PyTorch -------------------------------------------

def _masked_accelerate(f, obstacles, row_mask, w1, w2):
    """Forcing as a whole-slab masked update; ``row_mask`` (ly,) selects
    global row ny-2, which lives on one shard row."""
    w1, w2 = float(w1), float(w2)
    ok = (row_mask[None, :, None] & ~obstacles[None]
          & (f[3:4] - w1 > 0.0) & (f[6:7] - w2 > 0.0) & (f[7:8] - w2 > 0.0))
    delta = torch.zeros((lattice.NSPEEDS, 1, 1), dtype=f.dtype, device=f.device)
    delta[1], delta[5], delta[8] = w1, w2, w2
    delta[3], delta[6], delta[7] = -w1, -w2, -w2
    return f + torch.where(ok, delta, 0.0)


def _stream_collide_rows(f_ext, obstacles_rows, params: LBMParams, m: int):
    """Pull-stream + BGK collide the middle ``m`` rows of a (9, m+2, nx)
    window (x periodic), with the equilibrium of ``reference``."""
    planes = [torch.roll(f_ext[k, 1 - int(lattice.CY[k]):1 - int(lattice.CY[k]) + m],
                         shifts=int(lattice.CX[k]), dims=1)
              for k in range(lattice.NSPEEDS)]
    streamed = torch.stack(planes)
    rho, u_x, u_y = reference.macroscopic(streamed)
    feq = reference.equilibrium(rho, u_x, u_y)
    relaxed = streamed + float(params.omega_f32) * (feq - streamed)
    reflected = streamed[_OPP.to(streamed.device)]
    return torch.where(obstacles_rows[None], reflected, relaxed)


def _av_partial(f_next, obstacles):
    """||u|| sum over the shard's fluid cells, post-collision moments."""
    _, v_x, v_y = reference.macroscopic(f_next)
    norm = torch.sqrt(v_x * v_x + v_y * v_y)
    return torch.sum(torch.where(obstacles, 0.0, norm))


def _local_fused_step(ext, own_obst, params: LBMParams, torus: bool):
    """One step of a shard from its forced, halo-exchanged (9, ly+2, lx or
    lx+2) window: stream + collide.  The ring form is the JAX 1-D step
    (equilibrium of ``reference``, ||u|| from the post-collision moments);
    the torus form streams by slicing and collides pairwise, ||u|| from the
    pre-collision moments, as the JAX 2-D step.  Returns (next own block,
    ||u|| sum)."""
    ly, lx = own_obst.shape
    if not torus:
        nxt = _stream_collide_rows(ext, own_obst, params, ly)
        return nxt, _av_partial(nxt, own_obst)
    streamed = [ext[k, 1 - int(lattice.CY[k]):1 - int(lattice.CY[k]) + ly,
                    1 - int(lattice.CX[k]):1 - int(lattice.CX[k]) + lx]
                for k in range(lattice.NSPEEDS)]
    new, u_sq = kernel_common.collide(streamed, own_obst, params)
    return torch.stack(new), torch.sum(torch.where(own_obst, 0.0, torch.sqrt(u_sq)))


def _local_fused_ca_steps(w, obst_ext, accel_ext, params: LBMParams, k: int, ly: int, lx: int,
                          torus: bool, collect_density: bool):
    """K shrinking-window steps of one shard's +-K window (rows; and
    columns on a torus, else x periodic), forced at each step from the
    loop-invariant extended masks.  Returns (own block, K ||u|| sums, K
    densities or [])."""
    tots, dens = [], []
    for s in range(k):
        depth = k - s
        rows, off = ly + 2 * depth, k - depth
        cols = slice(off, off + lx + 2 * depth) if torus else slice(None)
        inner = slice(off + 1, off + lx + 2 * depth - 1) if torus else slice(None)
        planes = kernel_common.forced(list(w), obst_ext[off:off + rows, cols],
                                      accel_ext[off:off + rows, None], params)
        streamed = []
        for kk, p in enumerate(planes):
            cy, cx = int(lattice.CY[kk]), int(lattice.CX[kk])
            p = p[1 - cy:1 - cy + rows - 2]
            streamed.append(p[:, 1 - cx:p.shape[1] - 1 - cx] if torus
                            else torch.roll(p, shifts=cx, dims=1))
        new, u_sq = kernel_common.collide(streamed, obst_ext[off + 1:off + rows - 1, inner],
                                          params)
        w = torch.stack(new)
        own = (slice(depth - 1, depth - 1 + ly),
               slice(depth - 1, depth - 1 + lx) if torus else slice(None))
        own_obst = obst_ext[k:k + ly, k:k + lx] if torus else obst_ext[k:k + ly]
        tots.append(torch.sum(torch.where(own_obst, 0.0, torch.sqrt(u_sq[own]))))
        if collect_density:
            dens.append(torch.sum(w[(slice(None), *own)]))
    return w, tots, dens


def _run_jnp(mesh: Mesh, params: LBMParams, iters: int, g: int, f0,
             masks: list[torch.Tensor], n_fluid: torch.Tensor, collect_density: bool):
    """The jnp shard kernel on windows of g ghost rows: passes of g steps
    per exchange (g > 1), then 1-step exchanges, each forcing the own
    block before the exchange as the JAX step does."""
    win = _Windows(mesh, params.ny, params.nx, g)
    ly, lx, dev0 = win.ly, win.lx, mesh.devices[0]
    win.load(params, f0)
    obst = [(m & stream_kernel.OBSTACLE) != 0 for m in masks]
    accel = [(m[:, 0] & stream_kernel.FORCING) != 0 for m in masks]
    own = [win.own_of(o) for o in obst]
    own_accel = [a[win.g:win.g + ly] for a in accel]
    av = torch.empty(iters, dtype=torch.float32, device=dev0)
    dens = torch.empty(iters, dtype=torch.float32, device=dev0) if collect_density else None
    passes = iters // g if g > 1 else 0
    b = 0
    for p in range(passes):
        win.exchange(b)
        out = [_local_fused_ca_steps(win.bufs[b][s], obst[s], accel[s], params, g, ly, lx,
                                     mesh.torus, collect_density) for s in range(mesh.size)]
        for s, (f, _, _) in enumerate(out):
            win.own(1 - b, s).copy_(f)
        b = 1 - b
        for t in range(g):
            av[p * g + t] = _shard_sum([o[1][t] for o in out], dev0)
            if collect_density:
                dens[p * g + t] = _shard_sum([o[2][t] for o in out], dev0)
    for t in range(passes * g, iters):
        for s in range(mesh.size):
            f = win.own(b, s)
            f.copy_(_masked_accelerate(f, own[s], own_accel[s], params.accel_w1,
                                       params.accel_w2))
        win.exchange(b)
        out = [_local_fused_step(win.halo1(win.bufs[b][s]), own[s], params, mesh.torus)
               for s in range(mesh.size)]
        for s, (f, _) in enumerate(out):
            win.own(1 - b, s).copy_(f)
        b = 1 - b
        av[t] = _shard_sum([o[1] for o in out], dev0)
        if collect_density:
            dens[t] = _shard_sum([win.own(b, s).sum() for s in range(mesh.size)], dev0)
    av /= n_fluid
    return win.state(b), av, dens


# ---- the kernel shard kernels: ghosted windows -------------------------------------

def _window_shape(mesh: Mesh, ny: int, nx: int, g: int) -> tuple[int, int, int, int]:
    """(ly, lx, h, w) of the shards' windows with g ghost rows (and on a
    torus g ghost columns) each side."""
    my, mx = mesh.shape
    ly, lx = ny // my, nx // mx
    return ly, lx, ly + 2 * g, lx + (2 * g if mesh.torus else 0)


class _Windows:
    """Two ghosted window buffers per shard: the own block at rows [g,
    g+ly) and columns [gc, gc+lx), with g ghost rows above and below and,
    on a torus, gc = g ghost columns each side (gc = 0 on a ring, x
    periodic).  ``exchange(b)`` fills buffer b's ghost cells from the
    neighbours' own cells of the same buffer."""

    def __init__(self, mesh: Mesh, ny: int, nx: int, g: int):
        self.mesh, self.g = mesh, g
        self.ly, self.lx, self.h, self.w = _window_shape(mesh, ny, nx, g)
        self.gc = g if mesh.torus else 0
        self.bufs = [[torch.empty((lattice.NSPEEDS, self.h, self.w), dtype=torch.float32,
                                  device=d) for d in mesh.devices] for _ in range(2)]
        self.pairs = [self._copies(wins) for wins in self.bufs]

    def _copies(self, wins: list[torch.Tensor]) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """(destination, source) views of one exchange, in order: phase 1,
        the neighbours' edge rows over the y ring, own columns; phase 2 on
        a torus, the edge columns of the row-extended windows over the x
        ring, all rows, which carries the corners."""
        mesh, g, gc, ly, lx = self.mesh, self.g, self.gc, self.ly, self.lx
        mx = mesh.shape[1]
        own_cols = slice(gc, gc + lx)
        pairs = []
        for s, w in enumerate(wins):
            i, j = divmod(s, mx)
            below, above = wins[mesh.index(i - 1, j)], wins[mesh.index(i + 1, j)]
            pairs.append((w[:, :g, own_cols], below[:, ly:ly + g, own_cols]))
            pairs.append((w[:, g + ly:, own_cols], above[:, g:2 * g, own_cols]))
        if mesh.torus:
            for s, w in enumerate(wins):
                i, j = divmod(s, mx)
                left, right = wins[mesh.index(i, j - 1)], wins[mesh.index(i, j + 1)]
                pairs.append((w[:, :, :gc], left[:, :, lx:lx + gc]))
                pairs.append((w[:, :, gc + lx:], right[:, :, gc:2 * gc]))
        return pairs

    def own_of(self, x: torch.Tensor) -> torch.Tensor:
        """The own block of window-shaped ``x`` (a window or its mask)."""
        return x[..., self.g:self.g + self.ly, self.gc:self.gc + self.lx]

    def own(self, b: int, s: int) -> torch.Tensor:
        return self.own_of(self.bufs[b][s])

    def load(self, params: LBMParams, f0) -> None:
        """Buffer 0's own blocks from ``f0``, a (9, ny, nx) tensor or array,
        or from the rest equilibrium when ``f0`` is None; each made on its
        shard's device, never whole on one device."""
        if f0 is None:
            rest = torch.from_numpy(reference.rest_populations(params))[:, None, None]
            for s, d in enumerate(self.mesh.devices):
                # 9 values to the device, then broadcast there
                self.own(0, s).copy_(rest.to(d).expand(lattice.NSPEEDS, self.ly, self.lx))
            return
        f0 = torch.as_tensor(f0)
        mx, ly, lx = self.mesh.shape[1], self.ly, self.lx
        for s in range(self.mesh.size):
            i, j = divmod(s, mx)
            self.own(0, s).copy_(f0[:, i * ly:(i + 1) * ly, j * lx:(j + 1) * lx])

    def state(self, b: int) -> ShardedState:
        """Buffer b's own blocks as the run's result; the other buffers go
        now, not with the result."""
        state = ShardedState(self.mesh, [self.own(b, s) for s in range(self.mesh.size)])
        self.bufs[1 - b] = self.pairs = None
        return state

    def halo1(self, x: torch.Tensor) -> torch.Tensor:
        """The own block of window-shaped ``x`` (a window or its mask) with
        one halo row (and on a torus one halo column) each side: the
        1-step kernels' window."""
        g, gc = self.g, self.gc
        cols = slice(gc - 1, gc + self.lx + 1) if self.mesh.torus else slice(None)
        return x[..., g - 1:g + self.ly + 1, cols]

    def exchange(self, b: int) -> None:
        for dst, src in self.pairs[b]:
            dst.copy_(src)


def _window_masks(mesh: Mesh, ny: int, nx: int, g: int, obstacles: np.ndarray,
                  exclude_ghosts: bool) -> list[torch.Tensor]:
    """Each shard's encoded window mask (+1 obstacle, +2 on images of row
    ny-2, +4 on the ghost cells where ``exclude_ghosts``), loop-invariant,
    on its device."""
    ly, lx, h, w = _window_shape(mesh, ny, nx, g)
    gc = g if mesh.torus else 0
    masks = []
    for s, d in enumerate(mesh.devices):
        i, j = divmod(s, mesh.shape[1])
        rows = (i * ly - g + np.arange(h)) % ny
        obst = torch.from_numpy(np.ascontiguousarray(_extended(obstacles, i, j, ly, lx, g, gc)))
        enc = stream_kernel.encode_masks(obst, torch.from_numpy(rows == ny - 2))
        if exclude_ghosts:
            ghost = torch.ones(h, w, dtype=torch.bool)
            ghost[g:g + ly, gc:gc + lx] = False
            enc = stream_kernel.mark_reduction_excluded(enc, ghost)
        masks.append(enc.to(d))
    return masks


def _drive(win: _Windows, launches: list, b: int, n: int, spl: int, tiles: int,
           av: torch.Tensor, t0: int, dens: torch.Tensor | None) -> int:
    """``n`` launches of ``spl`` steps each from window buffer ``b``: per
    launch the exchange, then ``launches[b][s](partials)`` for every shard
    s (from buffer b into buffer 1 - b).  The per-shard partials of a chunk
    of launches are summed per step, then over the shards in shard order,
    into ``av[t0:]``; with ``dens`` (spl = 1) each step's total density.
    Returns the buffer of the last state."""
    devs = win.mesh.devices
    rows = max(1, min(CHUNK // spl, n))
    parts = [torch.empty((rows, spl, tiles), dtype=torch.float32, device=d) for d in devs]
    for p in range(n):
        win.exchange(b)
        for launch, part in zip(launches[b], parts):
            launch(part[p % rows] if spl > 1 else part[p % rows, 0])
        b = 1 - b
        if dens is not None:
            dens[t0 + p] = _shard_sum([win.own(b, s).sum() for s in range(len(devs))], devs[0])
        if (p + 1) % rows == 0 or p + 1 == n:
            p0 = p - p % rows
            av[t0 + p0 * spl:t0 + (p + 1) * spl] = _shard_sum(
                [part[:p + 1 - p0].sum(dim=2).reshape(-1) for part in parts], devs[0])
    return b


def _run_windows(mesh: Mesh, params: LBMParams, iters: int, kernel: str, g: int, f0,
                 masks: list[torch.Tensor], n_fluid: torch.Tensor, collect_density: bool):
    """``pallas`` or ``stream`` on windows of g ghost rows: passes of g
    steps (the K-step local form for ``pallas``, the stream kernel for
    ``stream``; none when g = 1), then the ``iters % g`` tail on the 1-step
    local kernel."""
    win = _Windows(mesh, params.ny, params.nx, g)
    ly, lx = win.ly, win.lx
    win.load(params, f0)
    dev0 = mesh.devices[0]
    av = torch.empty(iters, dtype=torch.float32, device=dev0)
    dens = torch.empty(iters, dtype=torch.float32, device=dev0) if collect_density else None
    passes, tail = divmod(iters, g) if g > 1 else (0, iters)
    b = 0
    if passes:
        if kernel == "stream":
            window_pass = (stream_kernel.window_ca_steps_2d if mesh.torus
                           else stream_kernel.window_ca_steps)
            tiles = stream_kernel.num_tiles(win.h, win.w)
            launches = [[functools.partial(_stream_window, window_pass, win.bufs[b][s], masks[s],
                                           params, win.bufs[1 - b][s])
                         for s in range(mesh.size)] for b in range(2)]
        else:
            tiles = local_kernel.num_tiles(ly, lx)
            launches = [[local_kernel.ca_launcher(win.bufs[b][s], masks[s], params, g,
                                                  win.own(1 - b, s))
                         for s in range(mesh.size)] for b in range(2)]
        b = _drive(win, launches, b, passes, g, tiles, av, 0, None)
    if tail:
        launches = [[local_kernel.step_launcher(win.halo1(win.bufs[b][s]), win.halo1(masks[s]),
                                                params, win.own(1 - b, s), torus=mesh.torus)
                     for s in range(mesh.size)] for b in range(2)]
        b = _drive(win, launches, b, tail, 1, local_kernel.num_partials(ly, lx), av,
                   passes * g, dens)
    av /= n_fluid
    return win.state(b), av, dens


def _stream_window(window_pass, window, mask, params, out, partials) -> None:
    window_pass(window, mask, params, out=out, partials=partials)


# ---- kernel choice and the runners --------------------------------------------------

# Cells of a shard from which ``auto`` runs the stream kernel on it (2048 x
# 8192; see resolve_shard_kernel).
STREAM_SHARD_CELLS = 1 << 24


def resolve_shard_kernel(
    params: LBMParams,
    *,
    n_devices: int | None = None,
    mesh_shape: tuple[int, int] | None = None,
    ca_steps: int = 1,
    device_type: str | None = None,
) -> str:
    """The shard kernel ``auto`` runs.  Off CUDA ``jnp``, as the JAX package
    picks it off the TPU.  On CUDA the local kernels, ``pallas`` (the
    K-step local form when ``ca_steps`` > 1), except a torus with
    ``ca_steps`` > 1, which only ``jnp`` runs; and ``stream`` on shards of
    at least STREAM_SHARD_CELLS cells when ``ca_steps`` is 1.  On 4 shards
    of one H100 80GB HBM3 at 700 W (chip_smoke.py's sharded runs, PERF.md,
    Findings) the stream kernel passed the 1-step local kernel at
    8192^2 (1465 against 1864 us per step on a ring, 1566 against 2598 on a
    2x2 torus) and not at 6144^2 (1120 against 1077, 1543 against 1466) or
    below: a shard's window fills the card's blocks with its 80 x 1024
    cell items only from about that size.  The TPU ladder's 1024^2
    threshold is a TPU number.  A shape that does not divide returns
    ``jnp`` and leaves the error to the runner."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type != "cuda":
        return "jnp"
    ny, nx = params.ny, params.nx
    if mesh_shape is not None:
        my, mx = mesh_shape
    else:
        my, mx = (torch.cuda.device_count() if n_devices is None else n_devices), 1
    if my < 1 or mx < 1 or ny % my or nx % mx:
        return "jnp"
    if ca_steps > 1:
        return "jnp" if mesh_shape is not None else "pallas"
    ly, lx = ny // my, nx // mx
    thick = ly >= stream_kernel.K and (mesh_shape is None or lx >= stream_kernel.K)
    return "stream" if thick and ly * lx >= STREAM_SHARD_CELLS else "pallas"


class ShardedRunner:
    """A validated sharded configuration: ``runner(f0, obstacles)`` runs
    it and returns (ShardedState, av_vels[, densities]); ``prepare()``
    builds and loads its kernels without launching any."""

    def __init__(self, mesh: Mesh, params: LBMParams, n_iters: int, kernel: str,
                 ca_steps: int, collect_density: bool):
        my, mx = mesh.shape
        ny, nx = params.ny, params.nx
        if mesh.torus:
            if ny % my or nx % mx:
                raise ValueError(f"grid {ny}x{nx} not divisible by mesh {my}x{mx}")
        elif ny % my:
            raise ValueError(f"ny={ny} not divisible by {my} devices")
        if kernel == "auto":
            kernel = resolve_shard_kernel(params, n_devices=None if mesh.torus else my,
                                          mesh_shape=mesh.shape if mesh.torus else None,
                                          ca_steps=ca_steps, device_type=mesh.devices[0].type)
        if kernel not in SHARD_KERNELS[1:]:
            raise ValueError(f"unknown shard kernel {kernel!r}; use one of "
                             f"{', '.join(SHARD_KERNELS)}")
        if ca_steps < 1:
            raise ValueError(f"ca_steps must be >= 1, got {ca_steps}")
        if mesh.torus and ca_steps > 1 and kernel == "pallas":
            raise ValueError(
                "ca_steps > 1 with kernel='pallas' is not supported on the 2-D torus "
                "(the K-step local kernel assumes an unsharded periodic x axis); use "
                "kernel='jnp' or a 1-D mesh")
        if kernel == "pallas" and ca_steps > 1:
            local_kernel.kstep_kernel._check_k(ca_steps)
        ly, lx = ny // my, nx // mx
        if kernel == "stream":
            if ca_steps not in (1, stream_kernel.K):
                raise ValueError(
                    f"kernel='stream' advances K={stream_kernel.K} steps per exchange by "
                    f"construction; pass ca_steps={stream_kernel.K} or leave it at 1")
            ca_steps = stream_kernel.K
            if not collect_density and (ly < ca_steps or (mesh.torus and lx < ca_steps)):
                raise ValueError(
                    f"local block {ly}x{lx} too thin for the stream kernel's "
                    f"K={ca_steps} ghost zones")
        elif ca_steps > 1 and (ly < 2 * ca_steps or (mesh.torus and lx < 2 * ca_steps)):
            if mesh.torus:
                raise ValueError(f"local block {ly}x{lx} too thin for ca_steps={ca_steps} "
                                 "ghost zones")
            raise ValueError(f"local slab ny/n={ly} too thin for ca_steps={ca_steps} "
                             "ghost zones")
        self.mesh, self.params, self.n_iters = mesh, params, n_iters
        self.kernel, self.ca_steps, self.collect_density = kernel, ca_steps, collect_density
        # ghost depth of the windows: the steps per exchange, or 1 where
        # the run is 1-step exchanges (a kernel path's --debug runs the
        # 1-step local kernel)
        one_step = ca_steps == 1 or (kernel != "jnp" and collect_density)
        self.g = 1 if one_step else ca_steps
        self._setup_for, self._setup = None, None

    def prepare(self, obstacles=None) -> None:
        """Build and load the kernels onto every CUDA device of the mesh,
        launching none; with ``obstacles``, also build the run's
        loop-invariant device masks now, so that a run with the same mask
        object starts stepping at once."""
        if self.kernel != "jnp":
            ks = (self.g,) if self.kernel == "pallas" and self.g > 1 else ()
            for d in dict.fromkeys(self.mesh.devices):
                local_kernel.prepare(d, ks)
                if self.kernel == "stream":
                    stream_kernel.prepare(d)
        if obstacles is not None:
            self._masks(obstacles)

    def _masks(self, obstacles) -> tuple:
        """(per-shard device masks, global fluid count) for ``obstacles``,
        built once per mask object."""
        if self._setup_for is not obstacles:
            obst = np.asarray(obstacles.cpu() if isinstance(obstacles, torch.Tensor)
                              else obstacles) != 0
            if obst.shape != (self.params.ny, self.params.nx):
                raise ValueError(f"obstacle mask {obst.shape} != grid "
                                 f"({self.params.ny}, {self.params.nx})")
            n_fluid = torch.tensor(float(np.count_nonzero(~obst)),
                                   dtype=torch.float32).to(self.mesh.devices[0])
            masks = _window_masks(self.mesh, self.params.ny, self.params.nx, self.g, obst,
                                  exclude_ghosts=self.kernel == "stream" and self.g > 1)
            self._setup_for, self._setup = obstacles, (masks, n_fluid)
        return self._setup

    def __call__(self, f0, obstacles) -> tuple:
        """Run from ``f0`` ((9, ny, nx) tensor or array, or None for the
        rest equilibrium, made shard by shard on the devices) with the (ny,
        nx) obstacle mask."""
        masks, n_fluid = self._masks(obstacles)
        with torch.no_grad():
            if self.kernel == "jnp":
                f, av, dens = _run_jnp(self.mesh, self.params, self.n_iters, self.g, f0, masks,
                                       n_fluid, self.collect_density)
            else:
                f, av, dens = _run_windows(self.mesh, self.params, self.n_iters, self.kernel,
                                           self.g, f0, masks, n_fluid, self.collect_density)
        return (f, av, dens) if self.collect_density else (f, av)


def make_sharded_runner(mesh: Mesh, params: LBMParams, n_iters: int, kernel: str = "jnp",
                        ca_steps: int = 1, collect_density: bool = False,
                        overlap: bool = False) -> ShardedRunner:
    """The 1-D ring's runner (see :class:`ShardedRunner`)."""
    if overlap:
        raise ValueError("overlap=True (the overlapped 1-step jnp schedule) is not yet "
                         "ported to the PyTorch package")
    return ShardedRunner(mesh, params, n_iters, kernel, ca_steps, collect_density)


def make_sharded_runner_2d(mesh: Mesh, params: LBMParams, n_iters: int, *, kernel: str = "jnp",
                           ca_steps: int = 1, collect_density: bool = False) -> ShardedRunner:
    """The (my, mx) torus's runner (see :class:`ShardedRunner`)."""
    return ShardedRunner(mesh, params, n_iters, kernel, ca_steps, collect_density)


def prepare_sharded(params: LBMParams, n_iters: int, *, n_devices: int | None = None,
                    devices: Sequence[torch.device | str] | None = None, kernel: str = "jnp",
                    ca_steps: int = 1, collect_density: bool = False,
                    overlap: bool = False) -> ShardedRunner:
    """Validate the 1-D y decomposition over the first ``n_devices`` of
    ``devices`` (default: the visible CUDA cards) and build its runner."""
    mesh = make_y_mesh(n_devices, devices)
    return make_sharded_runner(mesh, params, n_iters, kernel=kernel, ca_steps=ca_steps,
                               collect_density=collect_density, overlap=overlap)


def prepare_sharded_2d(params: LBMParams, n_iters: int, mesh_shape: tuple[int, int], *,
                       devices: Sequence[torch.device | str] | None = None,
                       kernel: str = "jnp", ca_steps: int = 1,
                       collect_density: bool = False) -> ShardedRunner:
    """Validate the (my, mx) torus decomposition and build its runner."""
    mesh = make_yx_mesh(*mesh_shape, devices)
    return make_sharded_runner_2d(mesh, params, n_iters, kernel=kernel, ca_steps=ca_steps,
                                  collect_density=collect_density)


def execute_sharded(runner: ShardedRunner, f0, obstacles, params: LBMParams) -> tuple:
    """Invoke the runner on the inputs (the JAX function's shape; the
    runner places the shards itself)."""
    if (params.ny, params.nx) != (runner.params.ny, runner.params.nx):
        raise ValueError("params do not match the runner's grid")
    return runner(f0, obstacles)


def run_sharded(f0, obstacles, params: LBMParams, *, n_iters: int | None = None,
                n_devices: int | None = None,
                devices: Sequence[torch.device | str] | None = None, kernel: str = "jnp",
                ca_steps: int = 1, collect_density: bool = False,
                overlap: bool = False) -> tuple:
    """The full loop sharded along y; returns (ShardedState, av_vels[,
    densities]), the state left on the mesh (``.numpy()`` gathers it)."""
    iters = params.max_iters if n_iters is None else n_iters
    runner = prepare_sharded(params, iters, n_devices=n_devices, devices=devices,
                             kernel=kernel, ca_steps=ca_steps,
                             collect_density=collect_density, overlap=overlap)
    return execute_sharded(runner, f0, obstacles, params)


def run_sharded_2d(f0, obstacles, params: LBMParams, mesh_shape: tuple[int, int], *,
                   n_iters: int | None = None,
                   devices: Sequence[torch.device | str] | None = None, kernel: str = "jnp",
                   ca_steps: int = 1, collect_density: bool = False) -> tuple:
    """The full loop on a (my, mx) torus; returns as :func:`run_sharded`."""
    iters = params.max_iters if n_iters is None else n_iters
    runner = prepare_sharded_2d(params, iters, mesh_shape, devices=devices, kernel=kernel,
                                ca_steps=ca_steps, collect_density=collect_density)
    return execute_sharded(runner, f0, obstacles, params)
