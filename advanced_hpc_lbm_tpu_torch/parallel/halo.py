"""Halo-exchanged domain decomposition of the step over a device mesh.

The counterpart of ``advanced_hpc_lbm_tpu.parallel.halo``.  The grid is
cut into row slabs over a 1-D ring (:func:`run_sharded`) or into blocks
over a (my, mx) torus (:func:`run_sharded_2d`); global periodicity is the
ring's (or torus's) wrap.  Where the JAX package runs one SPMD program
(``shard_map`` + ``jit``, ``ppermute`` for halos, ``psum`` for the
||u|| sums), this package is single-controller per process: one Python
loop drives every shard of the process, per-shard tensors live on the
mesh's devices, halos travel as tensor copies between them, and the
per-shard ||u|| sums are added in a fixed shard order and divided by the
global fluid count.  Shard kernels (``kernel``):

  jnp     the JAX package's name for its XLA-fused local step, here plain
          PyTorch like the ``fused`` backend: the 1-step form reduces
          ||u|| from the post-collision moments (``_av_partial``), the
          K-step (``ca_steps``) and torus forms from the pre-collision
          ones, as the JAX functions do.  On a ring, ``overlap=True``
          takes the overlapped schedule (:func:`_overlapped_step`)
  pallas  the hand-written local kernels (``ops/local_kernel.py``): one
          step per launch, or with ``ca_steps`` = K > 1 (ring only) K
          steps per exchange on the K-step kernel's local form
  stream  the stream kernel out of place on each shard's +-8 ghost window
          (``stream_kernel.window_ca_steps`` / ``_2d``), 8 steps per
          exchange
  auto    :func:`resolve_shard_kernel`

On the CPU the kernels run their plain versions.  Every shard keeps its
state in ghosted window buffers (``_Windows``, two per shard, ping-ponged):
the exchange copies the neighbours' edge rows (then, on a torus, the edge
columns of the row-extended windows, which carries the corners) into the
ghost rows and columns, and the kernels read the window in place.  The
last ``n % K`` steps of a K-step run, and a ``--debug`` run of ``pallas``
with ``ca_steps`` or of ``stream``, run the 1-step local kernel (the JAX
package runs its ``jnp`` step there).

Exchange ordering.  The kernels write the next window's own cells and read
the current one; the exchange writes the current window's ghost cells from
the neighbours' current own cells, after the launches that wrote them and
before the launches that read them.  On one device one stream orders all
of it.  Across devices, PyTorch's copy between two devices runs on the
source device's current stream after waiting for the destination's, and
makes the destination's current stream wait for the copy (``copy_`` of
CUDA tensors on two devices), which is the event ordering the exchange
needs.  Between cards with peer access the copy of a strided view is one
kernel; without it PyTorch stages it through contiguous temporaries.
It has run on 2 and 4 H100s, rings and a 2x2 torus in one process, rings,
a 2x1 and a 2x2 torus in one process per card over nccl, each run bitwise
equal to the same mesh laid on one card (``chip_smoke.py`` phases 8, 12
and 14).

Across processes (``parallel/multihost.py``).  A mesh may span processes
(``Mesh.ranks``); each process allocates windows, masks and partial sums
for its own shards only and launches only them.  A copy whose two ends
lie in different processes becomes a send of the source's edge rows (or
columns) and a receive into the destination's ghost cells.  Each exchange
phase walks the mesh's copies in one global order, which every process
computes alike: local copies run as ``copy_``, and the remote ones of the
phase go out together as one ``torch.distributed.batch_isend_irecv``,
every process posting its sends and receives in that order (tagged by the
copy's place in it), so that each pair of ranks matches them.  They pass
through contiguous staging buffers: on ``nccl`` buffers on the device; on
``gloo``, which moves host tensors only, pinned host buffers, with a copy
to the host before the send (which waits for the launches that wrote the
rows, keeping the ordering rule) and a copy to the device after the
receive (before the launches that read them).  This is how two processes
share one card.  The ||u|| sums stay in shard order: each process's
per-shard partials of a chunk of CHUNK steps are all-gathered once per
chunk and added over the shards in shard order by every process, so a
multi-process run is bitwise equal to the single-process run on the same
mesh shape.  ``ShardedState.numpy`` gathers the remote shards into every
process.

Overlap (the counterpart of the JAX ``_local_fused_step_overlap``).  The
1-step ``jnp`` ring step issues the exchange first (on CUDA on a side
stream of each destination device, after an event of the main stream that
follows the forcing; across processes the sends and receives above), then
computes the interior rows [1, ly-1) from the own rows alone, then waits
for the exchange (the main stream waits for the side stream's event) and
computes the two edge rows.  The interior reads no ghost row, and the next
step's exchange writes the other buffer's ghost rows only after the main
stream's next event, so no copy overwrites a row that a launch still reads.
The per-row math is the same, so the two schedules are bitwise equal.

Checkpointed sharded runs go through ``Simulation.run(checkpoint_every=...)``
in a single process: each segment is a runner call from the host copy of
the state that the last snapshot gathered.  Batches of independent decks
are ``parallel/batch.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Sequence

import numpy as np
import torch
import torch.distributed as dist

from advanced_hpc_lbm_tpu_torch.ops import (
    kernel_common, kstep_kernel, lattice, local_kernel, reference, step_kernel, stream_kernel,
)
from advanced_hpc_lbm_tpu_torch.params import LBMParams
from advanced_hpc_lbm_tpu_torch.parallel import multihost
from advanced_hpc_lbm_tpu_torch.parallel.mesh import Mesh, make_y_mesh, make_yx_mesh

SHARD_KERNELS = ("auto", "jnp", "pallas", "stream")

# Steps of ||u|| partials held per shard before they are summed.
CHUNK = step_kernel.CHUNK

_OPP = torch.from_numpy(lattice.OPP).long()


# ---- the state of a sharded run ----------------------------------------------------

def _stage_device(device: torch.device) -> torch.device:
    """Where a tensor of ``device`` passes through the process group: the
    device itself on nccl, the host on gloo."""
    return device if multihost.backend() == "nccl" else torch.device("cpu")


def _staging(shape, device: torch.device) -> torch.Tensor:
    """A contiguous buffer through which a view of a ``device`` tensor is
    sent or received: pinned host memory for a CUDA tensor on gloo."""
    stage = _stage_device(device)
    return torch.empty(shape, dtype=torch.float32, device=stage,
                       pin_memory=stage.type == "cpu" and device.type == "cuda")


@dataclasses.dataclass
class ShardedState:
    """The (9, ny, nx) state of a sharded run, left on the mesh:
    ``shards[s]`` is the own block of shard s (row-major over the mesh), a
    view into its device's buffer, or None where another process owns it.
    ``block`` is the (ly, lx) of every shard."""

    mesh: Mesh
    shards: list[torch.Tensor | None]
    block: tuple[int, int]

    @property
    def shape(self) -> tuple[int, int, int]:
        my, mx = self.mesh.shape
        ly, lx = self.block
        return lattice.NSPEEDS, my * ly, mx * lx

    def _place(self, s: int) -> tuple[slice, slice]:
        ly, lx = self.block
        i, j = divmod(s, self.mesh.shape[1])
        return slice(i * ly, (i + 1) * ly), slice(j * lx, (j + 1) * lx)

    def blocks(self):
        """(rows, columns, own block) of every shard of this process: the
        block is the state's [:, rows, columns]."""
        for s, t in enumerate(self.shards):
            if t is not None:
                yield (*self._place(s), t)

    def numpy(self) -> np.ndarray:
        """The whole state on the host, gathered plane by plane and shard by
        shard, so that no device holds more than its own shards.  Across
        processes the owner of each shard broadcasts it plane by plane, and
        every process gets the whole state (collective: every process
        calls it)."""
        out = np.empty(self.shape, dtype=np.float32)
        if not self.mesh.spans_processes:
            for rows, cols, t in self.blocks():
                for k in range(lattice.NSPEEDS):
                    torch.from_numpy(out[k, rows, cols]).copy_(t[k])
            return out
        local = next(t for t in self.shards if t is not None)
        stage = _staging(self.block, local.device)
        for s, t in enumerate(self.shards):
            rows, cols = self._place(s)
            for k in range(lattice.NSPEEDS):
                if t is not None:
                    stage.copy_(t[k])
                dist.broadcast(stage, src=self.mesh.owner(s))
                torch.from_numpy(out[k, rows, cols]).copy_(stage)
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


def _interior_rows(own, own_obst, params: LBMParams):
    """Rows [1, ly-1) of the ring step from the shard's own rows alone: the
    part of the overlapped step that needs no ghost row."""
    return _stream_collide_rows(own, own_obst[1:-1], params, own.shape[1] - 2)


def _overlapped_step(ext, interior, own_obst, params: LBMParams):
    """The rest of the overlapped ring step, once the exchange has filled
    the ghost rows of the (9, ly+2, nx) window ``ext``: its two edge rows,
    each from its ghost row and two own rows, around ``interior``.  Returns
    (next own block, ||u|| sum), bitwise those of :func:`_local_fused_step`."""
    ly = own_obst.shape[0]
    row0 = _stream_collide_rows(ext[:, 0:3], own_obst[0:1], params, 1)
    row_last = _stream_collide_rows(ext[:, ly - 1:ly + 2], own_obst[ly - 1:ly], params, 1)
    nxt = torch.cat([row0, interior, row_last], dim=1)
    return nxt, _av_partial(nxt, own_obst)


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
             masks: list, n_fluid: torch.Tensor, collect_density: bool, overlap: bool):
    """The jnp shard kernel on windows of g ghost rows: passes of g steps
    per exchange (g > 1), then 1-step exchanges, each forcing the own
    block before the exchange as the JAX step does (overlapped where
    ``overlap``)."""
    win = _Windows(mesh, params.ny, params.nx, g)
    ly, lx, local = win.ly, win.lx, win.local
    win.load(params, f0)
    obst = {s: (masks[s] & stream_kernel.OBSTACLE) != 0 for s in local}
    accel = {s: (masks[s][:, 0] & stream_kernel.FORCING) != 0 for s in local}
    own = {s: win.own_of(o) for s, o in obst.items()}
    own_accel = {s: a[win.g:win.g + ly] for s, a in accel.items()}
    av = torch.empty(iters, dtype=torch.float32, device=win.home)
    dens = torch.empty(iters, dtype=torch.float32, device=win.home) if collect_density else None
    av_sums, dens_sums = _StepSums(win, av), _StepSums(win, dens)
    passes = iters // g if g > 1 else 0
    b = 0
    for _ in range(passes):
        win.exchange(b)
        out = {s: _local_fused_ca_steps(win.bufs[b][s], obst[s], accel[s], params, g, ly, lx,
                                        mesh.torus, collect_density) for s in local}
        for s, (f, _, _) in out.items():
            win.own(1 - b, s).copy_(f)
        b = 1 - b
        for t in range(g):
            av_sums.put({s: o[1][t] for s, o in out.items()})
            if collect_density:
                dens_sums.put({s: o[2][t] for s, o in out.items()})
    for _ in range(passes * g, iters):
        for s in local:
            f = win.own(b, s)
            f.copy_(_masked_accelerate(f, own[s], own_accel[s], params.accel_w1,
                                       params.accel_w2))
        if overlap:
            pending = win.start_exchange(b)
            interior = {s: _interior_rows(win.own(b, s), own[s], params) for s in local}
            win.finish_exchange(pending)
            out = {s: _overlapped_step(win.halo1(win.bufs[b][s]), interior[s], own[s], params)
                   for s in local}
        else:
            win.exchange(b)
            out = {s: _local_fused_step(win.halo1(win.bufs[b][s]), own[s], params, mesh.torus)
                   for s in local}
        for s, (f, _) in out.items():
            win.own(1 - b, s).copy_(f)
        b = 1 - b
        av_sums.put({s: o[1] for s, o in out.items()})
        if collect_density:
            dens_sums.put({s: win.own(b, s).sum() for s in local})
    av_sums.flush()
    dens_sums.flush()
    av /= n_fluid
    return win.state(b), av, dens


# ---- the windows, their exchange and the shard-order sums ----------------------------

def _window_shape(mesh: Mesh, ny: int, nx: int, g: int) -> tuple[int, int, int, int]:
    """(ly, lx, h, w) of the shards' windows with g ghost rows (and on a
    torus g ghost columns) each side."""
    my, mx = mesh.shape
    ly, lx = ny // my, nx // mx
    return ly, lx, ly + 2 * g, lx + (2 * g if mesh.torus else 0)


def _local_shards(mesh: Mesh) -> list[int]:
    """The shards this process drives, in shard order."""
    return [s for s in range(mesh.size) if mesh.is_local(s)]


@dataclasses.dataclass
class _Phase:
    """The copies of one exchange phase as this process runs them: local
    (destination, source) view pairs; then sends (source view, staging,
    peer, tag) and receives (destination view, staging, peer, tag), posted
    together."""

    local: list = dataclasses.field(default_factory=list)
    sends: list = dataclasses.field(default_factory=list)
    recvs: list = dataclasses.field(default_factory=list)

    def post(self) -> list:
        """Stage the sends and post every transfer of the phase in the
        phase's global order; returns the works to wait on.  Where CUDA
        rows pass through host buffers (gloo), one synchronisation of
        their devices' streams first: the copies to the host are done, and
        so are the last exchange's copies out of the receive buffers,
        before gloo reads or overwrites any buffer (one wait per phase,
        not one per copy: two processes on one card pay a switch of
        contexts for each)."""
        ops = []
        for src, buf, peer, tag in self.sends:
            buf.copy_(src, non_blocking=True)
            ops.append((tag, dist.P2POp(dist.isend, buf, peer, tag=tag)))
        for _, buf, peer, tag in self.recvs:
            ops.append((tag, dist.P2POp(dist.irecv, buf, peer, tag=tag)))
        for d in self.host_staged:
            torch.cuda.current_stream(d).synchronize()
        ops.sort(key=lambda op: op[0])
        return dist.batch_isend_irecv([op for _, op in ops]) if ops else []

    def land(self, works: list) -> None:
        """Wait for the phase's transfers and write the received rows into
        the ghost cells, on the current streams, before the launches that
        read them."""
        for w in works:
            w.wait()
        for dst, buf, _, _ in self.recvs:
            dst.copy_(buf, non_blocking=True)

    @functools.cached_property
    def host_staged(self) -> set:
        """The CUDA devices whose rows this phase stages through host
        buffers."""
        return {view.device for view, buf, _, _ in self.sends + self.recvs
                if view.is_cuda and not buf.is_cuda}


class _Windows:
    """Two ghosted window buffers per shard of this process: the own block
    at rows [g, g+ly) and columns [gc, gc+lx), with g ghost rows above and
    below and, on a torus, gc = g ghost columns each side (gc = 0 on a
    ring, x periodic).  ``bufs[b][s]`` is None for a shard of another
    process.  ``exchange(b)`` fills buffer b's ghost cells from the
    neighbours' own cells of the same buffer."""

    def __init__(self, mesh: Mesh, ny: int, nx: int, g: int):
        self.mesh, self.g = mesh, g
        self.ly, self.lx, self.h, self.w = _window_shape(mesh, ny, nx, g)
        self.gc = g if mesh.torus else 0
        self.local = _local_shards(mesh)
        self.home = mesh.devices[self.local[0]]
        self.bufs = [[torch.empty((lattice.NSPEEDS, self.h, self.w), dtype=torch.float32,
                                  device=d) if mesh.is_local(s) else None
                      for s, d in enumerate(mesh.devices)] for _ in range(2)]
        self.phases = [self._phases(wins) for wins in self.bufs]
        self._side: dict = {}

    def _pairs(self) -> list[list[tuple]]:
        """(destination shard, its window slices, source shard, its window
        slices) of one exchange, per phase, in the one global order every
        process computes: phase 1, the neighbours' edge rows over the y
        ring, own columns; phase 2 on a torus, the edge columns of the
        row-extended windows over the x ring, all rows, which carries the
        corners."""
        mesh, g, gc, ly, lx = self.mesh, self.g, self.gc, self.ly, self.lx
        mx = mesh.shape[1]
        every, own_cols = slice(None), slice(gc, gc + lx)
        rows = []
        for s in range(mesh.size):
            i, j = divmod(s, mx)
            rows.append((s, (every, slice(0, g), own_cols),
                         mesh.index(i - 1, j), (every, slice(ly, ly + g), own_cols)))
            rows.append((s, (every, slice(g + ly, None), own_cols),
                         mesh.index(i + 1, j), (every, slice(g, 2 * g), own_cols)))
        if not mesh.torus:
            return [rows]
        cols = []
        for s in range(mesh.size):
            i, j = divmod(s, mx)
            cols.append((s, (every, every, slice(0, gc)),
                         mesh.index(i, j - 1), (every, every, slice(lx, lx + gc))))
            cols.append((s, (every, every, slice(gc + lx, None)),
                         mesh.index(i, j + 1), (every, every, slice(gc, 2 * gc))))
        return [rows, cols]

    def _phases(self, wins: list) -> list[_Phase]:
        """The phases of an exchange of window buffers ``wins`` as this
        process runs them: a copy between two of its shards is local; one
        from or to another process's shard is a send or a receive through a
        staging buffer, tagged by the copy's place in the phase."""
        mesh = self.mesh
        phases = []
        for pairs in self._pairs():
            phase = _Phase()
            for tag, (d, d_idx, s, s_idx) in enumerate(pairs):
                if mesh.is_local(d) and mesh.is_local(s):
                    phase.local.append((wins[d][d_idx], wins[s][s_idx]))
                elif mesh.is_local(s):
                    src = wins[s][s_idx]
                    phase.sends.append((src, _staging(src.shape, src.device), mesh.owner(d), tag))
                elif mesh.is_local(d):
                    dst = wins[d][d_idx]
                    phase.recvs.append((dst, _staging(dst.shape, dst.device), mesh.owner(s), tag))
            phases.append(phase)
        return phases

    def own_of(self, x: torch.Tensor) -> torch.Tensor:
        """The own block of window-shaped ``x`` (a window or its mask)."""
        return x[..., self.g:self.g + self.ly, self.gc:self.gc + self.lx]

    def own(self, b: int, s: int) -> torch.Tensor:
        return self.own_of(self.bufs[b][s])

    def load(self, params: LBMParams, f0) -> None:
        """Buffer 0's own blocks of this process's shards from ``f0``, a
        (9, ny, nx) tensor or array, or from the rest equilibrium when
        ``f0`` is None; each made on its shard's device, never whole on one
        device."""
        if f0 is None:
            rest = torch.from_numpy(reference.rest_populations(params))[:, None, None]
            for s in self.local:
                # 9 values to the device, then broadcast there
                self.own(0, s).copy_(rest.to(self.mesh.devices[s])
                                     .expand(lattice.NSPEEDS, self.ly, self.lx))
            return
        f0 = torch.as_tensor(f0)
        mx, ly, lx = self.mesh.shape[1], self.ly, self.lx
        for s in self.local:
            i, j = divmod(s, mx)
            self.own(0, s).copy_(f0[:, i * ly:(i + 1) * ly, j * lx:(j + 1) * lx])

    def state(self, b: int) -> ShardedState:
        """Buffer b's own blocks as the run's result; the other buffers go
        now, not with the result."""
        state = ShardedState(self.mesh, [self.own(b, s) if t is not None else None
                                         for s, t in enumerate(self.bufs[b])],
                             (self.ly, self.lx))
        self.bufs[1 - b] = self.phases = None
        return state

    def halo1(self, x: torch.Tensor) -> torch.Tensor:
        """The own block of window-shaped ``x`` (a window or its mask) with
        one halo row (and on a torus one halo column) each side: the
        1-step kernels' window."""
        g, gc = self.g, self.gc
        cols = slice(gc - 1, gc + self.lx + 1) if self.mesh.torus else slice(None)
        return x[..., g - 1:g + self.ly + 1, cols]

    def exchange(self, b: int) -> None:
        """Fill buffer b's ghost cells, phase after phase: local copies,
        then the remote transfers of the phase, waited for."""
        for phase in self.phases[b]:
            for dst, src in phase.local:
                dst.copy_(src)
            phase.land(phase.post())

    def start_exchange(self, b: int):
        """Issue a one-phase (ring) exchange of buffer b without waiting for
        it: the local copies on a side stream of each CUDA destination
        device, after an event of the current streams (that is, after the
        launches issued so far); the remote transfers posted.  Returns what
        :meth:`finish_exchange` waits for."""
        (phase,) = self.phases[b]
        events = []
        if phase.local:
            cuda = {w.device for w in self.bufs[b] if w is not None and w.is_cuda}
            issued = {}
            for d in cuda:
                issued[d] = torch.cuda.Event()
                issued[d].record(torch.cuda.current_stream(d))
            for d in cuda:
                if d not in self._side:
                    self._side[d] = torch.cuda.Stream(d)
                side = self._side[d]
                for ev in issued.values():
                    side.wait_event(ev)
            for dst, src in phase.local:
                if dst.device.type == "cuda":
                    with torch.cuda.stream(self._side[dst.device]):
                        dst.copy_(src)
                else:
                    dst.copy_(src)
            for d in cuda:
                done = torch.cuda.Event()
                done.record(self._side[d])
                events.append((d, done))
        return phase, phase.post(), events

    def finish_exchange(self, pending) -> None:
        """Wait for an exchange that :meth:`start_exchange` issued: the
        remote rows land, and each device's current stream waits for its
        side stream's copies."""
        phase, works, events = pending
        phase.land(works)
        for d, done in events:
            torch.cuda.current_stream(d).wait_event(done)


def _all_shards(win: _Windows, values: dict[int, torch.Tensor]) -> list[torch.Tensor]:
    """Every shard's (L,) tensor in shard order, ``values`` holding this
    process's: one all-gather of each process's stacked shards (padded to
    the most shards a process owns)."""
    mesh = win.mesh
    owned = [[s for s in range(mesh.size) if mesh.owner(s) == r]
             for r in range(multihost.process_count())]
    first = values[win.local[0]]
    stage = _stage_device(first.device)
    mine = torch.zeros((max(map(len, owned)), first.numel()), dtype=torch.float32, device=stage)
    for i, s in enumerate(win.local):
        mine[i].copy_(values[s])
    every = [torch.empty_like(mine) for _ in owned]
    dist.all_gather(every, mine)
    return [every[mesh.owner(s)][owned[mesh.owner(s)].index(s)] for s in range(mesh.size)]


def _reduce(win: _Windows, values: dict[int, torch.Tensor], out: torch.Tensor, t0: int) -> None:
    """``out[t0:t0+L]`` = the sum of every shard's (L,) per-step tensor in
    shard order, ``values`` holding this process's; across processes after
    one all-gather, every process adding alike."""
    vals = (_all_shards(win, values) if win.mesh.spans_processes
            else [values[s] for s in range(win.mesh.size)])
    tot = _shard_sum(vals, out.device)
    out[t0:t0 + tot.numel()] = tot


class _StepSums:
    """One 0-d sum per step and local shard, held for up to CHUNK steps on
    the shard's device and then added over the shards (``_reduce``) into
    ``out``; nothing where ``out`` is None.  Every process puts and
    flushes at the same steps; a caller that collects nothing does not
    put."""

    def __init__(self, win: _Windows, out: torch.Tensor | None):
        self.win, self.out, self.t0, self.n = win, out, 0, 0
        self.held = {} if out is None else {
            s: torch.empty(CHUNK, dtype=torch.float32, device=win.mesh.devices[s])
            for s in win.local}

    def put(self, values: dict[int, torch.Tensor]) -> None:
        for s, v in values.items():
            self.held[s][self.n] = v
        self.n += 1
        if self.n == CHUNK:
            self.flush()

    def flush(self) -> None:
        if self.n:
            _reduce(self.win, {s: h[:self.n] for s, h in self.held.items()}, self.out, self.t0)
            self.t0, self.n = self.t0 + self.n, 0


# ---- the kernel shard kernels: ghosted windows -------------------------------------

def _window_masks(mesh: Mesh, ny: int, nx: int, g: int, obstacles: np.ndarray,
                  exclude_ghosts: bool) -> list:
    """Each shard's encoded window mask (+1 obstacle, +2 on images of row
    ny-2, +4 on the ghost cells where ``exclude_ghosts``), loop-invariant,
    on its device; None for a shard of another process."""
    ly, lx, h, w = _window_shape(mesh, ny, nx, g)
    gc = g if mesh.torus else 0
    masks = []
    for s, d in enumerate(mesh.devices):
        if not mesh.is_local(s):
            masks.append(None)
            continue
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
    launch the exchange, then ``launches[b][s](partials)`` for every local
    shard s (from buffer b into buffer 1 - b).  The per-shard partials of a
    chunk of launches are summed per step, then over the shards in shard
    order, into ``av[t0:]``; with ``dens`` (spl = 1) each step's total
    density.  Returns the buffer of the last state."""
    devs = win.mesh.devices
    rows = max(1, min(CHUNK // spl, n))
    parts = {s: torch.empty((rows, spl, tiles), dtype=torch.float32, device=devs[s])
             for s in win.local}
    dens_sums = _StepSums(win, dens)
    dens_sums.t0 = t0
    for p in range(n):
        win.exchange(b)
        for s, part in parts.items():
            launches[b][s](part[p % rows] if spl > 1 else part[p % rows, 0])
        b = 1 - b
        if dens is not None:
            dens_sums.put({s: win.own(b, s).sum() for s in win.local})
        if (p + 1) % rows == 0 or p + 1 == n:
            p0 = p - p % rows
            _reduce(win, {s: part[:p + 1 - p0].sum(dim=2).reshape(-1)
                          for s, part in parts.items()}, av, t0 + p0 * spl)
    dens_sums.flush()
    return b


def _run_windows(mesh: Mesh, params: LBMParams, iters: int, kernel: str, g: int, f0,
                 masks: list, n_fluid: torch.Tensor, collect_density: bool):
    """``pallas`` or ``stream`` on windows of g ghost rows: passes of g
    steps (the K-step local form for ``pallas``, the stream kernel for
    ``stream``; none when g = 1), then the ``iters % g`` tail on the 1-step
    local kernel."""
    win = _Windows(mesh, params.ny, params.nx, g)
    ly, lx, local = win.ly, win.lx, win.local
    win.load(params, f0)
    av = torch.empty(iters, dtype=torch.float32, device=win.home)
    dens = torch.empty(iters, dtype=torch.float32, device=win.home) if collect_density else None
    passes, tail = divmod(iters, g) if g > 1 else (0, iters)
    b = 0
    if passes:
        if kernel == "stream":
            window_pass = (stream_kernel.window_ca_steps_2d if mesh.torus
                           else stream_kernel.window_ca_steps)
            tiles = stream_kernel.num_tiles(win.h, win.w)
            launches = [{s: functools.partial(_stream_window, window_pass, win.bufs[b][s],
                                              masks[s], params, win.bufs[1 - b][s])
                         for s in local} for b in range(2)]
        else:
            tiles = local_kernel.num_tiles(ly, lx)
            launches = [{s: local_kernel.ca_launcher(win.bufs[b][s], masks[s], params, g,
                                                     win.own(1 - b, s))
                         for s in local} for b in range(2)]
        b = _drive(win, launches, b, passes, g, tiles, av, 0, None)
    if tail:
        launches = [{s: local_kernel.step_launcher(win.halo1(win.bufs[b][s]),
                                                   win.halo1(masks[s]), params,
                                                   win.own(1 - b, s), torus=mesh.torus)
                     for s in local} for b in range(2)]
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
    builds and loads its kernels without launching any.  In a process
    group every process makes the same runner and calls it together."""

    def __init__(self, mesh: Mesh, params: LBMParams, n_iters: int, kernel: str,
                 ca_steps: int, collect_density: bool, overlap: bool = False):
        my, mx = mesh.shape
        ny, nx = params.ny, params.nx
        if mesh.torus:
            if ny % my or nx % mx:
                raise ValueError(f"grid {ny}x{nx} not divisible by mesh {my}x{mx}")
        elif ny % my:
            raise ValueError(f"ny={ny} not divisible by {my} devices")
        idle = set(range(multihost.process_count())) - {mesh.owner(s) for s in range(mesh.size)}
        if idle:
            raise ValueError(f"a mesh of {mesh.size} shard(s) leaves process(es) "
                             f"{sorted(idle)} of {multihost.process_count()} without a shard; "
                             "give every process at least one")
        if kernel == "auto":
            kernel = resolve_shard_kernel(params, n_devices=None if mesh.torus else my,
                                          mesh_shape=mesh.shape if mesh.torus else None,
                                          ca_steps=ca_steps, device_type=mesh.devices[0].type)
        if kernel not in SHARD_KERNELS[1:]:
            raise ValueError(f"unknown shard kernel {kernel!r}; use one of "
                             f"{', '.join(SHARD_KERNELS)}")
        if ca_steps < 1:
            raise ValueError(f"ca_steps must be >= 1, got {ca_steps}")
        if overlap and (kernel != "jnp" or ca_steps > 1):
            raise ValueError("overlap=True is the 1-step jnp local schedule; the CA/stream "
                             "schedules already amortize the exchange (use ca_steps)")
        if overlap and mesh.torus:
            raise ValueError("overlap=True is the 1-step jnp schedule of the 1-D ring; "
                             "the torus has none")
        if overlap and ny // mesh.size < 3:
            raise ValueError("overlap=True needs local slabs >= 3 rows (a 2-row slab has "
                             "no halo-independent interior)")
        if mesh.torus and ca_steps > 1 and kernel == "pallas":
            raise ValueError(
                "ca_steps > 1 with kernel='pallas' is not supported on the 2-D torus "
                "(the K-step local kernel assumes an unsharded periodic x axis); use "
                "kernel='jnp' or a 1-D mesh")
        if kernel == "pallas" and ca_steps > 1:
            kstep_kernel.check_k(ca_steps)
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
        self.overlap = overlap
        # ghost depth of the windows: the steps per exchange, or 1 where
        # the run is 1-step exchanges (a kernel path's --debug runs the
        # 1-step local kernel)
        one_step = ca_steps == 1 or (kernel != "jnp" and collect_density)
        self.g = 1 if one_step else ca_steps
        self._setup_for, self._setup = None, None

    @property
    def devices(self) -> list[torch.device]:
        """The devices of this process's shards, each once."""
        return list(dict.fromkeys(self.mesh.devices[s] for s in _local_shards(self.mesh)))

    def prepare(self, obstacles=None) -> None:
        """Build and load the kernels onto every CUDA device of this
        process's shards, launching none; with ``obstacles``, also build the
        run's loop-invariant device masks now, so that a run with the same
        mask object starts stepping at once.  It does not communicate."""
        if self.kernel != "jnp":
            ks = (self.g,) if self.kernel == "pallas" and self.g > 1 else ()
            for d in self.devices:
                local_kernel.prepare(d, ks)
                if self.kernel == "stream":
                    stream_kernel.prepare(d)
        if obstacles is not None:
            self._masks(obstacles)

    def _masks(self, obstacles) -> tuple:
        """(per-shard device masks, global fluid count) for ``obstacles``,
        the host mask every process reads, built once per mask object."""
        if self._setup_for is not obstacles:
            obst = np.asarray(obstacles.cpu() if isinstance(obstacles, torch.Tensor)
                              else obstacles) != 0
            if obst.shape != (self.params.ny, self.params.nx):
                raise ValueError(f"obstacle mask {obst.shape} != grid "
                                 f"({self.params.ny}, {self.params.nx})")
            n_fluid = torch.tensor(float(np.count_nonzero(~obst)),
                                   dtype=torch.float32).to(self.devices[0])
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
                                       n_fluid, self.collect_density, self.overlap)
            else:
                f, av, dens = _run_windows(self.mesh, self.params, self.n_iters, self.kernel,
                                           self.g, f0, masks, n_fluid, self.collect_density)
        return (f, av, dens) if self.collect_density else (f, av)


def make_sharded_runner(mesh: Mesh, params: LBMParams, n_iters: int, kernel: str = "jnp",
                        ca_steps: int = 1, collect_density: bool = False,
                        overlap: bool = False) -> ShardedRunner:
    """The 1-D ring's runner (see :class:`ShardedRunner`); ``overlap`` takes
    the overlapped 1-step jnp schedule (see the module docstring), bitwise
    equal to the default one."""
    return ShardedRunner(mesh, params, n_iters, kernel, ca_steps, collect_density, overlap)


def make_sharded_runner_2d(mesh: Mesh, params: LBMParams, n_iters: int, *, kernel: str = "jnp",
                           ca_steps: int = 1, collect_density: bool = False) -> ShardedRunner:
    """The (my, mx) torus's runner (see :class:`ShardedRunner`)."""
    return ShardedRunner(mesh, params, n_iters, kernel, ca_steps, collect_density)


def prepare_sharded(params: LBMParams, n_iters: int, *, n_devices: int | None = None,
                    devices: Sequence[torch.device | str] | None = None, kernel: str = "jnp",
                    ca_steps: int = 1, collect_density: bool = False,
                    overlap: bool = False) -> ShardedRunner:
    """Validate the 1-D y decomposition over the first ``n_devices`` of
    ``devices`` (default: the visible CUDA cards; in a process group every
    process's, in rank order) and build its runner."""
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
