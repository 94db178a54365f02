"""The plain reference of a D2Q9-BGK deck run, in PyTorch.

Written from the reference C solver's semantics (the COMS30006
``d2q9-bgk.c``: accelerate_flow, propagate, rebound, collision,
av_velocity), not from the program under test: it imports nothing of
it.  Each step:

1. forcing on row ``ny - 2``: on fluid cells whose W, NW and SW values stay
   strictly positive after it, E/NE/SE gain ``w1``/``w2``/``w2`` and
   W/NW/SW lose them (``w1 = density*accel/9``, ``w2 = density*accel/36``);
2. pull streaming with periodic wrap;
3. obstacle cells take the streamed value of the opposite speed
   (bounce-back); fluid cells relax toward the second-order equilibrium of
   their streamed moments, ``f += omega*(feq - f)``;
4. the step's average velocity: the mean of ||u|| of the post-collision
   state over the fluid cells.

It computes in float64, so that it stands for the exact run: the
program's float32 rounding, which drifts the mass of a deck by ~1e-4 over
its run, is then measured against the exact run, not against another
float32 rounding of it.  The moments are matrix products of the (9,
cells) state with the lattice's velocity table.  ``tf32=True`` runs the
control instead: float32, every operand of those products rounded to TF32
(10 mantissa bits, round to nearest even), as a float32 product on a
tensor core reads them: the precision below the float32 with TF32 off
that the configurations state.  The rounding is done explicitly, so that
the control is the same on any device.

On a CUDA device the steps run as CUDA graphs of ``GRAPH_STEPS`` steps (the
same operations, replayed), so that a deck of 80 000 small steps is not
paced by the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
CY = (0, 0, 1, 0, -1, 1, 1, -1, -1)
OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)
W = (4.0 / 9.0,) + (1.0 / 9.0,) * 4 + (1.0 / 36.0,) * 4
GRAPH_STEPS = 100


@dataclasses.dataclass(frozen=True)
class Deck:
    """The seven numbers of a ``.params`` file and the (ny, nx) bool mask of
    an obstacle file (True = blocked)."""

    nx: int
    ny: int
    max_iters: int
    reynolds_dim: int
    density: float
    accel: float
    omega: float
    obstacles: np.ndarray

    @property
    def viscosity(self) -> float:
        return (2.0 / self.omega - 1.0) / 6.0


def read_deck(params_path, obstacles_path) -> Deck:
    """A deck from its two files: the params file's first seven lines
    (nx, ny, maxIters, reynolds_dim as integers; density, accel, omega),
    and the obstacle file's ``x y 1`` lines."""
    with open(params_path) as fh:
        vals = [ln.split()[0] for ln in fh if ln.strip()][:7]
    if len(vals) != 7:
        raise ValueError(f"{params_path}: expected 7 values, got {len(vals)}")
    nx, ny, iters, rdim = (int(v) for v in vals[:4])
    density, accel, omega = (float(v) for v in vals[4:])
    triples = np.loadtxt(obstacles_path, dtype=np.int64, ndmin=2)
    if triples.shape[1] != 3 or np.any(triples[:, 2] != 1):
        raise ValueError(f"{obstacles_path}: expected lines of x y 1")
    xs, ys = triples[:, 0], triples[:, 1]
    if xs.min() < 0 or xs.max() >= nx or ys.min() < 0 or ys.max() >= ny:
        raise ValueError(f"{obstacles_path}: a cell lies outside the {nx}x{ny} grid")
    mask = np.zeros((ny, nx), dtype=bool)
    mask[ys, xs] = True
    return Deck(nx, ny, iters, rdim, density, accel, omega, mask)


def rest_state(deck: Deck) -> np.ndarray:
    """The 9 float32 values of the equilibrium at rest at the deck's
    density (4/9, 1/9 and 1/36 of it)."""
    d = np.float32(deck.density)
    return np.array([d * np.float32(w) for w in W], dtype=np.float32)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits, to nearest, ties to even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32)


class Reference:
    """The deck's run from a given initial state, on ``device``: float64,
    or with ``tf32`` the float32 control with TF32 operands."""

    def __init__(self, deck: Deck, device, *, tf32: bool = False) -> None:
        self.deck = deck
        self.device = torch.device(device)
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64
        ny, nx = deck.ny, deck.nx
        n = ny * nx
        dev = self.device
        f32 = dict(dtype=self.dtype, device=dev)
        obst = torch.from_numpy(deck.obstacles).to(dev)
        self.fluid = (~obst).reshape(-1).to(self.dtype)
        self.n_fluid = float(self.fluid.sum().item())
        self.obst_idx = torch.nonzero(obst.reshape(-1)).reshape(-1)
        self.opp = torch.tensor(OPP, dtype=torch.long, device=dev)
        # moments: rows density, x momentum, y momentum
        self.moments = torch.tensor([[1.0] * 9, list(CX), list(CY)], **f32)
        self.velocities = torch.tensor(list(zip(CX, CY)), **f32)  # (9, 2)
        self.weights = torch.tensor(W, **f32)[:, None]
        # the pull: out[k, y, x] = f[k, y - CY[k], x - CX[k]], wrapped
        yy = torch.arange(ny, device=dev)[:, None]
        xx = torch.arange(nx, device=dev)[None, :]
        self.pull = torch.stack([
            k * n + ((yy - CY[k]) % ny) * nx + (xx - CX[k]) % nx for k in range(9)
        ]).reshape(-1)
        self.row = ny - 2
        self.row_fluid = ~obst[self.row]
        w1, w2 = deck.density * deck.accel / 9.0, deck.density * deck.accel / 36.0
        self.force = torch.tensor([0.0, w1, 0.0, -w1, 0.0, w2, -w2, -w2, w2], **f32)[:, None]
        self.w1, self.w2 = w1, w2
        self.omega = deck.omega

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return _tf32(a) @ _tf32(b)
        return a @ b

    def _velocity(self, f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(rho (cells,), u (2, cells)) of a (9, cells) state."""
        m = self._mm(self.moments, f)
        return m[0], m[1:] / m[0]

    def step(self, f: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """One step from ``f`` ((9, ny, nx), modified: the forcing is applied
        to it in place) into ``out``; returns the step's average velocity (a
        0-dim tensor)."""
        n = self.deck.ny * self.deck.nx
        row = f[:, self.row, :]
        ok = (self.row_fluid & (row[3] - self.w1 > 0) & (row[6] - self.w2 > 0)
              & (row[7] - self.w2 > 0))
        row.add_(self.force * ok)
        s = torch.index_select(f.reshape(-1), 0, self.pull).reshape(9, n)
        rho, u = self._velocity(s)
        u_sq = u[0] * u[0] + u[1] * u[1]
        cu = self._mm(self.velocities, u)  # (9, cells)
        feq = (self.weights * rho) * (1.0 - 1.5 * u_sq + cu * (3.0 + 4.5 * cu))
        o = out.reshape(9, n)
        torch.add(s, feq - s, alpha=self.omega, out=o)
        o[:, self.obst_idx] = s[self.opp[:, None], self.obst_idx[None, :]]
        _, v = self._velocity(o)
        norm = torch.sqrt(v[0] * v[0] + v[1] * v[1])
        return torch.dot(norm, self.fluid) / self.n_fluid

    def run(self, f0: torch.Tensor, n_iters: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
        """``n_iters`` steps (default the deck's) from ``f0`` (not
        modified).  Returns (final state (9, ny, nx), av history (steps,))
        on the device, in the run's precision."""
        iters = self.deck.max_iters if n_iters is None else n_iters
        f = f0.to(self.device, self.dtype)
        bufs = [f.clone(), torch.empty_like(f)]
        av = torch.empty(iters, dtype=self.dtype, device=self.device)
        if self.device.type != "cuda" or iters < 2 * GRAPH_STEPS:
            for t in range(iters):
                av[t] = self.step(bufs[t % 2], bufs[(t + 1) % 2])
            return bufs[iters % 2], av
        # a graph of GRAPH_STEPS steps from bufs[0] back into bufs[0]
        chunk = torch.empty(GRAPH_STEPS, dtype=self.dtype, device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):  # warm-up on copies, as capture wants
            scratch = [bufs[0].clone(), torch.empty_like(bufs[0])]
            for t in range(2):
                self.step(scratch[t % 2], scratch[(t + 1) % 2])
        torch.cuda.current_stream(self.device).wait_stream(side)
        del scratch
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for t in range(GRAPH_STEPS):
                chunk[t] = self.step(bufs[t % 2], bufs[(t + 1) % 2])
        graphs, tail = divmod(iters, GRAPH_STEPS)
        for g in range(graphs):
            graph.replay()
            av[g * GRAPH_STEPS:(g + 1) * GRAPH_STEPS] = chunk
        graph.reset()
        f = bufs[0]  # GRAPH_STEPS is even: every replay ends in bufs[0]
        for t in range(tail):
            av[graphs * GRAPH_STEPS + t] = self.step(bufs[t % 2], bufs[(t + 1) % 2])
        return bufs[tail % 2] if tail else f, av


def output_planes(deck: Deck, f: np.ndarray) -> dict[str, np.ndarray]:
    """The flat columns of ``final_state.dat`` that a (9, ny, nx) state
    gives, in its precision and raster order (y outer, x inner): ``u_x``,
    ``u_y``, ``u`` (the speed) and ``pressure`` (density / 3), blocked
    cells at u = 0 and the deck's density / 3, as the reference writer
    prints them."""
    f = np.asarray(f).reshape(9, -1)
    rho = f.sum(axis=0)
    ux = (f[1] + f[5] + f[8] - (f[3] + f[6] + f[7])) / rho
    uy = (f[2] + f[5] + f[6] - (f[4] + f[7] + f[8])) / rho
    blocked = deck.obstacles.reshape(-1)
    zero = f.dtype.type(0)
    return {
        "u_x": np.where(blocked, zero, ux),
        "u_y": np.where(blocked, zero, uy),
        "u": np.where(blocked, zero, np.sqrt(ux * ux + uy * uy)),
        "pressure": np.where(blocked, f.dtype.type(deck.density / 3.0), rho / 3.0),
    }


def obstacle_column(deck: Deck) -> np.ndarray:
    """The last column of ``final_state.dat``: the reference writer prints
    ``obstacles[ii*nx + jj]`` on the line of cell (x = ii, y = jj), a
    transposed read of the flat mask, clipped to its last cell."""
    flat = deck.obstacles.reshape(-1).astype(np.int64)
    nx = deck.nx
    ii = np.tile(np.arange(nx), deck.ny)
    jj = np.repeat(np.arange(deck.ny), nx)
    return flat[np.minimum(ii * nx + jj, flat.size - 1)]


def reynolds(deck: Deck, final_av: float) -> float:
    """The Reynolds number of a run whose last step's average velocity is
    ``final_av``: av * reynolds_dim / viscosity."""
    return float(final_av) * deck.reynolds_dim / deck.viscosity
