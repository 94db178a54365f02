"""The D2Q9-BGK simulation model: state + end-to-end run, in PyTorch.

The counterpart of ``advanced_hpc_lbm_tpu.models.d2q9_bgk``: deck loading,
backend selection, the main loop on one device, diagnostics (the Reynolds
number) and output writing.  The argv and timing scaffolding lives in
:mod:`advanced_hpc_lbm_tpu_torch.cli`.

Backends (each CUDA kernel runs its plain PyTorch version on the CPU):
  step      one launch of the hand-written CUDA step kernel per timestep
            (ops/step_kernel.py)
  pallas    the JAX package's name for the per-step kernel: runs ``step``
  resident  the whole run in one cooperative launch per chunk of steps
            (ops/resident.py): the banded form on the small decks, the
            cooperative form (K = 3 steps per round; bands cut into
            segments where they are fewer than the SMs) on every other grid
  pallask   K steps per launch on ghost-zone windows, K = best_k(ny, nx),
            the last iters % K steps on the step kernel (ops/kstep_kernel.py)
  pallas2   the same at K = 2
  stream    K = 8 steps per launch in one state buffer, in place
            (ops/stream_kernel.py), the last iters % 8 steps on the step
            kernel; where no second state fits beside that buffer, the
            gate refuses a run with such a tail
  fused     the fused step in plain PyTorch (ops/fused.py)
  pipeline  the 4-op reference pipeline (ops/reference.py)
  auto      on a CUDA card, ``resident`` where its banded form takes the
            grid (the small decks), else ``pallask``, or ``stream`` where
            pallask's two state buffers do not fit on the card (see
            ``AUTO_BACKEND``); off CUDA ``pallask``
  sharded   the grid cut over a device mesh, halos exchanged between the
            shards (parallel/halo.py): a ring of ``devices`` shards or a
            ``mesh`` = (my, mx) torus, each shard on the shard kernel
            ``shard_kernel`` (auto, jnp, pallas, stream) with ``ca_steps``
            steps per exchange; ``devices`` > 1 or a ``mesh`` selects it
            whatever the backend, as in the JAX package

``--debug`` on a whole-run backend (resident, pallask, pallas2, stream)
runs the step kernel's loop, which collects the per-step densities: the
counterpart of the JAX package falling back to ``fused`` there.  On the
sharded path the densities are each step's shard sums, added in shard
order.

``checkpoint_every`` / ``resume`` run the deck as segments of at most
``checkpoint_every`` steps on the backend a straight run takes, with a
snapshot (utils/checkpoint.py) after each (``_run_checkpointed``).

Before it allocates a state, a run checks that the backend's device
memory fits in 0.9 of the card's (``_check_single_chip_fit``), as the JAX
package checks the TPU's HBM.

Under a multi-process launch (``parallel/multihost.py``) every process
makes the same Simulation.  On the sharded path the mesh spans the
processes, each driving its own shards, and ``collate()`` gathers the
whole state into every process; any other backend runs the whole deck in
each process on its own device.  Either way only the primary process
writes (``SimulationResult.write``).  A checkpointed run is refused there:
the JAX package's snapshot ``device_get``s a state that spans processes,
which it cannot do.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from advanced_hpc_lbm_tpu_torch.ops import (
    fused, kstep_kernel, reference, resident, step_kernel, stream_kernel,
)
from advanced_hpc_lbm_tpu_torch.parallel import halo, multihost
from advanced_hpc_lbm_tpu_torch.params import LBMParams
from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io
from advanced_hpc_lbm_tpu_torch.utils import profiling
from advanced_hpc_lbm_tpu_torch.utils.checkpoint import CheckpointManager

BACKENDS = ("auto", "step", "pallas", "resident", "pallask", "pallas2", "stream",
            "fused", "pipeline", "sharded")
# the backends that run a whole run per launch (or K steps per launch)
WHOLE_RUN = ("resident", "pallask", "pallas2", "stream")


# ``auto``'s backend wherever its two state buffers fit, from this port's
# times on an H100 80GB HBM3 at 700 W (chip_smoke.py 3r/3k/3s, PERF.md,
# Findings).  Where the resident kernel's banded form takes the grid (the
# small decks, ``resident.takes_banded``), ``auto`` runs ``resident``
# instead: 2.98 / 2.97 / 3.22 us per step at 64^2 / 128^2 / 256^2 against
# pallask's 3.49 / 3.98 / 3.81 (K = 5, host-paced), as the JAX ``auto``
# runs its resident kernel on small grids.  Elsewhere the K-step kernel is
# the fastest path (18.75 us per step at 1024^2, K = 3, against 32.51 for
# step and 25.08 for the resident kernel's cooperative form, which the JAX
# ``auto`` would run there; 60.01 against 86.99 at 2048^2, 243.04 against
# 330.85 at 4096^2, 6.55 against 6.96 at 512^2; of the grids timed only
# 256x512, 4.34 against 3.80, went the other way, too few for a rule on
# the shape) and faster than the stream kernel on every grid timed
# from 2048^2 to 16384^2 (964 against 1202 us per step at 8192^2, 3862
# against 4154 at 16384^2).  Where it does not fit, ``auto`` runs
# ``stream`` (``Simulation._resolve_backend``).
AUTO_BACKEND = "pallask"


# Share of the card's memory a run may plan to use, as the JAX package's
# HBM gate plans with 0.9 of the TPU's.
FIT_MARGIN = 0.9


def _device_memory_bytes(device: torch.device | str) -> int | None:
    """The card's device memory, or None off CUDA (a CPU run pages, as the
    JAX package's gate skips every device but the TPU); each call is one
    ``lbm.model.fit_check`` span."""
    with profiling.span("lbm.model.fit_check"):
        device = torch.device(device)
        if device.type != "cuda":
            return None
        try:
            return int(torch.cuda.mem_get_info(device)[1])
        except RuntimeError:
            return int(torch.cuda.get_device_properties(device).total_memory)


def _to_host(x):
    """A tensor as a numpy array; a state on the card plane by plane, so
    that the copy needs no device memory of its own; a sharded state plane
    by plane and shard by shard, and one that spans processes gathered into
    every process (collective: every process calls it)."""
    if isinstance(x, halo.ShardedState):
        return x.numpy()
    if not isinstance(x, torch.Tensor):
        return x
    if x.dim() == 3 and x.is_cuda:
        out = np.empty(tuple(x.shape), dtype=np.float32)
        for k in range(x.shape[0]):
            torch.from_numpy(out[k]).copy_(x[k])
        return out
    return x.cpu().numpy()


def _fetch(x):
    """:func:`_to_host` as the ``lbm.model.to_host`` span, with the bytes
    it brought; None stays None."""
    if x is None:
        return None
    with profiling.span("lbm.model.to_host") as sp:
        out = _to_host(x)
        sp.set(bytes=int(out.nbytes))
    return out


@dataclasses.dataclass
class SimulationResult:
    """Results of one run: on the run's device until :meth:`collate`."""

    params: LBMParams
    f_final: np.ndarray | torch.Tensor | halo.ShardedState  # (9, ny, nx) float32
    av_vels: np.ndarray | torch.Tensor  # (max_iters,) float32
    densities: np.ndarray | torch.Tensor | None = None  # per step (debug mode)

    @property
    def reynolds(self) -> float:
        """av_velocity(final state) * reynolds_dim / viscosity, computed on
        the host in numpy float32 from the final state."""
        with profiling.span("lbm.model.reynolds"):
            f = np.asarray(_to_host(self.f_final), dtype=np.float32)
            rho = f.sum(axis=0)
            u_x = (f[1] + f[5] + f[8] - (f[3] + f[6] + f[7])) / rho
            u_y = (f[2] + f[5] + f[6] - (f[4] + f[7] + f[8])) / rho
            fluid = ~self._obstacles_cache
            norm = np.sqrt(u_x * u_x + u_y * u_y, dtype=np.float32)
            av = np.float32(norm[fluid].sum(dtype=np.float32)) / np.float32(
                fluid.sum()
            )
            return float(av * np.float32(self.params.reynolds_dim) / np.float32(
                self.params.viscosity
            ))

    # filled in by Simulation.run; kept out of the dataclass signature
    _obstacles_cache: np.ndarray = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # set by run(fetch=False, check_finite=True): the finiteness gate is
    # deferred to collate() because the arrays are still on the device
    _check_finite_pending: bool = dataclasses.field(
        default=False, repr=False, compare=False
    )

    def write(
        self,
        out_dir: str | os.PathLike = ".",
        *,
        final_state_name: str = lbm_io.FINAL_STATE_FILE,
        av_vels_name: str = lbm_io.AV_VELS_FILE,
    ) -> tuple[str, str]:
        """Write final_state.dat + av_vels.dat, from the primary process
        only: every process calls it (a state that spans processes is
        gathered first), and the files are written once."""
        fs = os.path.join(out_dir, final_state_name)
        av = os.path.join(out_dir, av_vels_name)
        with profiling.span("lbm.io.write"):
            f, av_vels = _to_host(self.f_final), _to_host(self.av_vels)
            if multihost.is_primary():
                lbm_io.write_final_state(fs, f, self._obstacles_cache, self.params)
                lbm_io.write_av_vels(av, av_vels)
        return fs, av

    def collate(self) -> "SimulationResult":
        """Bring the results to the host as numpy arrays (the CLI's Collate
        phase).  Idempotent; applies a deferred ``check_finite``."""
        with profiling.span("lbm.model.collate"):
            self.f_final = _fetch(self.f_final)
            self.av_vels = _fetch(self.av_vels)
            self.densities = _fetch(self.densities)
            if self._check_finite_pending:
                self._check_finite_pending = False
                Simulation._assert_finite(self)
        return self


class Simulation:
    """One configured D2Q9-BGK run: params + obstacle mask + backend, on one
    device."""

    def __init__(
        self,
        params: LBMParams,
        obstacles: np.ndarray,
        *,
        backend: str = "auto",
        device: torch.device | str = "cuda",
    ) -> None:
        if obstacles.shape != (params.ny, params.nx):
            raise ValueError(
                f"obstacle mask {obstacles.shape} != grid ({params.ny}, {params.nx})"
            )
        self.params = params
        self.obstacles = np.asarray(obstacles, dtype=bool)
        self.device = torch.device(device)
        self.backend = self._resolve_backend(backend)
        self._runners: dict = {}

    # the masks on the device, made at first use, so that a run holds only
    # the one its backend reads; the kernels' masks are encoded there from
    # the bool plane (the host's encoding took seconds on the largest grids)
    @functools.cached_property
    def _obst(self) -> torch.Tensor:
        return torch.from_numpy(self.obstacles).to(self.device)

    @functools.cached_property
    def _mask(self) -> torch.Tensor:
        return step_kernel.prepare_obstacles(torch.from_numpy(self.obstacles).to(self.device))

    @functools.cached_property
    def _enc(self) -> torch.Tensor:
        return stream_kernel.prepare_obstacles(torch.from_numpy(self.obstacles).to(self.device))

    @classmethod
    def from_decks(
        cls,
        paramfile: str | os.PathLike,
        obstaclefile: str | os.PathLike,
        **kwargs,
    ) -> "Simulation":
        with profiling.span("lbm.model.from_decks"):
            params = lbm_io.load_params(paramfile)
            obstacles = lbm_io.load_obstacles(obstaclefile, params)
            return cls(params, obstacles, **kwargs)

    def _resolve_backend(self, backend: str) -> str:
        if backend == "auto":
            if resident.takes_banded(self.params.ny, self.params.nx, self.device):
                return "resident"
            mem = _device_memory_bytes(self.device)
            if (mem is not None
                    and self._need_bytes(AUTO_BACKEND, False) > FIT_MARGIN * mem
                    and self._need_bytes("stream", False) <= FIT_MARGIN * mem):
                # pallask's two state buffers do not fit, the in-place
                # stream tier does: the fall-through of the JAX auto rule
                return "stream"
            return AUTO_BACKEND
        if backend == "pallas":
            return "step"
        if backend in BACKENDS:
            return backend
        raise ValueError(f"unknown backend: {backend!r}")

    def initial_state(self) -> torch.Tensor:
        return reference.initial_state(self.params, self.device)

    def _k(self) -> int:
        """K of the K-step backends."""
        return 2 if self.backend == "pallas2" else kstep_kernel.best_k(self.params.ny, self.params.nx)

    def _state_bytes(self) -> int:
        return 4 * 9 * self.params.ny * self.params.nx

    def _need_bytes(self, backend: str, debug: bool) -> int:
        """Device memory of a run: the in-place stream tier's (the least
        the stream backend needs); two state buffers and the mask for the
        kernel loops (the run starts in the initial state's own buffer);
        three states for the plain PyTorch backends, as the JAX gate
        models its scan (in, out, one transient)."""
        ny, nx = self.params.ny, self.params.nx
        if backend == "stream" and not debug:
            return stream_kernel.tier_bytes(ny, nx)
        if backend in ("fused", "pipeline"):
            return 3 * self._state_bytes()
        return 2 * self._state_bytes() + ny * nx

    def _stream_tail_fits(self) -> bool:
        """Whether a second state (and the step kernel's mask) fits beside
        the in-place stream tier, as the step kernel's tail needs."""
        mem = _device_memory_bytes(self.device)
        ny, nx = self.params.ny, self.params.nx
        return mem is None or (self._need_bytes("stream", False) + self._state_bytes()
                               + ny * nx <= FIT_MARGIN * mem)

    def _check_single_chip_fit(self, debug: bool = False, lengths: tuple[int, ...] = ()) -> None:
        """Fail with an actionable message on grids whose run would not fit
        in the card's device memory, before any state is allocated, instead
        of a CUDA out-of-memory error inside the run: the counterpart of
        the JAX package's gate, with its 0.9 margin.  A stream run of one
        of ``lengths`` (its segments' step counts) whose tail's second
        state does not fit is refused too."""
        mem = _device_memory_bytes(self.device)
        if mem is None:
            return
        need = self._need_bytes(self.backend, debug)
        if need <= FIT_MARGIN * mem:
            if self.backend == "stream" and not debug and not self._stream_tail_fits():
                for n in lengths:
                    stream_kernel.refuse_tail(n)
            return
        ny, nx = self.params.ny, self.params.nx
        # suggest the streaming tier only where its own need fits
        stream_fits = self._need_bytes("stream", False) <= FIT_MARGIN * mem
        stream_helps = not debug and self.backend != "stream" and stream_fits
        # with --debug every backend runs the step kernel's two-buffer
        # loop, so the fix is dropping the flag, not switching kernels
        debug_helps = debug and stream_fits
        label = ("streaming" if self.backend == "stream" and not debug
                 else "two state buffers and the mask")
        raise ValueError(
            f"grid {ny}x{nx} needs ~{need / 2**30:.1f} GB of device memory ({label}), "
            f"exceeding {FIT_MARGIN:.0%} of this card's {mem / 2**30:.0f} GB"
            + (", use --backend stream (in-place single-buffer kernel: one state "
               "buffer, the mask and a side buffer of at most a quarter of a state)"
               if stream_helps else "")
            + ("; --debug forces the step kernel's two-buffer loop at this size: "
               "drop it to use the streaming tier" if debug_helps else "")
            + ("" if stream_helps or debug_helps
               else "; no single-card backend of this port fits it")
        )

    def _iters(self, n_iters: int | None) -> int:
        """The run's step count: ``n_iters``, or the deck's; a negative one
        raises before anything is allocated, with the deck's wording."""
        iters = self.params.max_iters if n_iters is None else n_iters
        if iters < 0:
            raise ValueError(f"max_iters must be >= 0, got {iters}")
        return iters

    def _is_sharded(self, devices: int | None, mesh: tuple[int, int] | None) -> bool:
        """One definition of "this run is sharded" for warmup() and run()."""
        return self.backend == "sharded" or (devices is not None and devices > 1) \
            or mesh is not None

    @staticmethod
    def _validate_flags(sharded: bool, *, ca_steps: int, checkpoint_every: int | None = None,
                        resume: bool = False) -> None:
        """Flag-composition errors, raised from both warmup() and run()."""
        if checkpoint_every is not None and checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be >= 0, got {checkpoint_every}")
        if (checkpoint_every or resume) and multihost.process_count() > 1:
            raise ValueError(
                "checkpoint/resume runs in a single process: a snapshot gathers the state "
                f"to one host, and this run has {multihost.process_count()} processes")
        if ca_steps > 1 and not sharded:
            raise ValueError(
                "ca_steps > 1 is a property of the halo exchange and needs the sharded "
                "backend (--devices N or --mesh MYxMX); on one device use the pallask "
                "backend for time tiling instead"
            )

    def _sharded_runner(self, iters: int, devices: int | None, shard_kernel: str,
                        mesh: tuple[int, int] | None, ca_steps: int, debug: bool,
                        shard_devices) -> halo.ShardedRunner:
        """The runner of a sharded configuration, cached under its resolved
        shard kernel so that run() reuses the device masks warmup() built
        in it.  The mesh takes
        ``shard_devices`` (a device may repeat; in a process group, this
        process's); by default on the CPU every shard on the CPU (in a
        process group, each process an equal share of them), on CUDA the
        visible cards (in a process group, each process's own card)."""
        if shard_devices is None and self.device.type == "cpu":
            n = mesh[0] * mesh[1] if mesh is not None else (devices or 1)
            shard_devices = [self.device] * -(-n // multihost.process_count())
        if mesh is not None:
            runner = halo.prepare_sharded_2d(self.params, iters, mesh, devices=shard_devices,
                                             kernel=shard_kernel, ca_steps=ca_steps,
                                             collect_density=debug)
        else:
            runner = halo.prepare_sharded(self.params, iters, n_devices=devices,
                                          devices=shard_devices, kernel=shard_kernel,
                                          ca_steps=ca_steps, collect_density=debug)
        key = (iters, runner.mesh, runner.kernel, runner.ca_steps, debug)
        return self._runners.setdefault(key, runner)

    def _run_on_device(self, iters: int, debug: bool,
                       f0: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
        """The run from ``f0`` (default: the initial state), a contiguous
        state on the device that the kernel loops take as their first
        buffer (donate), so that a run holds two states at most, and stream
        without a tail one."""
        if f0 is None:
            with profiling.span("lbm.model.initial_state"):
                f0 = self.initial_state()
        if self.backend == "resident" and not debug:
            return resident.resident_run(f0, self._mask, self.params, n_iters=iters,
                                         donate=True)
        if self.backend in ("pallask", "pallas2") and not debug:
            return kstep_kernel.run(f0, self._mask, self.params, n_iters=iters, k=self._k(),
                                    donate=True)
        if self.backend == "stream" and not debug:
            return stream_kernel.run(f0, self._enc, self.params, n_iters=iters, donate=True)
        if self.backend == "step" or self.backend in WHOLE_RUN:
            # debug mode needs per-step densities: the step kernel's loop
            return step_kernel.run(
                f0, self._mask, self.params, n_iters=iters, collect_density=debug,
                donate=True,
            )
        step_fn = fused.fused_step if self.backend == "fused" else fused.pipeline_step
        return fused.run_simulation(
            f0, self._obst, self.params, n_iters=iters, step_fn=step_fn,
            collect_density=debug,
        )

    def _sync(self, devices=None) -> None:
        with profiling.span("lbm.model.sync"):
            for d in dict.fromkeys(devices or (self.device,)):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

    @staticmethod
    def _segments(start: int, iters: int, every: int) -> list[int]:
        """The step counts of the segments from step ``start`` to ``iters``
        at most ``every`` steps each."""
        out = []
        while start < iters:
            out.append(min(every, iters - start))
            start += out[-1]
        return out

    def warmup(
        self,
        *,
        n_iters: int | None = None,
        debug: bool = False,
        devices: int | None = None,
        shard_kernel: str = "auto",
        mesh: tuple[int, int] | None = None,
        ca_steps: int = 1,
        shard_devices=None,
        checkpoint_every: int | None = None,
        checkpoint_dir: str | os.PathLike = "checkpoints",
        resume: bool = False,
    ) -> None:
        """Pay the one-time costs before the Compute timer starts: build the
        kernel library, load every kernel the backend launches onto the
        card (the step kernel too, which runs the K-step backends' tail and
        ``--debug``), and create the CUDA context.  One library serves every
        run length.  It launches no kernel, so that the launch counts of
        the kernel modules count the run alone; the plain backends run one
        throwaway step to load PyTorch's kernels.  A grid that does not
        fit on the card raises here, before anything is allocated.  Pass
        the sharded arguments the run will take (see :meth:`run`): a bad
        decomposition raises here.  With ``checkpoint_every``/``resume``
        it resolves the resume point as the run will (the newest readable
        snapshot), does nothing when that is at or past the target, and
        validates every segment length the run will take (the sharded
        runner of each; a stream tail the card cannot hold raises)."""
        with profiling.span("lbm.model.warmup"):
            iters = self._iters(n_iters)
            sharded = self._is_sharded(devices, mesh)
            self._validate_flags(sharded, ca_steps=ca_steps, checkpoint_every=checkpoint_every,
                                 resume=resume)
            lengths: tuple[int, ...] = ()
            if checkpoint_every or resume:
                start = CheckpointManager(checkpoint_dir).latest_step() if resume else 0
                if start >= iters:
                    return  # the resume point is at or past the target: nothing runs
                lengths = tuple(dict.fromkeys(
                    self._segments(start, iters, checkpoint_every or iters)))
            if sharded:
                # the runners first: a mesh that spans processes is gathered
                runners = [self._sharded_runner(seg, devices, shard_kernel, mesh, ca_steps, debug,
                                                shard_devices) for seg in lengths or (iters,)]
                with multihost.primary_first():
                    for runner in runners:
                        runner.prepare(self.obstacles)
                self._sync(runners[-1].devices)
                return
            self._check_single_chip_fit(debug, lengths)
            # one process builds the kernels
            with profiling.span("lbm.ops.prepare"), multihost.primary_first():
                if self.backend == "step" or self.backend in WHOLE_RUN:
                    step_kernel.prepare(self.device)
                    if self.backend == "resident":
                        resident.prepare(self.device)
                    elif self.backend == "stream":
                        stream_kernel.prepare(self.device)
                    elif self.backend in WHOLE_RUN:
                        kstep_kernel.prepare(self.device, self._k())
                else:
                    self._run_on_device(1, False)
            self._sync()

    def run(
        self,
        *,
        n_iters: int | None = None,
        debug: bool = False,
        check_finite: bool = False,
        fetch: bool = True,
        devices: int | None = None,
        shard_kernel: str = "auto",
        mesh: tuple[int, int] | None = None,
        ca_steps: int = 1,
        shard_devices=None,
        checkpoint_every: int | None = None,
        checkpoint_dir: str | os.PathLike = "checkpoints",
        resume: bool = False,
    ) -> SimulationResult:
        """Execute the main loop on the device.

        ``debug`` also collects per-step total densities.  ``fetch=False``
        waits for the device to finish but leaves the result tensors on it;
        ``result.collate()`` brings them to the host (the CLI times that as
        the Collate phase, and a deferred ``check_finite`` runs there).
        ``devices`` > 1 selects the sharded path over a 1-D ring, ``mesh`` =
        (my, mx) over a torus (parallel/halo.py); ``shard_kernel`` and
        ``ca_steps`` (steps per halo exchange) choose its schedule, and
        ``shard_devices`` the devices of its mesh (a device may repeat;
        default: every shard on the CPU for a CPU run, the visible cards
        for a CUDA one).  The sharded state stays on the mesh until
        ``collate()``, which gathers it plane by plane.
        ``checkpoint_every`` snapshots the state every N steps into
        ``checkpoint_dir`` (utils/checkpoint.py); ``resume`` continues from
        the newest readable snapshot there.  A checkpointed run gathers
        its state to the host after every segment anyway, so it returns
        host arrays whatever ``fetch`` says: ``collate()`` is then a no-op,
        and ``check_finite`` applies before it returns.
        """
        with profiling.span("lbm.model.run", backend=self.backend):
            iters = self._iters(n_iters)
            sharded = self._is_sharded(devices, mesh)
            self._validate_flags(sharded, ca_steps=ca_steps, checkpoint_every=checkpoint_every,
                                 resume=resume)
            if checkpoint_every or resume:
                result = self._run_checkpointed(
                    iters, checkpoint_every or iters, checkpoint_dir, resume, debug=debug,
                    sharded=sharded, devices=devices, shard_kernel=shard_kernel, mesh=mesh,
                    ca_steps=ca_steps, shard_devices=shard_devices)
                if check_finite:
                    self._assert_finite(result)
                return result
            if sharded:
                runner = self._sharded_runner(iters, devices, shard_kernel, mesh, ca_steps, debug,
                                              shard_devices)
                out = runner(None, self.obstacles)
                self._sync(runner.devices)
            else:
                self._check_single_chip_fit(debug, (iters,))
                out = self._run_on_device(iters, debug)
                self._sync()
            result = self._result(out[0], out[1], out[2] if debug else None)
            if fetch:
                result.collate()
            if check_finite:
                if fetch:
                    self._assert_finite(result)
                else:
                    result._check_finite_pending = True
            return result

    def _result(self, f_final, av_vels, densities) -> SimulationResult:
        result = SimulationResult(params=self.params, f_final=f_final, av_vels=av_vels,
                                  densities=densities)
        result._obstacles_cache = self.obstacles
        return result

    def _run_checkpointed(
        self,
        iters: int,
        every: int,
        checkpoint_dir: str | os.PathLike,
        resume: bool,
        *,
        debug: bool,
        sharded: bool,
        devices: int | None,
        shard_kernel: str,
        mesh: tuple[int, int] | None,
        ca_steps: int,
        shard_devices,
    ) -> SimulationResult:
        """The segment loop: segments of ``every`` steps on the backend a
        straight run takes, a snapshot after each.

        Every distinct segment length is validated before the first
        segment runs (the sharded runner of each; a stream tail the card
        cannot hold), so a run that would fail in its last segment writes
        no snapshot.  On one device the state stays on the device from
        segment to segment, each segment's loop taking the last one's
        buffer; a resumed state goes onto the device once, as one buffer.
        A snapshot gathers the state plane by plane (``_to_host``), so it
        needs no device memory.  On the sharded path each segment starts
        from the host copy that its snapshot gathered: each runner builds
        its own ghosted windows, and the last segment's windows are gone
        before the next one's are allocated.
        """
        mgr = CheckpointManager(checkpoint_dir)
        start = 0
        f = None  # None: the initial state, made by the first segment's run
        av_parts: list[np.ndarray] = []
        dens_parts: list[np.ndarray] = []
        if resume:
            latest = mgr.latest()
            if latest is not None:
                start, f, av_prev, dens_prev = latest
                if start > iters:
                    raise ValueError(f"checkpoint at step {start} is beyond requested {iters}")
                av_parts.append(av_prev[:start])
                if debug:
                    # a snapshot written without --debug has no density
                    # history: those steps read NaN, so the later ones stay
                    # aligned with av_vels
                    dens_parts.append(dens_prev[:start] if dens_prev is not None
                                      else np.full((start,), np.nan, np.float32))
        segments = self._segments(start, iters, every)
        if sharded:
            runners = {seg: self._sharded_runner(seg, devices, shard_kernel, mesh, ca_steps,
                                                 debug, shard_devices)
                       for seg in dict.fromkeys(segments)}
        else:
            self._check_single_chip_fit(debug, tuple(dict.fromkeys(segments)))
            if f is not None and segments:
                f = torch.from_numpy(f).to(self.device)
        host_f = f if isinstance(f, np.ndarray) else None
        done = start
        for seg in segments:
            if sharded:
                runner = runners[seg]
                out = runner(host_f, self.obstacles)
                self._sync(runner.devices)
            else:
                out = self._run_on_device(seg, debug, f)
                self._sync()
                f = out[0]
            host_f = _to_host(out[0])
            av_parts.append(_to_host(out[1]))
            if debug:
                dens_parts.append(_to_host(out[2]))
            out = None  # a sharded state's windows go before the next segment's
            done += seg
            mgr.save(done, host_f, np.concatenate(av_parts),
                     densities=np.concatenate(dens_parts) if debug else None)
        if host_f is None:  # nothing ran and nothing was resumed
            host_f = _to_host(self.initial_state())
        return self._result(
            host_f,
            np.concatenate(av_parts) if av_parts else np.zeros((0,), np.float32),
            np.concatenate(dens_parts) if dens_parts else None,
        )

    @staticmethod
    def _assert_finite(result: SimulationResult) -> None:
        """Fail loudly with the first bad step instead of writing NaN output
        files."""
        if not np.all(np.isfinite(result.f_final)):
            raise FloatingPointError("non-finite values in final state")
        bad = np.flatnonzero(~np.isfinite(result.av_vels))
        if bad.size:
            raise FloatingPointError(
                f"non-finite av_velocity first at step {int(bad[0])}"
            )
