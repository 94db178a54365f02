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
            (ops/resident.py)
  pallask   K steps per launch on ghost-zone windows, K = best_k(ny, nx),
            the last iters % K steps on the step kernel (ops/kstep_kernel.py)
  pallas2   the same at K = 2
  fused     the fused step in plain PyTorch (ops/fused.py)
  pipeline  the 4-op reference pipeline (ops/reference.py)
  auto      ``pallask``, the fastest on every grid this port timed on the
            H100 (see ``AUTO_BACKEND``)

``--debug`` on a whole-run backend (resident, pallask, pallas2) runs the
step kernel's loop, which collects the per-step densities: the
counterpart of the JAX package falling back to ``fused`` there.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from advanced_hpc_lbm_tpu_torch.ops import fused, kstep_kernel, reference, resident, step_kernel
from advanced_hpc_lbm_tpu_torch.params import LBMParams
from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io

BACKENDS = ("auto", "step", "pallas", "resident", "pallask", "pallas2", "fused", "pipeline")
# backends of the JAX package that this package does not have yet
NOT_PORTED = ("stream", "sharded")
# the backends that run a whole run per launch (or K steps per launch)
WHOLE_RUN = ("resident", "pallask", "pallas2")


# ``auto``'s backend on every grid, from this port's times on an H100 80GB
# HBM3 at 700 W (PERF.md, Findings): the K-step kernel was the
# fastest path measured from 64^2 to 4096^2 in every run (e.g. 3.2-3.6 us
# per step at 128^2 against 3.6-4.0 for resident and 8-18 for step; 23 us
# at 1024^2 against 32 for step and 41 for resident).
AUTO_BACKEND = "pallask"


def _to_host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


@dataclasses.dataclass
class SimulationResult:
    """Results of one run: on the run's device until :meth:`collate`."""

    params: LBMParams
    f_final: np.ndarray | torch.Tensor  # (9, ny, nx) float32
    av_vels: np.ndarray | torch.Tensor  # (max_iters,) float32
    densities: np.ndarray | torch.Tensor | None = None  # per step (debug mode)

    @property
    def reynolds(self) -> float:
        """av_velocity(final state) * reynolds_dim / viscosity, computed on
        the host in numpy float32 from the final state."""
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
        """Write final_state.dat + av_vels.dat."""
        fs = os.path.join(out_dir, final_state_name)
        av = os.path.join(out_dir, av_vels_name)
        lbm_io.write_final_state(
            fs, _to_host(self.f_final), self._obstacles_cache, self.params
        )
        lbm_io.write_av_vels(av, _to_host(self.av_vels))
        return fs, av

    def collate(self) -> "SimulationResult":
        """Bring the results to the host as numpy arrays (the CLI's Collate
        phase).  Idempotent; applies a deferred ``check_finite``."""
        self.f_final = _to_host(self.f_final)
        self.av_vels = _to_host(self.av_vels)
        self.densities = _to_host(self.densities)
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
        self._obst = torch.from_numpy(self.obstacles).to(self.device)
        self._mask = step_kernel.prepare_obstacles(self._obst)

    @classmethod
    def from_decks(
        cls,
        paramfile: str | os.PathLike,
        obstaclefile: str | os.PathLike,
        **kwargs,
    ) -> "Simulation":
        params = lbm_io.load_params(paramfile)
        obstacles = lbm_io.load_obstacles(obstaclefile, params)
        return cls(params, obstacles, **kwargs)

    def _resolve_backend(self, backend: str) -> str:
        if backend == "auto":
            return AUTO_BACKEND
        if backend == "pallas":
            return "step"
        if backend in BACKENDS:
            return backend
        if backend in NOT_PORTED:
            raise ValueError(
                f"backend {backend!r} is not yet ported to the PyTorch package; "
                f"use one of {', '.join(BACKENDS)}"
            )
        raise ValueError(f"unknown backend: {backend!r}")

    def initial_state(self) -> torch.Tensor:
        return reference.initial_state(self.params, self.device)

    def _k(self) -> int:
        """K of the K-step backends."""
        return 2 if self.backend == "pallas2" else kstep_kernel.best_k(self.params.ny, self.params.nx)

    def _run_on_device(self, iters: int, debug: bool) -> tuple[torch.Tensor, ...]:
        f0 = self.initial_state()
        if self.backend == "resident" and not debug:
            return resident.resident_run(f0, self._mask, self.params, n_iters=iters)
        if self.backend in ("pallask", "pallas2") and not debug:
            return kstep_kernel.run(f0, self._mask, self.params, n_iters=iters, k=self._k())
        if self.backend == "step" or self.backend in WHOLE_RUN:
            # debug mode needs per-step densities: the step kernel's loop
            return step_kernel.run(
                f0, self._mask, self.params, n_iters=iters, collect_density=debug
            )
        step_fn = fused.fused_step if self.backend == "fused" else fused.pipeline_step
        return fused.run_simulation(
            f0, self._obst, self.params, n_iters=iters, step_fn=step_fn,
            collect_density=debug,
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Pay the one-time costs before the Compute timer starts: build the
        kernel library, load every kernel the backend launches onto the
        card (the step kernel too, which runs the K-step backends' tail and
        ``--debug``), and create the CUDA context.  One library serves every
        run length.  It launches no kernel, so that the launch counts of
        the kernel modules count the run alone; the plain backends run one
        throwaway step to load PyTorch's kernels."""
        if self.backend == "step" or self.backend in WHOLE_RUN:
            step_kernel.prepare(self.device)
            if self.backend == "resident":
                resident.prepare(self.device)
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
    ) -> SimulationResult:
        """Execute the main loop on the device.

        ``debug`` also collects per-step total densities.  ``fetch=False``
        waits for the device to finish but leaves the result tensors on it;
        ``result.collate()`` brings them to the host (the CLI times that as
        the Collate phase, and a deferred ``check_finite`` runs there).
        """
        iters = self.params.max_iters if n_iters is None else n_iters
        out = self._run_on_device(iters, debug)
        f_final, av_vels = out[0], out[1]
        densities = out[2] if debug else None
        self._sync()
        result = SimulationResult(
            params=self.params,
            f_final=f_final,
            av_vels=av_vels,
            densities=densities,
        )
        result._obstacles_cache = self.obstacles
        if fetch:
            result.collate()
        if check_finite:
            if fetch:
                self._assert_finite(result)
            else:
                result._check_finite_pending = True
        return result

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
