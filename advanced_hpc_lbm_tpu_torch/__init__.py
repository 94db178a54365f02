"""advanced_hpc_lbm_tpu_torch — the D2Q9-BGK lattice-Boltzmann engine in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``advanced_hpc_lbm_tpu`` that keeps its module layout: each
module here has its counterpart at the same relative path there, and the
tests hold the two packages to each other on the same inputs.  This package
imports torch and numpy, never JAX.  State is the ``(9, ny, nx)`` float32
distribution tensor on an explicit ``torch.device``.

Layout:
  models/  — the simulation "model": state container + end-to-end run
  ops/     — lattice constants, reference ops, fused step, the CUDA
             kernels' wrappers (step, resident, K-step, stream, local),
             the one run loop under the single-device ones, and the
             kernel library's boundary and build-at-first-use
  csrc/    — CUDA C++ sources of the kernels
  parallel/ — device meshes (across processes too), the halo-exchanged
             sharded runners, the multi-process bootstrap, batches of
             independent decks
  utils/   — I/O codecs (with the native codec's build), validation
             checker, timers, checkpoint/resume, profiling, viz
"""

from advanced_hpc_lbm_tpu_torch.params import LBMParams
from advanced_hpc_lbm_tpu_torch.models.d2q9_bgk import Simulation, SimulationResult

__version__ = "0.1.0"

__all__ = ["LBMParams", "Simulation", "SimulationResult", "__version__"]
