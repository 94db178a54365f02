"""Simulation models. Currently one family: the D2Q9-BGK solver."""

from advanced_hpc_lbm_tpu_torch.models.d2q9_bgk import Simulation, SimulationResult

__all__ = ["Simulation", "SimulationResult"]
