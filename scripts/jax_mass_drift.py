#!/usr/bin/env python
"""Run a deck through the JAX package and print how far its total density
drifted (float64 sum of f, relative to the initial state), its Reynolds
number and its wall time: the reference side of the PyTorch port's mass
check (chip_smoke.py phase 5r).

Usage: JAX_PLATFORMS=cpu python scripts/jax_mass_drift.py \\
           decks/reference_256x256.params decks/reference_256x256.obstacles.dat \\
           [--backend fused] [--iters N]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paramfile")
    ap.add_argument("obstaclefile")
    ap.add_argument("--backend", default="fused")
    ap.add_argument("--iters", type=int, default=None)
    args = ap.parse_args(argv)
    sim = Simulation.from_decks(args.paramfile, args.obstaclefile, backend=args.backend)
    mass0 = float(np.asarray(sim.initial_state(), dtype=np.float64).sum())
    tic = time.perf_counter()
    res = sim.run(n_iters=args.iters)
    seconds = time.perf_counter() - tic
    mass1 = float(np.asarray(res.f_final, dtype=np.float64).sum())
    print(f"{args.paramfile}: {res.av_vels.shape[0]} steps on {sim.backend}, mass drift "
          f"{(mass1 - mass0) / mass0:.6e}, Reynolds {res.reynolds:.6E}, {seconds:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
