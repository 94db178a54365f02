"""The inputs of a run, made from ``--seed``: the deck's initial state with
a small, seeded perturbation.

The deck is the published one whatever the seed.  The seed draws, on the
device, one uniform number r_k in [0, 1) per cell and speed; each cell's
nine values are moved by ``AMPLITUDE * density * (r_k - mean_k r)``, which
sums to 0 over the cell's speeds, so every cell keeps its density.  No
value moves by more than ``AMPLITUDE * density``, under 4% of the smallest
rest value (density / 36), so every value stays positive and the forcing
guard reads as it would at rest.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import lbm

AMPLITUDE = 1e-3


def initial_state(deck: lbm.Deck, seed: int, device) -> torch.Tensor:
    """The (9, ny, nx) float32 initial state of ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    r = torch.rand((9, deck.ny, deck.nx), generator=gen, device=device, dtype=torch.float32)
    r -= r.mean(dim=0, keepdim=True)
    rest = torch.from_numpy(lbm.rest_state(deck)).to(device)[:, None, None]
    return rest + np.float32(AMPLITUDE * deck.density) * r
