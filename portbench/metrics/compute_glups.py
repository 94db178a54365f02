"""compute_glups: the window's cell updates over its Compute seconds, 1e9
a unit: sum of nx * ny * steps over sum of the Compute spans (the CLI's
Compute timer: ``Simulation.run`` up to its device synchronise)."""


def read(run):
    deck = run.cell.deck
    work = deck.nx * deck.ny * deck.max_iters * len(run.solves)
    return work / sum(s.compute for s in run.solves) * 1e-9
