"""model.init_s: mean seconds per solve of ``Simulation.from_decks`` (the
deck's parse) and ``warmup``."""


def read(run):
    return sum(s.init for s in run.solves) / len(run.solves)
