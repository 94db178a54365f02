"""model.collate_s: mean seconds per solve of ``SimulationResult.collate``
and ``.reynolds``."""


def read(run):
    return sum(s.collate for s in run.solves) / len(run.solves)
