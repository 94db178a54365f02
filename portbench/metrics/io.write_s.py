"""io.write_s: mean seconds per solve of ``SimulationResult.write``: the
output planes and the codec's formatting of both files."""


def read(run):
    return sum(s.write for s in run.solves) / len(run.solves)
