"""ops.launches: kernel launches per read solve, the sum of the
``launches`` counts (the program's launch counters' growth) of its
``lbm.ops.loop`` spans, the run loop under every single-device kernel.
Nothing without a recording or a loop."""

from portbench import spans


def read(run):
    return spans.per_read_solve(run, "lbm.ops.loop", lambda rec, s: s.attrs["launches"])
