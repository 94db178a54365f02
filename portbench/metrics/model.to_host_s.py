"""model.to_host_s: mean seconds per read solve of the program's
``lbm.model.to_host`` spans: the state and the av history copied to the
host inside ``collate``.  Nothing without a recording."""

from portbench import spans


def read(run):
    return spans.per_read_solve(run, "lbm.model.to_host")
