"""model.reynolds_s: mean seconds per read solve of the program's
``lbm.model.reynolds`` spans.  Nothing without a recording."""

from portbench import spans


def read(run):
    return spans.per_read_solve(run, "lbm.model.reynolds")
