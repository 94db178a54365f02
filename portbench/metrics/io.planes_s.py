"""io.planes_s: mean seconds per read solve of the program's
``lbm.io.planes`` spans: the output planes (speed, pressure, obstacle
column) made for the writer.  Nothing without a recording."""

from portbench import spans


def read(run):
    return spans.per_read_solve(run, "lbm.io.planes")
