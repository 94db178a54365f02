"""io.av_vels_s: mean seconds per read solve of the program's
``lbm.io.av_vels`` spans: the codec formatting and writing
``av_vels.dat``.  Nothing without a recording."""

from portbench import spans


def read(run):
    return spans.per_read_solve(run, "lbm.io.av_vels")
