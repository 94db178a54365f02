"""io.final_state_s: mean seconds per read solve of the program's
``lbm.io.final_state`` spans: the codec formatting and writing
``final_state.dat``.  Nothing without a recording."""

from portbench import spans


def read(run):
    return spans.per_read_solve(run, "lbm.io.final_state")
