"""solve_p90_s: the 90th percentile (linear between order statistics) of
the wall seconds of every solve of the window."""

import numpy as np


def read(run):
    return float(np.percentile([s.wall for s in run.solves], 90))
