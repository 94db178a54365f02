"""model.fit_check_s: mean self seconds per read solve of the program's
``lbm.model.fit_check`` spans: its device-memory queries (the gate of
``auto``'s rule, of ``warmup`` and of ``run``).  Nothing without a
recording."""

from portbench import spans


def read(run):
    return spans.per_read_solve(run, "lbm.model.fit_check", spans.self_seconds)
