"""solve_s: the window's wall seconds over the solves it completed: the
time to a deck run's formatted outputs, from its deck files."""


def read(run):
    return run.window_s / len(run.solves)
