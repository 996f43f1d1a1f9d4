"""The median time of every solve the window completed, from its
Solver.solve call to its return."""

import statistics


def read(run):
    ms = [(t1 - t0) * 1e3 for t0, t1 in run.solves]
    return statistics.median(ms) if ms else None
