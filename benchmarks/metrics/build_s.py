"""Seconds of the set-up's table build (solver.build_table), from a
synchronise to a synchronise."""


def read(run):
    return run.build_s
