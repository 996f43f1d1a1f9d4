"""Host ms of a solve's tail (span `tail`, Solver._scan: from the
dispatch of its last epoch to its return, the drain of the epochs in
flight and the last pooled verification), the mean over the solves the
window completed outside the traced stretch. None without the span."""

import statistics

from benchmarks import program_spans as ps


def read(run):
    done = [s for s in run.solves if not run.in_stretch(*s)]
    if ps.window(run) is None or not done:
        return None
    tails = [r.t1 - r.t0 for r in ps.tracing.records() if r.name == "tail"
             and any(a <= r.t0 and r.t1 <= b for a, b in done)]
    return 1e3 * statistics.fmean(tails) if tails else None
