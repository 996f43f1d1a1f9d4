"""Host ms per call of Solver._dispatch (one epoch queued), outside the
traced stretch."""

import statistics


def read(run):
    s = run.host_s("_dispatch")
    return 1e3 * statistics.fmean(s) if s else None
