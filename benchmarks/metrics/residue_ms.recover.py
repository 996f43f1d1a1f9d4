"""Host ms of the residue scans (span `residue`: each regenerates the
w/256 baby points of a verified hit's residue class, table
.make_strided_lookup) a completed solve: over the solves the window
completed outside the traced stretch. None without the span."""

from benchmarks import program_spans as ps


def read(run):
    done = [s for s in run.solves if not run.in_stretch(*s)]
    if ps.window(run) is None or not done:
        return None
    scans = [r.t1 - r.t0 for r in ps.tracing.records() if r.name == "residue"
             and any(a <= r.t0 and r.t1 <= b for a, b in done)]
    return 1e3 * sum(scans) / len(done) if scans else None
