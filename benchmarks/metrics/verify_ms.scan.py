"""Host ms in Solver._verify (batched exact verification, residue scans
included) per epoch drained, outside the traced stretch."""


def read(run):
    n = run.epochs_outside_stretch()
    return 1e3 * sum(run.host_s("_verify")) / n if n else None
