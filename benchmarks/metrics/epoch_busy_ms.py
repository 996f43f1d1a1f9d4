"""Device ms per epoch: the device time of every operation that
Solver._epoch launched in the traced stretch, over the epochs it
queued there."""


def read(run):
    t = run.trace
    n = t and t["span_counts"].get("_epoch")
    busy = t and t["device_s_by_span"].get("_epoch")
    return 1e3 * busy / n if n and busy else None
