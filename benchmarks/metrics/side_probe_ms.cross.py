"""Device ms of the probe kernels an epoch in the traced stretch: the
device time of probe_rows (a pipelined step launches three, on the second
stream, over the previous epoch's 2TN + T keys) over the Solver._epoch
calls queued there; a solve's flush probes once more, on the first
stream. None without a card."""


def read(run):
    t = run.trace
    n = t and t["span_counts"].get("_epoch")
    sec = t and sum(v for k, v in t["device_s"].items() if "probe_rows" in k)
    return 1e3 * sec / n if n and sec else None
