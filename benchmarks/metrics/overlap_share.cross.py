"""Of the probe kernels' device time in the traced stretch, the share
that other device work ran beside: the device time summed over every
operation less the union of their intervals (the time in which two ran
at once, which takes two streams), over probe_rows' device time. Only a
pipelined step's probe runs on a second stream, so this is what that
stream buys: 0 where the probe and the key kernels ran one after the
other, whatever the order they were queued in. None without a card."""


def read(run):
    t = run.trace
    sec = t and sum(v for k, v in t["device_s"].items() if "probe_rows" in k)
    if not sec:
        return None
    both = sum(t["device_s"].values()) - t["busy_s"]
    return 100.0 * max(0.0, both) / sec  # max: the sums' rounding
