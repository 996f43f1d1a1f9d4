"""Share of the traced stretch in which no operation ran on the device:
1 - (union of the device's operation intervals) / the stretch's length."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
