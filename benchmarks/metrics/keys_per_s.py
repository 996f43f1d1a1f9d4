"""Keys of the range covered per second of the window, counting only the
keys a solve had to cover: from pk to the key for each solve the window
completed, the whole range for one that exhausts it, and for the solve in
flight at the close the keys its drained epochs covered, up to its key.
Epochs scanned past a key before its pooled verification found it, solve
ends and residue scans take window time and add no keys."""


def read(run):
    return run.useful_keys / run.window_s if run.window_s > 0 else None
