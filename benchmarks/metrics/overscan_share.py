"""Share of the giant steps drained in the window that lay past the key of
their solve: scanned while the key's epoch waited in the pooled
verification (and the rest of the key's own epoch). It falls when a
solve verifies its hits sooner."""


def read(run):
    covered = 2 * run.w * run.steps
    if covered <= 0:
        return None
    return 100.0 * (1.0 - run.useful_keys / covered)
