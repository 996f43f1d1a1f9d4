"""Device ms a super-epoch in which the earliest rank's gather waits for
the slowest rank to finish its epoch: the ranks' collective_ms (NCCL
device ms over the epochs of each rank's traced stretch), the most less
the least."""

from benchmarks import ranks


def read(run):
    per_rank = ranks.collective_ms(run)
    return max(per_rank) - min(per_rank) if per_rank else None
