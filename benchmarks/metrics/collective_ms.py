"""Device ms of the collectives a super-epoch, on a cell of several cards:
for each rank's traced stretch, the device time of the NCCL operations
over the epochs the rank queued there; the least over the ranks. The
rank that reaches the gather last waits least in it, so its time is the
exchange itself."""

from benchmarks import ranks


def read(run):
    per_rank = ranks.collective_ms(run)
    return min(per_rank) if per_rank else None
