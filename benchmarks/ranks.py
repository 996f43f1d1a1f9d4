"""What the traced stretches of a cell of several cards hold, rank by
rank: each rank profiles its own stretch (harness.run_ranks merges rank
0's Run with the other ranks' traces), so a reader that compares the
ranks reads ``run.trace`` and ``run.rank_traces`` together."""

COLLECTIVE = "nccl"  # device operations of the collectives, by name


def collective_ms(run):
    """For each rank, rank 0 first, device ms of the operations whose name
    holds ``nccl`` (any case) over the epochs the rank queued in its
    stretch (``_epoch`` calls). None on a cell of one card, or where a
    rank has no trace, ran nothing on the device in it or queued no
    epoch."""
    found = [run.trace] + list(run.rank_traces)
    if run.cell.chips < 2 or len(found) != run.cell.chips:
        return None
    out = []
    for t in found:
        n = t and t["span_counts"].get("_epoch")
        if not n or t["busy_s"] <= 0:
            return None
        sec = sum(v for k, v in t["device_s"].items()
                  if COLLECTIVE in k.lower())
        out.append(1e3 * sec / n)
    return out
