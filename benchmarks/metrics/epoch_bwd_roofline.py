"""The backward pass's share of its roofline in the traced stretch: for
each epoch_bwd launch the larger of its bytes over HBM bandwidth and its
32-bit products over the multiplier pipe (peaks.bwd_seconds; the
products bound it at the cells' shapes), divided by the device time of
epoch_bwd_kernel."""

from benchmarks import peaks

WATCH = ("bsgs_tpu_torch.ops.epoch_kernel:epoch_bwd_packed",)


def read(run):
    t = run.trace
    calls = run.calls.get(WATCH[0], [])
    sec = t and sum(v for k, v in t["device_s"].items() if "epoch_bwd" in k)
    if not calls or not sec:
        return None
    least = sum(peaks.bwd_seconds(shapes[2][1], shapes[0][1], kw["chunk_c"])
                for shapes, kw in calls)
    return 100.0 * least / sec
