"""The probe kernel's share of its roofline in the traced stretch: the
bytes its keys need (peaks.probe_bytes_per_key over the table's row
lengths) over HBM bandwidth, divided by the device time of
probe_rows_kernel."""

from benchmarks import peaks

WATCH = ("bsgs_tpu_torch.ops.probe_kernel:probe_rows",)


def read(run):
    t = run.trace
    calls = run.calls.get(WATCH[0], [])
    sec = t and sum(v for k, v in t["device_s"].items() if "probe_rows" in k)
    if not calls or not sec or not run.row_len_counts:
        return None
    keys = sum(shapes[0][0] for shapes, _ in calls)
    need = keys * peaks.probe_bytes_per_key(run.row_len_counts,
                                            run.row_len_bytes)
    return 100.0 * need / peaks.HBM_BYTES_PER_S / sec
