"""The metric arithmetic at tiny sizes: readers, work counts, the trace's
reduction."""

import pytest

from benchmarks import harness, peaks, trace


def _cell(**geo):
    g = dict(w=1 << 10, htsz=6, n_offsets=8, jobs_per_epoch=4,
             epoch_phases=1)
    g.update(geo)
    return harness.Cell("t.scan", {"geometry": g}, 1, {}, [], [])


def _read(name, run):
    return harness.reader(name).read(run)


def test_keys_per_s_is_the_whole_window():
    # 1000 steps of 2w keys drained, of which 1.5M were needed
    run = harness.Run(_cell(), 1, 10.0, False, window_s=4.0, steps=1000,
                      useful_keys=1_500_000)
    assert _read("keys_per_s", run) == 1_500_000 / 4.0
    assert _read("overscan_share", run) == pytest.approx(
        100 * (1 - 1_500_000 / (2 * 1024 * 1000)))
    assert _read("keys_per_s", harness.Run(_cell(), 1, 1, False)) is None
    assert _read("overscan_share", harness.Run(_cell(), 1, 1, False)) \
        is None


def test_needed_keys_stop_at_the_key():
    from benchmarks.traffic import Request

    assert harness.needed_keys(Request(None, 100, 199, 150, True)) == 51
    assert harness.needed_keys(Request(None, 100, 199, 300, False)) == 100


def test_solve_median_over_all_solves():
    solves = [(0.0, (i + 1) / 1e3) for i in range(100)]  # 1 .. 100 ms
    run = harness.Run(_cell(), 1, 1.0, False, solves=solves)
    assert _read("solve_ms_p50.scan", run) == pytest.approx(50.5)


def test_host_spans_leave_out_the_stretch():
    run = harness.Run(_cell(), 1, 1.0, True, stretch=(10.0, 12.0))
    run.host = {"_dispatch": [(1.0, 0.002), (11.0, 0.5), (13.0, 0.004)],
                "_collect": [(1.5, 0.1), (11.5, 0.1), (13.5, 0.1)],
                "_verify": [(2.0, 0.010), (11.2, 9.0)]}
    run.solves = [(0.5, 3.0), (10.5, 11.9), (12.5, 14.0)]
    assert _read("dispatch_ms.scan", run) == pytest.approx(3.0)
    assert _read("verify_ms.scan", run) == pytest.approx(10.0 / 2)


def test_field_product_counts():
    assert peaks.FIELD_MUL == 2 * (64 + 9) == 146
    assert peaks.FIELD_SQR == 2 * (36 + 9) == 90
    assert peaks.BWD_PAIR_PRODUCTS == 4 * 146 + 2 * 90


def test_epoch_bwd_bound():
    t, n, c = 32, 1 << 18, 16
    nbytes = 32 * (2 * n + 2 * t + t * n + t * n // c) + 32 * t * n
    assert peaks.bwd_bytes(t, n, c) == nbytes
    mul = t * n * 764 / peaks.MUL_PIPE_PER_S
    # at the cells' shapes the products bound the pass, not the bytes
    assert nbytes / peaks.HBM_BYTES_PER_S < mul
    assert peaks.bwd_seconds(t, n, c) == pytest.approx(mul)
    assert peaks.bwd_seconds(1, n, 1) == pytest.approx(
        peaks.bwd_bytes(1, n, 1) / peaks.HBM_BYTES_PER_S)


def test_probe_bytes_per_key():
    # rows of 0, 8 and 9 entries: 0, 1 and 2 sectors of 32 B
    got = peaks.probe_bytes_per_key({0: 1, 8: 1, 9: 2}, 1)
    assert got == 9 + 1 + 32 * (0 + 1 + 2 * 2) / 4


def _ev(cat, name, ts, dur, **args):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_trace_reduction():
    events = [
        _ev("user_annotation", "bench::stretch", 0, 100),
        _ev("user_annotation", "bench::_epoch", 1, 4),
        _ev("user_annotation", "bench::_verify", 50, 30),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 60, 1, correlation=3),
        _ev("kernel", "probe_rows_kernel", 10, 20, correlation=1),
        _ev("kernel", "epoch_bwd_kernel", 20, 20, correlation=2),
        _ev("kernel", "add_const_kernel", 70, 10, correlation=3),
        _ev("gpu_memcpy", "Memcpy HtoD", 95, 10, correlation=9),
    ]
    r = trace.reduce_events(events)
    assert r["window_s"] == pytest.approx(100e-6)
    # busy: [10, 40] + [70, 80] + [95, 100] clipped = 45 us
    assert r["busy_s"] == pytest.approx(45e-6)
    assert r["device_s_by_span"]["_epoch"] == pytest.approx(40e-6)
    assert r["device_s_by_span"]["_verify"] == pytest.approx(10e-6)
    assert r["device_s"]["probe_rows_kernel"] == pytest.approx(20e-6)
    # idle: [0,10] in _epoch? midpoint 5 lies in _epoch [1, 5]; [40, 70]
    # midpoint 55 in _verify; [80, 95] midpoint 87.5 outside any span
    assert r["idle_s_by_span"]["_epoch"] == pytest.approx(10e-6)
    assert r["idle_s_by_span"]["_verify"] == pytest.approx(30e-6)
    assert r["idle_s_by_span"][trace.OTHER_HOST] == pytest.approx(15e-6)
    assert r["span_counts"] == {"_epoch": 1, "_verify": 1}

    run = harness.Run(_cell(), 1, 1.0, True, trace=r)
    assert _read("device_idle.scan", run) == pytest.approx(55.0)
    assert _read("epoch_busy_ms", run) == pytest.approx(40e-3)
    assert trace.top(r["device_s"], 2)[0][0] == "probe_rows_kernel"


def test_rooflines_from_logged_calls():
    r = {"device_s": {"void probe_rows_kernel(...)": 1e-3,
                      "epoch_bwd_kernel": 2e-3}}
    run = harness.Run(_cell(), 1, 1.0, True, trace=r,
                      row_len_counts={8: 4}, row_len_bytes=1)
    run.calls = {
        "bsgs_tpu_torch.ops.probe_kernel:probe_rows":
            [([(1000,), (1000,), (64, 16), (64,)], {})] * 2,
        "bsgs_tpu_torch.ops.epoch_kernel:epoch_bwd_packed":
            [([(8, 4096), (8, 4096), (8, 8), (8, 8)], {"chunk_c": 16})]}
    probe = 2000 * (9 + 1 + 32) / peaks.HBM_BYTES_PER_S / 1e-3 * 100
    assert _read("probe_roofline", run) == pytest.approx(probe)
    bwd = peaks.bwd_seconds(8, 4096, 16) / 2e-3 * 100
    assert _read("epoch_bwd_roofline", run) == pytest.approx(bwd)


def test_readers_return_nothing_without_a_trace():
    run = harness.Run(_cell(), 1, 1.0, True)
    for name in ("probe_roofline", "epoch_bwd_roofline", "epoch_busy_ms",
                 "device_idle.scan", "dispatch_ms.scan", "verify_ms.scan",
                 "solve_ms_p50.scan"):
        assert _read(name, run) is None

