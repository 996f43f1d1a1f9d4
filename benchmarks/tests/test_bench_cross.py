"""The cross-pipelined cell (w30_t16_cross.scan) against the contract; a
tiny cross-pipelined cell through the harness on the CPU, in a checkout
of its own (the judge sees every pipelined step's landing keys and hits,
and the faults; the recovery cell's readers read its tails and residue
scans, though the cell does not list them); the cell's two readers, side_probe_ms.cross and
overlap_share.cross: None without a card, their arithmetic on a
synthetic traced stretch, where serialised kernels read no overlap; the
fenced brackets' gaps on synthetic records; and on the card (``-m
chip``) the probe and keys brackets with no synchronisation added, and
both readers' numbers."""

import json
import warnings

import pytest

from benchmarks import control, harness, program_spans as ps
from benchmarks import trace as tr
from benchmarks.tests.conftest import TINY
from bsgs_tpu_torch.utils import tracing

BENCH = harness.load_bench()
CELL = "w30_t16_cross.scan"
READERS = ("side_probe_ms.cross", "overlap_share.cross")
RECOVERY = ("residue_ms.recover", "tail_ms.recover")
CROSS = dict(TINY, cross_pipeline=True)  # TINY's epoch_phases is 1
# rescan positions, as w30_t16's streamed table has (with STREAMED_W
# patched below w): each found key runs a residue scan
CROSS_RESCAN = dict(CROSS, positions="rescan", verify_defer_epochs=64)


def _read(name, run, root=harness.ROOT):
    return harness.reader(name, root).read(run)


@pytest.fixture(scope="module")
def cross_root(tmp_path_factory):
    """A checkout whose cells are TINY pipelined: tiny_cross.scan, and
    tiny_cross_rescan.scan with rescan positions."""
    root = tmp_path_factory.mktemp("cross")
    (root / "benchmarks" / "configs").mkdir(parents=True)
    (root / "benchmarks" / "traffic").mkdir()
    (root / "benchmarks" / "metrics").symlink_to(
        harness.ROOT / "benchmarks" / "metrics")
    confs = {"tiny_cross": CROSS, "tiny_cross_rescan": CROSS_RESCAN}
    for name, geo in confs.items():
        (root / "benchmarks" / "configs" / f"{name}.json").write_text(
            json.dumps({"geometry": geo}))
    (root / "benchmarks" / "traffic" / "t16.json").write_text(
        json.dumps({"bits": 16, "out_of_range_share": 0.25, "prepare": 8}))
    bench = harness.load_bench()
    bench["configs"] = [{"name": n, "source": "test",
                         "file": f"benchmarks/configs/{n}.json",
                         "reduced": [], "why": "test"} for n in confs]
    bench["workloads"] = [{"name": f"{n}.scan", "config": n,
                           "traffic": "t16", "chips": 1, "why": "test"}
                          for n in confs]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_the_cross_cell():
    """w30_t16's geometry but for the two keys, its table, traffic and
    guarantees; one chip; w30_t16.scan's metrics and the two new ones,
    read from the device trace. The step's 2^18 chain totals fold through
    the Montgomery kernels."""
    from bsgs_tpu_torch.models import solver as S
    from bsgs_tpu_torch.ops import epoch_kernel as EK

    cell = harness.load_cell(CELL)
    scan = harness.load_cell("w30_t16.scan")
    (entry,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    assert entry["traffic"] == "puzzle_b64" and cell.chips == 1
    assert cell.traffic == scan.traffic
    geo = dict(cell.geometry)
    assert geo.pop("cross_pipeline") is True and geo.pop("epoch_phases") == 1
    assert geo == {k: v for k, v in scan.geometry.items()
                   if k != "epoch_phases"}
    (conf,) = [c for c in BENCH["configs"] if c["name"] == "w30_t16_cross"]
    assert conf["reduced"] == cell.config["reduced"] == []
    assert cell.config["assumed"] == {}
    assert "README.md:275-277" in cell.config["source"]
    assert "Etayson/BSGS-cuda" in cell.config["source"]
    for key in ("table", "guarantees", "reference"):
        assert cell.config[key] == scan.config[key]
    assert {m["name"] for m in cell.end_to_end} == {
        m["name"] for m in scan.end_to_end} == {
        "keys_per_s", "peak_device_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in scan.per_layer} | set(READERS)
    for m in BENCH["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == [CELL]
            assert (m["source"], m["layer"], m["moves"]) == (
                "device_trace", "device", "keys_per_s")
    cfg = S.SolverConfig(**cell.geometry)
    t, n = cfg.jobs_per_epoch, cfg.n_offsets
    assert cfg.cross_pipeline and cfg.phases == 1
    assert S.layout_fits(n, t, cfg.chunk_c, cfg.lanes_w)
    assert t * n // cfg.chunk_c == 1 << 18 > EK.DIRECT_MAX
    assert t // 4 * n // cfg.chunk_c <= EK.DIRECT_MAX  # w30_t16's phase


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cross_cell_on_the_cpu(cross_root, traced):
    """Every epoch comes through Solver._epoch: the judge samples the
    pipelined step's landing keys and decodes its hits by one phase."""
    tracing.clear()
    cell = harness.load_cell("tiny_cross.scan", cross_root)
    run = harness.run_cell(cell, 2**35 + 27, 3.0, traced, "cpu", None,
                           cross_root)
    assert run.correct, (run.compared, run.checked)
    assert run.checked["lanes"] > 0 and run.checked["hits"] > 0
    assert len(run.host["_epoch"]) >= run.epochs > 0
    if not traced:
        return
    assert ps.window(run) is not None
    m = harness.metrics(run, cross_root)
    assert "dispatch_ms.scan" in m and "launch_ms.scan" in m
    for name in READERS + ("gap_ms.scan",):
        assert name not in m  # no card: no device trace, no brackets
    recs = tracing.records()
    t, n = CROSS["jobs_per_epoch"], CROSS["n_offsets"]
    probes = [r for r in recs if r.name == "probe"]
    keys = [r for r in recs if r.name == "keys"]
    assert probes and len(keys) >= len(probes)
    assert {r.parent for r in probes + keys} == {"launch"}
    assert {r.counts["keys"] for r in probes} == {2 * t * n + t}
    assert {r.counts["T"] for r in keys} == {t}
    tracing.clear()


def test_recovery_readers_on_the_tiny_cross_cell(cross_root, monkeypatch):
    """Rescan positions (a streamed table, as at w = 2^30): each solve
    ends in a tail, where an exhausted range drains its last step through
    Solver._flush, and each found key runs a residue scan; the recovery
    cell's two readers, which only the recovery cell lists, read both
    here."""
    from bsgs_tpu_torch.models import table

    monkeypatch.setattr(table, "STREAMED_W", 128)
    tracing.clear()
    cell = harness.load_cell("tiny_cross_rescan.scan", cross_root)
    run = harness.run_cell(cell, 2**35 + 9, 4.0, True, "cpu", None,
                           cross_root)
    assert run.correct, (run.compared, run.checked)
    assert run.checked["lanes"] > 0
    m = harness.metrics(run, cross_root)
    for name in RECOVERY:
        assert isinstance(m[name]["value"], float), name
        assert m[name]["value"] >= 0
    recs = tracing.records()
    ids = {r.id: r for r in recs}
    flushes = [r for r in recs if r.name == "epoch" and not r.counts
               and ids.get(r.parent_id) is not None
               and ids[r.parent_id].name == "tail"]
    assert flushes
    assert {r.parent for r in recs if r.name == "residue"} == {"lookup"}
    tracing.clear()


@pytest.fixture(scope="module")
def built(cross_root):
    cell = harness.load_cell("tiny_cross.scan", cross_root)
    cr = harness.CellRun(cell, 1, "cpu")
    cr.setup(harness.Run(cell, 1, 1.0, False, "cpu"))
    assert cr.solver._pipelined
    return cell, cr.solver


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_faults_in_the_pipelined_path_are_caught(cross_root, built, fault):
    cell, solver = built
    run = harness.run_cell(cell, 987654321987, 2.0, False, "cpu",
                           root=cross_root, fault=control.FAULTS[fault],
                           solver=solver)
    assert not run.correct, (fault, run.compared)


# -- the readers on synthetic records ------------------------------------
MS = 1e-3


def _span(rec, name, t0, t1, parent=None, epoch=None, device=None,
          **counts):
    s = tracing.Span(rec, len(rec._ring) + 1, name, parent, epoch)
    s.t0, s.t1 = t0, t1
    s.counts = counts or None
    s.device = list(device) if device else None
    rec._ring.append(s)
    return s


def _synthetic(monkeypatch, brackets=True):
    """Ten pipelined steps every 10 ms from t = 100 s, each an epoch with a
    launch holding a probe bracketed [t + 4, t + 6] ms and a keys bracket
    [t + 5, t + 8] ms, in a fenced epoch bracketed [t + 3, t + 8] ms,
    then a collect of 2 hits; step 9's keys bracket never resolved.
    Before the window a warm-up step, and in the traced stretch steps 5
    and 6, left out."""
    rec = tracing.Recorder()
    monkeypatch.setattr(tracing, "RECORDER", rec)
    for i in range(-1, 10):
        t = 100.0 + i * 10 * MS

        def at(a, b):
            return (t + a * MS, t + b * MS) if brackets else None

        ep = _span(rec, "epoch", t, t + 7 * MS, epoch=i, device=at(3, 8),
                   T=4, streams=2, joined=1)
        la = _span(rec, "launch", t + 3 * MS, t + 7 * MS, ep)
        _span(rec, "probe", t + 3 * MS, t + 4 * MS, la, device=at(4, 6),
              keys=68)
        k = _span(rec, "keys", t + 4 * MS, t + 7 * MS, la, device=at(5, 8),
                  T=4)
        if i == 9 and brackets:
            k.device[1] = None
        _span(rec, "collect", t + 8 * MS, t + 9 * MS, epoch=i, hits=2)
    run = harness.Run(harness.Cell("t.scan", {"geometry": CROSS}, 1, {},
                                   [], []), 1, 1.0, True)
    run.host = {"_epoch": [(100.0 + i * 10 * MS, 7 * MS) for i in range(10)],
                "_collect": [(100.008 + i * 10 * MS, MS)
                             for i in range(10)]}
    run.stretch = (100.05, 100.069)  # steps 5 and 6
    return run


def test_gaps_of_fenced_steps_on_synthetic_records(monkeypatch):
    """Fenced: the gaps of both streams' brackets merged, [t + 8, t + 13]
    ms between consecutive steps, none across the stretch; without
    brackets, none."""
    run = _synthetic(monkeypatch)
    assert ps.epochs(run) == 8
    assert _read("gap_ms.scan", run) == pytest.approx(6 * 5.0 / 8)
    run = _synthetic(monkeypatch, brackets=False)
    assert _read("gap_ms.scan", run) is None


def _stretch(overlap_us: float, steps: int = 4) -> dict:
    """A traced stretch of ``steps`` pipelined steps, 1000 us apart, as
    trace.reduce_events gives it: each step's _epoch span launches its key
    kernel, [t, t + 500] us on the first stream, and its probe_rows, 300
    us on the second, starting ``overlap_us`` before the key kernel ends;
    and a memset of 10 us on the first stream after both."""
    ev = [{"cat": "user_annotation", "name": "bench::stretch", "ts": 0.0,
           "dur": 1000.0 * steps}]
    for i in range(steps):
        t = 1000.0 * i
        ev.append({"cat": "user_annotation", "name": "bench::_epoch",
                   "ts": t, "dur": 50.0})
        p0 = t + 500.0 - overlap_us
        for k, (name, cat, a, b) in enumerate((
                ("epoch_bwd_kernel", "kernel", t, t + 500.0),
                ("probe_rows_kernel", "kernel", p0, p0 + 300.0),
                ("Memset (Device)", "gpu_memset", p0 + 300.0,
                 p0 + 310.0))):
            corr = 10 * i + k
            ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": t + 5.0 * k, "dur": 1.0,
                       "args": {"correlation": corr}})
            ev.append({"cat": cat, "name": name, "ts": a, "dur": b - a,
                       "args": {"correlation": corr}})
    return tr.reduce_events(ev)


@pytest.mark.parametrize("overlap_us", [0.0, 120.0, 300.0])
def test_readers_on_a_synthetic_stretch(overlap_us):
    """0.3 ms of probe an epoch; of it, the share the key kernel ran
    beside: none where the two ran one after the other, though both were
    queued at once, and all of it where the probe ran wholly inside the
    key kernel."""
    run = harness.Run(harness.Cell("t.scan", {"geometry": CROSS}, 1, {},
                                   [], []), 1, 1.0, True)
    run.trace = _stretch(overlap_us)
    assert _read("side_probe_ms.cross", run) == pytest.approx(0.3)
    assert _read("overlap_share.cross", run) == pytest.approx(
        100.0 * overlap_us / 300.0)


def test_readers_read_nothing_without_a_card():
    """No traced stretch, or one with no probe kernel (the CPU's)."""
    run = harness.Run(harness.Cell("t.scan", {"geometry": CROSS}, 1, {},
                                   [], []), 1, 1.0, True)
    for trace in (None, tr.reduce_events([])):
        run.trace = trace
        for name in READERS:
            assert _read(name, run) is None, name


# -- on the card ---------------------------------------------------------
def _syncs(fn) -> int:
    """Synchronising CUDA calls fn makes (set_sync_debug_mode warnings)."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in got)


@pytest.mark.chip
def test_cross_brackets_on_the_card(cuda, cross_root):
    """Two pipelined steps (the priming one and one that forks) queue no
    synchronising call with the recorder on, as with it off; the forked
    step's probe bracket (three probe launches) lies inside its epoch's,
    which is fenced; every bracket resolves. Then the tiny cross cell,
    traced on the card, is correct and reads both readers."""
    import torch

    from bsgs_tpu_torch.models import solver as S
    from bsgs_tpu_torch.utils import ecpy

    s = S.Solver(S.SolverConfig(**CROSS), device=cuda)
    pk = 1 << 21
    pub = ecpy.mul(pk + 3 * s.cfg.keys_per_epoch + 77)
    q0 = ecpy.sub(pub, ecpy.mul(pk))

    def steps():
        s._prev = None
        return [s._epoch(q0, 0), s._epoch(q0, 1)]

    was_on = tracing.enabled()  # program_spans turned it on
    steps()  # build and warm
    tracing.disable()
    try:
        off = _syncs(steps)
        tracing.clear()
        tracing.enable()
        on = _syncs(steps)
        recs_queued = steps()
        for rec in recs_queued[1:]:
            s._collect(pub, pk, rec)
        torch.cuda.synchronize()
        recs = tracing.records()
        gaps = tracing.idle_gaps()
    finally:
        (tracing.enable if was_on else tracing.disable)()
    assert on == off == 0
    epoch = [r for r in recs if r.name == "epoch" and r.epoch == 1][-1]
    (launch,) = [r for r in recs if r.parent_id == epoch.id
                 and r.name == "launch"]
    (probe,) = [r for r in recs if r.parent_id == launch.id
                and r.name == "probe"]
    assert epoch.counts["streams"] == 2 and epoch.counts["joined"] == 1
    assert probe.counts["launches"] == 3
    for r in recs:
        if r.device is not None:
            assert None not in r.device, r.name
    assert epoch.device[0] - 1e-5 <= probe.device[0] <= probe.device[1] \
        <= epoch.device[1] + 1e-5
    assert all(a < b for a, b, _ in gaps)
    tracing.clear()
    cell = harness.load_cell("tiny_cross.scan", cross_root)
    run = harness.run_cell(cell, 2**31 + 13, 3.0, True, "cuda", None,
                           cross_root)
    assert run.correct, (run.compared, run.checked)
    m = harness.metrics(run, cross_root)
    for name in READERS + ("gap_ms.scan", "epoch_busy_ms", "probe_roofline",
                           "epoch_bwd_roofline"):
        assert name in m, (name, m)
    assert m["side_probe_ms.cross"]["value"] > 0
    assert 0 <= m["overlap_share.cross"]["value"] <= 100
