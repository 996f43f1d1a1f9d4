"""The -infile recovery batch's cell (w30_t16_infile.recover) against the
contract, and its two readers, residue_ms.recover and tail_ms.recover, on
the tiny CPU recover cell: numbers where the program recorded its
`residue` and `tail` spans, None where it recorded nothing."""

import pytest

from benchmarks import harness, program_spans as ps
from bsgs_tpu_torch.utils import tracing

BENCH = harness.load_bench()
READERS = ("residue_ms.recover", "tail_ms.recover")


def _read(name, run, root=harness.ROOT):
    return harness.reader(name, root).read(run)


@pytest.fixture
def streamed_small(monkeypatch):
    from bsgs_tpu_torch.models import table

    monkeypatch.setattr(table, "STREAMED_W", 128)


def test_the_infile_cell():
    """The -infile recovery batch: w30_t16's geometry key for key under
    recover_b58, and the readers whose arithmetic holds on it."""
    cell = harness.load_cell("w30_t16_infile.recover")
    scan = harness.load_cell("w30_t16.scan")
    assert cell.chips == 1 and cell.geometry == scan.geometry
    assert cell.config["reduced"] == [] and cell.config["assumed"] == {}
    assert "1_9_7File.pb:4370" in cell.config["source"]
    assert (cell.traffic["bits"], cell.traffic["out_of_range_share"],
            cell.traffic["prepare"]) == (58, 0.25, 4096)
    assert {m["name"] for m in cell.end_to_end} == {
        "keys_per_s", "peak_device_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "solve_ms_p50.scan", "overscan_share", "verify_ms.scan",
        "lookup_ms.scan", "dispatch_ms.scan", "device_idle.scan",
        "epoch_busy_ms", "probe_roofline", "epoch_bwd_roofline",
        "residue_ms.recover", "tail_ms.recover", "build_s"}
    for m in BENCH["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == ["w30_t16_infile.recover"]
            assert (m["source"], m["moves"], m["unit"], m["better"]) == (
                "program_span", "keys_per_s", "ms", "lower")


def test_readers_on_the_tiny_cell_traced(tiny_root, streamed_small):
    """A range of one or two epochs and a deferral of 64: every solve ends
    in a tail, and each found key in a residue scan inside its lookup;
    both read over the solves the window completed outside the stretch."""
    tracing.clear()
    cell = harness.load_cell("tiny_rescan.recover", tiny_root)
    run = harness.run_cell(cell, 2**35 + 9, 4.0, True, "cpu", None,
                           tiny_root)
    assert run.correct and tracing.enabled()
    m = harness.metrics(run, tiny_root)
    for name in READERS:
        assert isinstance(m[name]["value"], float), name
        assert m[name]["value"] >= 0
    assert ps.window(run) is not None
    done = [s for s in run.solves if not run.in_stretch(*s)]
    ids = {r.id for r in tracing.records() if r.name == "solve"
           and any(a <= r.t0 <= r.t1 <= b for a, b in done)}
    assert done and len(ids) == len(done)
    tails = [r for r in tracing.records()
             if r.name == "tail" and r.solve in ids]
    assert len(tails) == len(done)
    assert m["tail_ms.recover"]["value"] == pytest.approx(
        1e3 * sum(r.t1 - r.t0 for r in tails) / len(tails))
    residue = [r for r in tracing.records()
               if r.name == "residue" and r.solve in ids]
    assert residue and {r.parent for r in residue} == {"lookup"}
    assert m["residue_ms.recover"]["value"] == pytest.approx(
        1e3 * sum(r.t1 - r.t0 for r in residue) / len(done))


def test_readers_with_the_recorder_off(tiny_root, streamed_small,
                                       monkeypatch):
    """The readers read nothing where the program recorded nothing: an
    untraced run with the recorder off."""
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder())
    cell = harness.load_cell("tiny_rescan.recover", tiny_root)
    run = harness.run_cell(cell, 2**36 + 5, 2.0, False, "cpu", None,
                           tiny_root)
    assert run.correct and run.solves and not tracing.enabled()
    assert tracing.records() == []
    for name in READERS:
        assert _read(name, run, tiny_root) is None


def test_readers_of_a_program_without_the_recorder(monkeypatch):
    """A program without the recorder, or a run with no window, reads
    None and does not raise."""
    g = dict(w=1 << 10, htsz=6, n_offsets=8, jobs_per_epoch=4,
             epoch_phases=1)
    run = harness.Run(harness.Cell("t.recover", {"geometry": g}, 1, {},
                                   [], []), 1, 1.0, True)
    for name in READERS:
        assert _read(name, run) is None
    monkeypatch.setattr(ps, "tracing", None)
    for name in READERS:
        assert _read(name, run) is None
