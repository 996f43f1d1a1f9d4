"""The cell of several cards: the readers of what only several cards do
(collective_ms, rank_wait_ms) on synthetic traces of four ranks, and four
gloo ranks on the CPU through a tiny cell whose configuration carries
w3x30_t128_x4's mesh block."""

import json

import pytest

from benchmarks import harness, traffic
from benchmarks.tests.conftest import TINY

X4 = "w3x30_t128_x4"
# readers of rank 0's merged Run that the four-card cell lists
ON_RANK0 = ("dispatch_ms.scan", "solve_ms_p50.scan", "overscan_share",
            "verify_ms.scan", "epoch_busy_ms", "probe_roofline",
            "epoch_bwd_roofline", "device_idle.scan")
NCCL = "ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long, int)"


def _read(name, run, root=harness.ROOT):
    return harness.reader(name, root).read(run)


def _cell(chips):
    g = dict(w=1 << 10, htsz=6, n_offsets=8, jobs_per_epoch=4,
             epoch_phases=1)
    return harness.Cell("t.scan", {"geometry": g}, chips, {}, [], [])


def _trace(nccl_s, epochs=10, busy_s=0.5):
    return {"window_s": 1.0, "busy_s": busy_s,
            "device_s": {NCCL: nccl_s, "probe_rows_kernel": 0.3,
                         "Memcpy DtoH (Device -> Pinned)": 0.001},
            "device_s_by_span": {}, "idle_s_by_span": {},
            "span_counts": {"_epoch": epochs, "_collect": epochs}}


def _run(traces, chips=4):
    run = harness.Run(_cell(chips), 1, 1.0, True, trace=traces[0])
    run.rank_traces = list(traces[1:])
    return run


def test_collective_and_wait_over_four_ranks():
    # ranks' NCCL ms an epoch: 4.0, 1.0, 2.5, 7.0 (rank 3 over 20 epochs)
    run = _run([_trace(0.040), _trace(0.010), _trace(0.025),
                _trace(0.140, epochs=20)])
    assert _read("collective_ms", run) == pytest.approx(1.0)
    assert _read("rank_wait_ms", run) == pytest.approx(7.0 - 1.0)
    # the name is matched in any case, and only the collectives count
    t = _trace(0.0)
    t["device_s"]["NCCL_Broadcast"] = 0.020
    run = _run([t, _trace(0.030), _trace(0.030), _trace(0.030)])
    assert _read("collective_ms", run) == pytest.approx(2.0)
    assert _read("rank_wait_ms", run) == pytest.approx(1.0)


@pytest.mark.parametrize("case", ["one card", "no traces", "a rank without",
                                  "no _epoch", "no device work"])
def test_collective_readers_return_nothing(case):
    four = [_trace(0.01) for _ in range(4)]
    run = {"one card": lambda: _run(four[:1], chips=1),
           "no traces": lambda: _run([None, None, None, None]),
           "a rank without": lambda: _run(four[:3] + [None]),
           "no _epoch": lambda: _run(four[:3] + [dict(
               four[3], span_counts={"_collect": 10})]),
           "no device work": lambda: _run(four[:1] + [_trace(
               0.0, busy_s=0.0)] + four[2:])}[case]()
    assert _read("collective_ms", run) is None
    assert _read("rank_wait_ms", run) is None


def test_the_x4_cell_is_listed_where_rank_0_reads():
    bench = harness.load_bench()
    cell = harness.load_cell(X4 + ".scan")
    assert cell.chips == 4 and cell.traffic["bits"] == 70
    assert cell.config["mesh"] == {"shard_baby_table": False,
                                   "probe_routing": "all_gather"}
    one = json.loads((harness.ROOT / "benchmarks" / "configs"
                      / "w3x30_t128.json").read_text())
    assert cell.geometry == one["geometry"]
    layer = {m["name"] for m in cell.per_layer}
    # build_s lists no cells: it moves setup_s, which every cell reports
    assert layer == set(ON_RANK0) | {"collective_ms", "rank_wait_ms",
                                     "build_s"}
    assert {m["name"] for m in cell.end_to_end} == {
        "keys_per_s", "peak_device_gib", "setup_s"}
    for m in bench["per_layer"]:
        if m["name"] in ("collective_ms", "rank_wait_ms"):
            assert m["workloads"] == [X4 + ".scan"]
            assert m["layer"] == "several cards"


@pytest.fixture(scope="module")
def x4_root(tmp_path_factory):
    """A checkout of its own: one tiny four-rank cell with the mesh block
    of w3x30_t128_x4, and the benchmark's metric readers."""
    root = tmp_path_factory.mktemp("checkout_x4")
    (root / "benchmarks" / "configs").mkdir(parents=True)
    (root / "benchmarks" / "traffic").mkdir()
    (root / "benchmarks" / "metrics").symlink_to(
        harness.ROOT / "benchmarks" / "metrics")
    mesh = harness.load_cell(X4 + ".scan").config["mesh"]
    (root / "benchmarks" / "configs" / "tiny_x4_mesh.json").write_text(
        json.dumps({"geometry": TINY, "mesh": mesh}))
    (root / "benchmarks" / "traffic" / "t20.json").write_text(
        json.dumps({"bits": 20, "out_of_range_share": 0.25,
                    "prepare": 8}))
    bench = harness.load_bench()
    bench["configs"] = [{"name": "tiny_x4_mesh", "source": "test",
                         "file": "benchmarks/configs/tiny_x4_mesh.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny_x4_mesh.scan",
                           "config": "tiny_x4_mesh", "traffic": "t20",
                           "chips": 4, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny_x4_mesh.scan"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_cell_of_four_ranks_with_the_x4_mesh(x4_root):
    """Four gloo ranks through MeshSolver with the four-card cell's mesh
    options, traced: correct, every rank's trace back, and no number under
    a device metric on the CPU."""
    cell = harness.load_cell("tiny_x4_mesh.scan", x4_root)
    assert cell.config["mesh"]["probe_routing"] == "all_gather"
    seed = 2**41 + 9
    run = harness.run_ranks(cell, seed, 3.0, True, "cpu", None, x4_root)
    assert run.correct, (run.compared, run.checked)
    assert run.checked["solves"] == len(run.solves) + 1 >= 2
    assert run.checked["lanes"] > 0 and run.checked["hits"] > 0
    assert len(run.rank_traces) == 3 and all(run.rank_traces)
    assert run.forbidden == []
    assert run.steps >= len(run.solves) * (2 * 8 + 1) * 4 * 4
    reqs = traffic.Generator(cell.traffic, seed).take(len(run.solves) + 1)
    done = sum(harness.needed_keys(r) for r in reqs[:-1])
    assert done <= run.useful_keys <= done + harness.needed_keys(reqs[-1])
    m = harness.metrics(run, x4_root)
    # (verify_ms.scan reads the epochs outside the stretch: at 0.75 s an
    # epoch on the CPU a 3-s window may hold none)
    for name in ("dispatch_ms.scan", "solve_ms_p50.scan", "overscan_share"):
        assert name in m, m
    for name in ("collective_ms", "rank_wait_ms", "epoch_busy_ms",
                 "device_idle.scan", "probe_roofline"):
        assert name not in m, m
