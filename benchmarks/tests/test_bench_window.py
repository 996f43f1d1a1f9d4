"""The window loop end to end at a tiny geometry, on the port's plain
versions on the CPU, through the functions run.py uses; cells defined
only in this file's own data; the control and the faults."""

import time

import pytest

from benchmarks import control, harness, traffic
from benchmarks.tests.conftest import TINY

@pytest.fixture
def streamed_small(monkeypatch):
    from bsgs_tpu_torch.models import table

    monkeypatch.setattr(table, "STREAMED_W", 128)


def test_a_cell_of_new_data_loads(tiny_root):
    cell = harness.load_cell("tiny.scan", tiny_root)
    assert cell.geometry == TINY and cell.traffic["bits"] == 16
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "keys_per_s"}
    assert {"overscan_share", "solve_ms_p50.scan"} <= {
        m["name"] for m in cell.per_layer}
    with pytest.raises(ValueError):
        harness.load_cell("no.such", tiny_root)


@pytest.mark.parametrize("name", ["tiny.scan", "tiny_rescan.recover"])
def test_window_end_to_end(tiny_root, streamed_small, name):
    cell = harness.load_cell(name, tiny_root)
    t0 = time.perf_counter()
    run = harness.run_cell(cell, 2**33 + 17, 3.0, False, "cpu", t0,
                           tiny_root)
    assert run.correct, (run.compared, run.checked)
    assert run.checked["solves"] == len(run.solves) + 1 >= 2  # + warm-up
    assert run.checked["lanes"] > 0 and run.checked["hits"] > 0
    assert run.window_s >= 3.0 and 0 < run.setup_s < time.perf_counter()
    # every solve in the window drained its epochs into the count
    assert run.steps >= len(run.solves) * (2 * 8 + 1) * 4
    # the keys counted stop at each solve's key; the solve in flight at the
    # close adds at most what it still needed
    reqs = traffic.Generator(cell.traffic, 2**33 + 17).take(
        len(run.solves) + 1)
    done = sum(harness.needed_keys(r) for r in reqs[:-1])
    assert done <= run.useful_keys <= done + harness.needed_keys(reqs[-1])
    assert run.useful_keys <= 2 * 256 * run.steps
    kps = harness.reader("keys_per_s", tiny_root).read(run)
    assert kps == run.useful_keys / run.window_s
    if name.startswith("tiny_rescan"):
        assert run.cell.geometry["positions"] == "rescan"
    with pytest.raises(ValueError):
        harness.result(run, "cpu", tiny_root)  # no device numbers here


def test_traced_window_on_the_cpu(tiny_root):
    cell = harness.load_cell("tiny.scan", tiny_root)
    run = harness.run_cell(cell, 5, 4.0, True, "cpu", None, tiny_root)
    assert run.correct and run.stretch and run.trace is not None
    assert run.calls  # the rooflines' watched calls were logged
    m = harness.metrics(run, tiny_root)
    assert "dispatch_ms.scan" in m and "build_s" in m
    # no device activity on the CPU: no device metric is written
    for name in ("probe_roofline", "epoch_bwd_roofline", "epoch_busy_ms",
                 "device_idle.scan"):
        assert name not in m


@pytest.fixture(scope="module")
def built(tiny_root):
    cell = harness.load_cell("tiny.scan", tiny_root)
    cr = harness.CellRun(cell, 1, "cpu")
    cr.setup(harness.Run(cell, 1, 1.0, False, "cpu"))
    return cell, cr.solver


def test_sound_program_on_a_shared_table(tiny_root, built):
    cell, solver = built
    for seed in (3, 4):
        run = harness.run_cell(cell, seed, 2.0, False, "cpu",
                               root=tiny_root,
                               solver=solver)
        assert run.correct, run.compared


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_control_and_faults_are_caught(tiny_root, built, fault):
    cell, solver = built
    run = harness.run_cell(cell, 987654321987, 3.0, False, "cpu",
                           root=tiny_root,
                           fault=control.FAULTS[fault], solver=solver)
    assert not run.correct, (fault, run.compared)


def test_a_cell_of_four_ranks(tiny_root):
    """Four gloo ranks on the CPU through MeshSolver: every solve found or
    exhausted its range, the ranks closed the window together, and each
    rank's judgement, trace and modules came back."""
    cell = harness.load_cell("tiny_x4.scan", tiny_root)
    seed = 2**40 + 3
    run = harness.run_ranks(cell, seed, 3.0, True, "cpu", None, tiny_root)
    assert run.correct, (run.compared, run.checked)
    assert run.checked["solves"] == len(run.solves) + 1 >= 2
    assert run.checked["lanes"] > 0 and run.checked["hits"] > 0
    assert len(run.rank_traces) == 3 and run.forbidden == []
    assert run.window_s >= 3.0
    # a super-epoch counts the steps of all four ranks
    assert run.steps >= len(run.solves) * (2 * 8 + 1) * 4 * 4
    reqs = traffic.Generator(cell.traffic, seed).take(len(run.solves) + 1)
    done = sum(harness.needed_keys(r) for r in reqs[:-1])
    assert done <= run.useful_keys <= done + harness.needed_keys(reqs[-1])


def test_the_exchange_left_out_is_caught(tiny_root):
    cell = harness.load_cell("tiny_x4.scan", tiny_root)
    run = harness.run_ranks(cell, 31, 3.0, False, "cpu", None, tiny_root,
                            fault="no_exchange")
    assert not run.correct, run.compared

