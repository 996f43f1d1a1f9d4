"""On the card: the tiny cells through the CUDA kernels, traced, and the
control and the faults caught there too. Skips without a card; on the
chip: python3 -m pytest benchmarks/tests -q -m chip."""

import pytest

from benchmarks import control, harness

pytestmark = pytest.mark.chip


@pytest.fixture
def streamed_small(monkeypatch):
    from bsgs_tpu_torch.models import table

    monkeypatch.setattr(table, "STREAMED_W", 128)


@pytest.mark.parametrize("name", ["tiny.scan", "tiny_rescan.recover"])
def test_tiny_cells_on_the_card(cuda, tiny_root, streamed_small, name):
    cell = harness.load_cell(name, tiny_root)
    run = harness.run_cell(cell, 2**31 + 11, 3.0, True, "cuda", None,
                           tiny_root)
    assert run.correct, (run.compared, run.checked)
    out = harness.result(run, "card", tiny_root)
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
    for m in ("epoch_busy_ms", "probe_roofline", "epoch_bwd_roofline"):
        assert m in out["metrics"], out["metrics"]
    assert 0 < out["metrics"]["probe_roofline"]["value"] <= 105


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_faults_on_the_card(cuda, tiny_root, fault):
    cell = harness.load_cell("tiny.scan", tiny_root)
    run = harness.run_cell(cell, 987654321987, 3.0, False, "cuda",
                           root=tiny_root, fault=control.FAULTS[fault])
    assert not run.correct, (fault, run.compared)


def test_four_ranks_on_the_cards(cuda, tiny_root):
    """The rank path on NCCL: four cards, the tiny cell traced, then the
    exchange left out. Skips on a host with fewer cards."""
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    cell = harness.load_cell("tiny_x4.scan", tiny_root)
    run = harness.run_ranks(cell, 2**32 + 5, 3.0, True, "cuda", None,
                            tiny_root)
    assert run.correct, (run.compared, run.checked)
    out = harness.result(run, "card", tiny_root)
    assert out["device"]["count"] == 4 and out["device"]["busy_s"] > 0
    assert len(run.rank_traces) == 3 and run.forbidden == []
    bad = harness.run_ranks(cell, 77, 3.0, False, "cuda", None, tiny_root,
                            fault="no_exchange")
    assert not bad.correct, bad.compared

