"""The benchmark's own tests (not collected by the repository's tier-1
run, which takes tests/ alone): python -m pytest benchmarks/tests -q.

Tests marked ``chip`` need a CUDA card; the ``cuda`` fixture skips them
without one (it decides when the test runs, never at import)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip")
    return torch.device("cuda")


TINY = {"w": 256, "htsz": 6, "window": 16, "n_offsets": 8,
        "jobs_per_epoch": 4, "epoch_phases": 1, "pipeline": 2,
        "chunk_c": 2, "lanes_w": 4}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout of its own: a BENCHMARK.json whose cells, configs and
    traffic exist only here, and the benchmark's metric readers."""
    root = tmp_path_factory.mktemp("checkout")
    (root / "benchmarks" / "configs").mkdir(parents=True)
    (root / "benchmarks" / "traffic").mkdir()
    (root / "benchmarks" / "metrics").symlink_to(
        ROOT / "benchmarks" / "metrics")
    for name, geo in (("tiny", TINY),
                      ("tiny_rescan", dict(TINY, positions="rescan",
                                           verify_defer_epochs=64)),
                      ("tiny_x4", TINY)):
        (root / "benchmarks" / "configs" / f"{name}.json").write_text(
            json.dumps({"geometry": geo, "mesh": {}}))
    for bits in (16, 20):  # 2^19 keys: a few super-epochs of 4 ranks
        (root / "benchmarks" / "traffic" / f"t{bits}.json").write_text(
            json.dumps({"bits": bits, "out_of_range_share": 0.25,
                        "prepare": 8}))
    from benchmarks import harness

    bench = harness.load_bench()
    bench["configs"] = [
        {"name": n, "source": "test", "file": f"benchmarks/configs/{n}.json",
         "reduced": [], "why": "test"}
        for n in ("tiny", "tiny_rescan", "tiny_x4")]
    bench["workloads"] = [
        {"name": "tiny.scan", "config": "tiny", "traffic": "t16",
         "chips": 1, "why": "test"},
        {"name": "tiny_rescan.recover", "config": "tiny_rescan",
         "traffic": "t16", "chips": 1, "why": "test"},
        {"name": "tiny_x4.scan", "config": "tiny_x4", "traffic": "t20",
         "chips": 4, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
