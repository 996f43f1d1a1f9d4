"""BENCHMARK.json against the benchmark's contract, and run.py's refusals."""

import json
import re
import subprocess
import sys

import pytest

from benchmarks import harness

ROOT = harness.ROOT
BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert cmd[1] == "benchmarks/run.py" and (ROOT / cmd[1]).exists()
    assert cmd[1].startswith(BENCH["paths"][0] + "/")


def test_run_seconds_fit_the_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmarks/") and c["file"] not in files
        files.add(c["file"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert {"w", "htsz", "n_offsets", "jobs_per_epoch",
                "epoch_phases"} <= set(conf["geometry"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert c["reduced"] == conf["reduced"]


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (ROOT / "benchmarks" / "traffic"
                / f"{w['traffic']}.json").exists()


def test_metrics():
    e2e, layer = BENCH["end_to_end"], BENCH["per_layer"]
    cells = {w["name"] for w in BENCH["workloads"]}
    names = [m["name"] for m in e2e + layer]
    assert len(names) == len(set(names))
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for m in e2e:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in layer:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["moves"] in {x["name"] for x in e2e}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "benchmarks" / "metrics"
                / f"{m['name']}.py").exists()
        assert callable(harness.reader(m["name"]).read)
    layers = {}
    for m in layer:  # one layer, one name
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(name):
    cell = harness.load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    moved = {m["moves"] for m in cell.per_layer}
    assert moved <= e2e


def test_run_py_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 2 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_run_py_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    own files, run.py exits non-zero and prints no result."""
    import shutil

    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "benchmarks", tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout == ""
