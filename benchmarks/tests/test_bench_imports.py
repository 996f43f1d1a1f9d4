"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: bsgs_tpu_torch begins with bsgs_tpu), and the
reference imports nothing of the program."""

import ast
import sys
import types
from pathlib import Path

import pytest

from benchmarks import harness

BENCH_DIR = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "bsgs_tpu"}
FILES = sorted(BENCH_DIR.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not set(_imports(path)) & JAX_NAMES


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(_imports(path))
    assert not any(n.startswith("bsgs_tpu") for n in names)
    assert names <= {"__future__", "dataclasses", "time"}


def test_watched_functions_are_the_ports():
    for m in harness.load_bench()["per_layer"]:
        for spec in getattr(harness.reader(m["name"]), "WATCH", ()):
            assert spec.split(".")[0] == "bsgs_tpu_torch"


def test_forbidden_modules_seen_at_run_time(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bsgs_tpu_torch_fake",
                        types.ModuleType("bsgs_tpu_torch_fake"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bsgs_tpu.models",
                        types.ModuleType("bsgs_tpu.models"))
    assert harness.forbidden_modules() == ["bsgs_tpu"]
