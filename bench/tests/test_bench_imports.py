"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the plain reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _tops(path: Path) -> "set[str]":
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not (_tops(path) & FORBIDDEN), path


def _from_bench(path: Path) -> "set[str]":
    tree = ast.parse(path.read_text())
    return {n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.module
            and n.module.split(".")[0] == "bench"}


def test_the_reference_stands_alone():
    """torch and the standard library, and from the benchmark only the
    reference itself."""
    for path in (BENCH / "reference").rglob("*.py"):
        assert _tops(path) <= {"__future__", "math", "torch", "bench"}, path
        assert all(m.startswith("bench.reference")
                   for m in _from_bench(path)), path


def test_the_import_check_sees_the_port_apart():
    assert _tops(BENCH / "lib" / "trace.py").isdisjoint(FORBIDDEN)
    assert "repro_torch".split(".")[0] not in FORBIDDEN
