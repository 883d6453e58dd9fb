"""The port stands alone: no module of `src/repro_torch`, not
`chip_smoke.py` and none of the port's examples (`examples/torch_*.py`)
imports jax, ml_dtypes or anything of the JAX package."""
import ast
from pathlib import Path

import pytest

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"] + \
        sorted((ROOT / "examples").glob("torch_*.py"))


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_found():
    names = {p.name for p in _port_files()}
    assert {"engine.py", "gpp_matmul.py", "paged_attention.py",
            "chip_smoke.py", "train.py", "adamw.py", "manager.py",
            "torch_quickstart.py", "torch_serve_batched.py",
            "torch_train_e2e.py", "torch_gpp_design_space.py"} <= names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
