"""The import guard: no module of the benchmark imports JAX or the JAX
package, and the reference imports nothing of the program. Top-level names
are compared whole, so ``pyqmd_tpu_torch`` is not ``pyqmd_tpu``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pyqmd_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "pyqmd_tpu_torch" not in names
    assert names <= {"__future__", "benchmark", "dataclasses", "math", "numpy", "torch", "typing"}


def test_the_guard_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import pyqmd_tpu_torch.sim\nfrom jaxtyping import x\n")
    assert not top_level_imports(f) & FORBIDDEN
    f.write_text("import pyqmd_tpu.core\n")
    assert top_level_imports(f) & FORBIDDEN == {"pyqmd_tpu"}
    f.write_text("from jax import numpy\n")
    assert top_level_imports(f) & FORBIDDEN == {"jax"}
