"""Nothing under perfbench/ imports JAX or the JAX package, and the plain
references import nothing of the program. Top-level module names are
compared whole: ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NO_JAX = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = {"repro_torch"}


def _imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (relative
    imports name the package they stay in)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0] if node.module and
                      not node.level else "perfbench")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not (_imported(path) & NO_JAX)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not (_imported(path) & (NO_JAX | PROGRAM))
    assert _imported(path) <= {"__future__", "math", "torch", "perfbench"}


def test_whole_names_compared(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.models\n"
                     "from repro_torch import kernels\n")
    assert _imported(probe) == {"repro_torch"}
    assert not (_imported(probe) & NO_JAX)
    probe.write_text("import repro.models\n")
    assert _imported(probe) & NO_JAX
