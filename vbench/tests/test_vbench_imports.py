"""Nothing under vbench/ imports jax, jaxlib, flax or the JAX package
(compared by whole top-level name: the port's name begins with the JAX
package's), and the references import nothing of the port either."""

import ast
from pathlib import Path

import pytest

VBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sqlite_vector_tpu"}
PORT = "sqlite_vector_tpu_torch"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(VBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(VBENCH)))
def test_no_jax_by_whole_top_level_name(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((VBENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert PORT not in top_level_imports(path)
    assert not any(n.startswith("vbench") for n in top_level_imports(path))


def test_the_check_compares_whole_names():
    import run

    assert PORT.split(".")[0] not in run.FORBIDDEN
    assert PORT.startswith("sqlite_vector_tpu")  # why a prefix match would be wrong
