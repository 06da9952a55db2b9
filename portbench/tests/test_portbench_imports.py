"""Nothing under portbench/ imports JAX or the JAX package, by top-level
module name compared whole (the port's name begins with the JAX
package's); the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "conicip_tpu"}
SOURCES = sorted(PKG.rglob("*.py"))


def imports(path):
    """(top-level name, level) of every import statement in ``path``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or "").split(".")[0], node.level))
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    names = {name for name, level in imports(path) if level == 0}
    assert not names & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((PKG / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_stands_apart_from_the_program(path):
    depth = len(path.relative_to(PKG / "reference").parts)
    for name, level in imports(path):
        assert name != "conicip_tpu_torch"
        # relative imports stay inside reference/
        assert level <= depth


def test_the_comparison_is_whole_names():
    assert "conicip_tpu_torch".split(".")[0] not in FORBIDDEN
