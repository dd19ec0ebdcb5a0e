"""Nothing under ``skybench/`` imports JAX or the JAX package, and the
plain reference imports nothing of the port.  Top-level names are compared
whole: ``repro_torch`` starts with ``repro`` but is not it."""
import ast

import pytest

from skybench import harness

FILES = sorted(harness.BENCH.rglob("*.py"))


def _top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.BENCH)))
def test_no_jax_and_a_plain_reference(path):
    names = _top_names(path)
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names
    if "reference" in path.relative_to(harness.BENCH).parts:
        assert "repro_torch" not in names, names


def test_whole_names_are_compared():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.api",
                                      "reprolike", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jaxlib.xla",
                                      "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "repro"]
