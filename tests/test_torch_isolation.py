"""Import guard: the port (gtax_torch/) and chip_smoke.py import neither JAX
nor anything of the gtax package (they run where JAX is not installed)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "gtax_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "gtax")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_gtax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imports(tree) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_catches_forbidden_forms():
    src = ("import jax\nfrom gtax.core import rope\nimport gtax.models\n"
           "from gtax_torch.core import rope as r\nimport jax.numpy as jnp\n")
    names = [n for _, n in _imports(ast.parse(src)) if _forbidden(n)]
    assert names == ["jax", "gtax.core", "gtax.models", "jax.numpy"]
