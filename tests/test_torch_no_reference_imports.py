"""The port stands alone: no module of ``eegflow_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package (the GPU machine has
neither). Parsed with ``ast``; nothing is imported."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "eegflow_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "eegflow")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_the_port_has_sources_to_check():
    assert len(SOURCES) > 30 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    names = list(_imported(ast.parse(path.read_text(), filename=str(path))))
    assert not [n for n in names if _forbidden(n)], f"{path} imports {names}"


def test_the_guard_sees_every_form():
    src = ("import jax\nimport numpy, jax.numpy as jnp\nfrom eegflow.ode import solve\n"
           "from flax import serialization\nimport eegflow_torch.ode\n"
           "from eegflow_torch import kernels\nfrom . import x\n"
           "def f():\n    import optax\n")
    bad = [n for n in _imported(ast.parse(src)) if _forbidden(n)]
    assert bad == ["jax", "jax.numpy", "eegflow.ode", "flax", "optax"]
