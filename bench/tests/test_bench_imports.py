"""Nothing under bench/ imports JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is the port, ``repro`` the JAX package),
and the plain references import nothing of the program."""
import ast

import pytest

from bench.tests.helpers import ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted((ROOT / "bench").rglob("*.py"))


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & BANNED


@pytest.mark.parametrize("path", sorted((ROOT / "bench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "repro_torch" not in imported_tops(path)
    assert imported_tops(path) <= {"__future__", "math", "typing", "torch", "bench"}


def test_banned_modules_compares_whole_names():
    from bench.harness import banned_modules

    assert banned_modules(["repro_torch", "repro_torch.models", "torch", "reprox"]) == []
    assert banned_modules(["repro.models.mlp", "jax.numpy", "flax"]) == ["flax", "jax", "repro"]
