"""Nothing under pfpp_bench/ imports JAX or the JAX package (the top-level name compared
whole), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import sys

from pfpp_bench import harness, manifest

HERE = os.path.join(manifest.ROOT, "pfpp_bench")


def imported(path: str) -> set[str]:
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


def sources(sub: str = ""):
    for root, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_jax_anywhere():
    for path in sources():
        bad = imported(path) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert "puzzlefusion_plusplus_tpu_torch" not in imported(path), path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "puzzlefusion_plusplus_tpu_torch_x", object())
    assert "puzzlefusion_plusplus_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax.numpy"]
