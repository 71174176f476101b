"""Nothing the benchmark runs imports JAX, the JAX package ``repro`` or
``benchmarks/``, and the reference imports nothing of the program: every
import statement under ``cabench/``, by its top-level module name
compared whole (``repro_torch`` begins with ``repro``)."""
from __future__ import annotations

import ast
import pathlib

from cabench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_forbidden_imports():
    found = {str(p.relative_to(harness.ROOT)): sorted(
        top_level_imports(p) & set(harness.FORBIDDEN_MODULES))
        for p in FILES}
    assert not any(found.values()), found
    assert len(FILES) > 10


def test_reference_imports_nothing_of_the_program():
    ref = [p for p in FILES if "reference" in p.parts]
    assert ref
    for p in ref:
        assert top_level_imports(p) <= {"__future__", "typing", "numpy",
                                        "torch"}, p


def test_names_compare_whole():
    assert "repro_torch" not in harness.FORBIDDEN_MODULES
    mods = {"repro_torch.core": 1, "reprox": 1, "repro": 1,
            "repro.core.prng": 1, "jax.numpy": 1}
    import sys
    saved = {m: sys.modules.get(m) for m in mods}
    try:
        sys.modules.update({m: object() for m in mods})
        assert set(harness.forbidden_loaded()) >= {"repro",
                                                   "repro.core.prng",
                                                   "jax.numpy"}
        assert not {"repro_torch.core", "reprox"} & set(
            harness.forbidden_loaded())
    finally:
        for m, v in saved.items():
            if v is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = v
