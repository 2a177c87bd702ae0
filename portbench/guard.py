"""What the benchmark may not load: JAX and the JAX package. Names are
compared whole, by the part before the first dot, so the port
(`rpt_tpu_torch`) is allowed and the JAX package (`rpt_tpu`) is not."""

from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "rpt_tpu")
PORT = "rpt_tpu_torch"
_REFERENCE = ("reference", "spec.py")


def loaded_forbidden() -> list:
    """Modules of `sys.modules` whose top-level name is forbidden."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def imports_of(path: str) -> set:
    """Top-level names of every module a Python source imports."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def reference_imports(package: str) -> list:
    """Forbidden or port modules that the plain reference's sources import:
    it may use neither JAX, nor the JAX package, nor the port."""
    paths = []
    for part in _REFERENCE:
        p = os.path.join(package, part)
        paths += [os.path.join(p, f) for f in sorted(os.listdir(p)) if f.endswith(".py")] if os.path.isdir(p) else [p]
    bad = set(FORBIDDEN) | {PORT}
    return sorted(f"{os.path.relpath(p, package)}: {n}" for p in paths for n in imports_of(p) if n in bad)
