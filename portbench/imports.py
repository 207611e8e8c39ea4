"""The import check: nothing the benchmark runs may load JAX or the JAX
package, and the references may load nothing of the program.

Names are compared by their top-level part (before the first dot),
whole: ``raft_tpu_torch`` is not ``raft_tpu``.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List, Set

FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")
PROGRAM = "raft_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & set(FORBIDDEN))


def source_imports(path: Path) -> Set[str]:
    """Top-level names a source file imports (absolute imports)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            out.add(top_level(node.module))
    return out
