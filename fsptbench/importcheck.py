"""What the benchmark may not load.  Names are compared by their top-level
module, the part before the first dot, whole: `fspt_tpu_torch` is the
program under test, `fspt_tpu` the JAX package beside it.

  * the process that prints a result holds none of FORBIDDEN;
  * the harness's sources import none of FORBIDDEN;
  * the plain reference's sources, and the asset generators the program
    and the reference are both given (generators/), import none of
    FORBIDDEN nor the program.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "fspt_tpu")
PROGRAM = "fspt_tpu_torch"
BENCH = os.path.dirname(os.path.abspath(__file__))


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top(m) for m in names if top(m) in FORBIDDEN})


def imports_of(path: str) -> List[str]:
    """Every module a Python source imports, at any depth of its code."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
        elif (isinstance(node, ast.Call) and (
                getattr(node.func, "attr", None)
                or getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.append(str(node.args[0].value))
    return out


def _sources(root: str):
    for base, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if not d.startswith((".", "__"))]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def violations(root: str = BENCH) -> List[str]:
    """'path: module' for every import the rules above refuse."""
    bad = []
    apart = tuple(os.path.join(root, d) + os.sep
                  for d in ("reference", "generators"))
    for path in _sources(root):
        refused = FORBIDDEN + ((PROGRAM,) if path.startswith(apart)
                               else ())
        bad += [f"{os.path.relpath(path, root)}: {m}"
                for m in imports_of(path) if top(m) in refused]
    return bad


def check_sources():
    bad = violations()
    if bad:
        raise SystemExit("fsptbench: forbidden imports: " + "; ".join(bad))


def check_process():
    bad = loaded()
    if bad:
        raise SystemExit("fsptbench: modules of " + ", ".join(bad)
                         + " are loaded in the benchmark's process")
