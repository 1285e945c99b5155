"""Dead-code report: public package functions unreachable from any entry
point.

Generalizes the cross-module reachability idea of
``determinism._reachable`` from trace entries to the whole program: the
roots are every function defined OUTSIDE the package (tests, benchmark
drivers, repo-root scripts), every name referenced at package module
level, every decorated definition (decorators are registration), and
every dunder; the closure follows bare-name and attribute-leaf
references conservatively (any reference to the name reaches every
package function so named, and string constants count — ``getattr``/
registry tables resolve names from strings). What survives outside the
closure is a public function nothing can call — ``heat-tpu-torch
check --dead-code`` lists it, informationally: the closure is conservative in
one direction only (it over-approximates liveness, so a listed function
really is unreachable; the interesting errors are omissions, not false
alarms).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set

from .core import Context

_IDENT_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _referenced_names(tree: ast.AST) -> Set[str]:
    """Every name a subtree can resolve a function through: bare names,
    attribute leaves (method/namespace calls), and identifier-shaped
    string constants (getattr, registry keys, CLI dispatch tables)."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif (isinstance(node, ast.Constant)
              and isinstance(node.value, str)
              and _IDENT_RE.match(node.value)):
            names.add(node.value)
    return names


def _is_nested(fn: ast.FunctionDef) -> bool:
    cur = getattr(fn, "_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return True
        cur = getattr(cur, "_parent", None)
    return False


def _overrides_base(fn: ast.FunctionDef) -> bool:
    """Methods of classes WITH base classes may be framework hooks the
    base dispatches by name (BaseHTTPRequestHandler's do_GET/do_POST,
    log_message) — no static reference exists, so exempt them rather
    than cry wolf."""
    cur = getattr(fn, "_parent", None)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return bool(cur.bases or cur.keywords)
        cur = getattr(cur, "_parent", None)
    return False


def _module_level_names(tree: ast.Module) -> Set[str]:
    """Names referenced outside any function body (module execution,
    class-level statements, decorators, defaults) — everything that runs
    or binds at import time."""

    names: Set[str] = set()

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # the def itself binds at import time: its decorators,
                # defaults, and annotations evaluate — but not its body
                for dec in child.decorator_list:
                    names.update(_referenced_names(dec))
                for d in (child.args.defaults
                          + [x for x in child.args.kw_defaults if x]):
                    names.update(_referenced_names(d))
                continue
            if isinstance(child, ast.Name):
                names.add(child.id)
            elif isinstance(child, ast.Attribute):
                names.add(child.attr)
            elif (isinstance(child, ast.Constant)
                  and isinstance(child.value, str)
                  and _IDENT_RE.match(child.value)):
                names.add(child.value)
            visit(child)

    visit(tree)
    return names


def _external_sources(root: Path) -> List[Path]:
    """Entry-point files outside the package: the repo's tests/ and
    benchmarks/ trees plus top-level scripts, when the package sits in a
    repo checkout (site-packages installs simply contribute none)."""
    repo = root.parent
    out: List[Path] = []
    for sub in ("tests", "benchmarks"):
        d = repo / sub
        if d.is_dir():
            out.extend(sorted(d.rglob("*.py")))
    out.extend(sorted(p for p in repo.glob("*.py")))
    return [p for p in out if "__pycache__" not in p.parts]


def dead_code_report(root, extra_sources: Optional[List[Path]] = None
                     ) -> List[dict]:
    """Public, non-nested package functions outside the reachability
    closure, as ``{"path", "line", "qualname"}`` rows sorted by
    location. ``extra_sources`` overrides entry-point discovery (fixture
    trees in tests)."""
    root = Path(root)
    ctx = Context(root)

    # candidate table: name -> function records
    by_name: Dict[str, List[dict]] = {}
    funcs: List[dict] = []
    for src in ctx.sources:
        for fn in src.functions():
            if _is_nested(fn):
                continue
            rec = {"src": src, "fn": fn, "name": fn.name,
                   "qualname": getattr(fn, "_qualname", fn.name),
                   "seeded": (bool(fn.decorator_list)
                              or _overrides_base(fn))}
            funcs.append(rec)
            by_name.setdefault(fn.name, []).append(rec)

    # roots: names live by construction
    seeds: Set[str] = set()
    for src in ctx.sources:
        seeds |= _module_level_names(src.tree)
    ext = (_external_sources(root) if extra_sources is None
           else list(extra_sources))
    for p in ext:
        try:
            seeds |= _referenced_names(ast.parse(p.read_text()))
        except (OSError, SyntaxError, UnicodeDecodeError):
            continue

    reachable: Set[int] = set()
    work: List[dict] = []
    for rec in funcs:
        if (rec["seeded"] or rec["name"].startswith("__")
                or rec["name"] in seeds):
            reachable.add(id(rec["fn"]))
            work.append(rec)
    while work:
        rec = work.pop()
        for name in _referenced_names(rec["fn"]):
            for cand in by_name.get(name, ()):
                if id(cand["fn"]) not in reachable:
                    reachable.add(id(cand["fn"]))
                    work.append(cand)

    dead = [{"path": rec["src"].rel, "line": rec["fn"].lineno,
             "qualname": rec["qualname"]}
            for rec in funcs
            if id(rec["fn"]) not in reachable
            and not rec["name"].startswith("_")]
    dead.sort(key=lambda d: (d["path"], d["line"]))
    return dead
