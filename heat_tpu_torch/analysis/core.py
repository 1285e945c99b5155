"""Shared infrastructure for the invariant-guard checker suite.

Everything here is plain ``ast`` walking over the package source (and, for
the CUDA rules, plain text over ``ops/csrc``): the checkers never import
the modules they analyze, so they run in a broken tree, on a host without
a card, in seconds. The pieces:

- :class:`Violation` — one finding, formatted ``path:line: [rule] msg``.
- :class:`Source` — a parsed Python file: AST (with parent/qualname
  annotations), raw lines, and the **allowlist markers** extracted from
  comments.
- :class:`CSource` — a CUDA source or header (``*.cu``, ``*.cuh``): raw
  lines and its ``//`` allow markers.
- :class:`Context` — every source under the scanned root plus per-run
  options; rules receive it whole (the lock and schema rules are
  cross-file by nature).
- :func:`run_checks` — load, dispatch to the registered rule families,
  filter allow-marked findings, return the survivors.

Allowlist marker grammar (the sanctioned-seam escape hatch)::

    some_call()   # heat-tpu: allow[rule-id] why this site is sanctioned
    x = y;        // heat-tpu: allow[rule-id] why (CUDA sources)

The marker covers the physical lines of the statement it sits on (or the
statement directly below, when written on its own line). The reason text
is MANDATORY — a bare marker is itself a violation: every exception to an
invariant carries its justification next to the code, reviewable in the
same diff.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

_MARKER_RE = re.compile(
    r"#\s*heat-tpu:\s*allow\[(?P<rule>[a-z0-9-]+)\]\s*(?P<reason>.*)$")
_C_MARKER_RE = re.compile(
    r"//\s*heat-tpu:\s*allow\[(?P<rule>[a-z0-9-]+)\]\s*(?P<reason>.*)$")
# the CUDA sources the cuda-kernel-safety family reads
C_SUFFIXES = (".cu", ".cuh")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding. ``rule`` is the family id (``RULE_FAMILIES`` key);
    families with several detectors (cuda-kernel-safety) name the finer
    sub-rule at the head of the message."""

    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Source:
    """One parsed Python file with qualname-annotated AST and markers."""

    def __init__(self, root: Path, path: Path):
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(path))
        self._annotate()
        # lineno -> {rule_id: reason}. Scanned over COMMENT tokens, not raw
        # lines: marker grammar quoted inside a string literal (help text,
        # docs) must not become a live — and instantly stale — marker.
        self.allows: Dict[int, Dict[str, str]] = {}
        self.bare_markers: List[int] = []
        for tok in tokenize.generate_tokens(io.StringIO(self.text).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _MARKER_RE.search(tok.string)
            if not m:
                continue
            i = tok.start[0]
            if not m.group("reason").strip():
                self.bare_markers.append(i)
                continue
            self.allows.setdefault(i, {})[m.group("rule")] = (
                m.group("reason").strip())

    def _annotate(self) -> None:
        """Attach ``_qualname`` to every FunctionDef and ``_parent`` to
        every node (the purity scopes are qualname lists; parents let
        detectors look outward from a match)."""

        def visit(node, parents: Tuple[str, ...]):
            for child in ast.iter_child_nodes(node):
                child._parent = node  # type: ignore[attr-defined]
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    q = parents + (child.name,)
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                        child._qualname = ".".join(q)  # type: ignore
                    visit(child, q)
                else:
                    visit(child, parents)

        self.tree._parent = None  # type: ignore[attr-defined]
        visit(self.tree, ())

    def functions(self) -> List[ast.FunctionDef]:
        return [n for n in ast.walk(self.tree)
                if isinstance(n, ast.FunctionDef)]


class CSource:
    """One CUDA source or header: its lines and its ``//`` allow markers
    (the same grammar and the same stale-marker bookkeeping as a Python
    :class:`Source`)."""

    def __init__(self, root: Path, path: Path):
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self.allows: Dict[int, Dict[str, str]] = {}
        self.bare_markers: List[int] = []
        for i, line in enumerate(self.lines, 1):
            m = _C_MARKER_RE.search(line)
            if not m:
                continue
            if not m.group("reason").strip():
                self.bare_markers.append(i)
                continue
            self.allows.setdefault(i, {})[m.group("rule")] = (
                m.group("reason").strip())


class Context:
    """All sources under one root + run options, handed to every rule."""

    def __init__(self, root: Path, schema_registry: Optional[Path] = None,
                 update_schemas: bool = False):
        self.root = Path(root)
        self.schema_registry = (Path(schema_registry) if schema_registry
                                else self.root / "analysis" / "schemas"
                                / "records.json")
        self.update_schemas = update_schemas
        self.sources: List[Source] = []
        self.csources: List[CSource] = []
        self.errors: List[Violation] = []
        for p in sorted(self.root.rglob("*.py")):
            if "__pycache__" in p.parts:
                continue
            try:
                self.sources.append(Source(self.root, p))
            except (SyntaxError, UnicodeDecodeError) as e:
                self.errors.append(Violation(
                    "parse", p.relative_to(self.root).as_posix(),
                    getattr(e, "lineno", 0) or 0,
                    f"cannot parse: {type(e).__name__}: {e}"))
        for p in sorted(q for q in self.root.rglob("*")
                        if q.suffix in C_SUFFIXES and q.is_file()):
            try:
                self.csources.append(CSource(self.root, p))
            except UnicodeDecodeError as e:
                self.errors.append(Violation(
                    "parse", p.relative_to(self.root).as_posix(), 0,
                    f"cannot read: {type(e).__name__}: {e}"))

    def source(self, rel_suffix: str) -> Optional[Source]:
        """The unique source whose relative path ends with ``rel_suffix``
        (e.g. ``serve/scheduler.py``), or None."""
        hits = [s for s in self.sources if s.rel.endswith(rel_suffix)]
        return hits[0] if len(hits) == 1 else None

    def any_source(self, rel: str):
        """The Python or CUDA source at exactly ``rel``, or None."""
        for s in self.sources:
            if s.rel == rel:
                return s
        for s in self.csources:
            if s.rel == rel:
                return s
        return None


# --- small AST helpers shared by the rule modules ---------------------------

def call_name(node: ast.Call) -> str:
    """The called name: ``f`` for ``f(...)``, ``attr`` for ``x.y.attr(...)``."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def attr_chain(node: ast.AST) -> List[str]:
    """``["self", "prof", "note_terminal"]`` for ``self.prof.note_terminal``;
    empty when the expression is not a plain name/attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def dotted(node: ast.AST) -> str:
    return ".".join(attr_chain(node))


def enclosing_function(node: ast.AST) -> Optional[ast.FunctionDef]:
    cur = getattr(node, "_parent", None)
    while cur is not None:
        if isinstance(cur, ast.FunctionDef):
            return cur
        cur = getattr(cur, "_parent", None)
    return None


# --- registry ----------------------------------------------------------------

# family id -> check(ctx) -> List[Violation]; populated by register() calls
# at the bottom of each rule module (importing the package loads all).
RULE_FAMILIES: Dict[str, Callable[[Context], List[Violation]]] = {}
RULE_DOCS: Dict[str, str] = {}


def register(rule_id: str, doc: str):
    def deco(fn):
        RULE_FAMILIES[rule_id] = fn
        RULE_DOCS[rule_id] = doc
        return fn
    return deco


def run_checks(root, rules: Optional[List[str]] = None,
               schema_registry=None, update_schemas: bool = False,
               strict_allows: bool = False
               ) -> Tuple[List[Violation], dict]:
    """Run the requested rule families (default: all) over ``root``.

    Returns ``(violations, stats)``. Allow-marked findings are dropped
    here (every rule reports raw and this one chokepoint applies the
    markers, so marker semantics cannot drift per rule); a marker with
    no reason text is converted into its own violation.

    Because filtering happens at this chokepoint, we also know which
    markers actually suppressed something. The rest are **stale**: the
    rule id is unknown (typo, or the rule was removed), or the rule ran
    and no longer fires at that site (the code was fixed but the marker
    stayed, silently pre-authorizing a future regression). Stale markers
    are reported in ``stats["stale_allows"]``; with ``strict_allows``
    they become ``stale-allow`` violations. Markers for known rules that
    were not selected this run are left alone — we cannot tell.
    """
    from . import (cuda_rules, determinism, locks, purity,  # noqa: F401
                   races, schema)
    # (imports register the families; the side effect IS the point)

    ctx = Context(root, schema_registry=schema_registry,
                  update_schemas=update_schemas)
    selected = list(RULE_FAMILIES) if not rules else list(rules)
    unknown = [r for r in selected if r not in RULE_FAMILIES]
    if unknown:
        raise ValueError(f"unknown rule families {unknown}; "
                         f"known: {sorted(RULE_FAMILIES)}")
    out: List[Violation] = list(ctx.errors)
    every = list(ctx.sources) + list(ctx.csources)
    for src in every:
        for ln in src.bare_markers:
            out.append(Violation(
                "allow-marker", src.rel, ln,
                "allow marker without a reason — every sanctioned "
                "exception must carry its justification"))
    per_rule: Dict[str, int] = {}
    consumed: set = set()  # (rel, marker_line, rule) that suppressed a hit
    for rid in selected:
        found = RULE_FAMILIES[rid](ctx)
        kept = []
        for v in found:
            src = ctx.any_source(v.path)
            marker = (None if src is None
                      else _allow_line(src, v.rule, v.line))
            if marker is not None:
                consumed.add((v.path, marker, v.rule))
                continue
            kept.append(v)
        per_rule[rid] = len(kept)
        out.extend(kept)
    stale: List[dict] = []
    for src in every:
        for ln, rules_here in sorted(src.allows.items()):
            for rule, reason in sorted(rules_here.items()):
                if rule not in RULE_FAMILIES:
                    why = (f"unknown rule id {rule!r} — typo, or the "
                           "rule was removed")
                elif rule not in selected:
                    continue  # rule didn't run: can't judge the marker
                elif (src.rel, ln, rule) not in consumed:
                    why = ("rule no longer fires here — the marker "
                           "silently pre-authorizes a regression")
                else:
                    continue
                stale.append({"path": src.rel, "line": ln, "rule": rule,
                              "reason": reason, "why": why})
    if strict_allows:
        out.extend(Violation("stale-allow", s["path"], s["line"],
                             f"stale allow[{s['rule']}] marker: {s['why']}"
                             f" (reason given: {s['reason']!r})")
                   for s in stale)
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    stats = {"files": len(ctx.sources), "cuda_files": len(ctx.csources),
             "rules": selected, "violations": len(out),
             "per_rule": per_rule,
             "allow_markers": sum(len(d) for s in every
                                  for d in s.allows.values()),
             "stale_allows": stale}
    return out, stats


def _allow_line(src, rule: str, line: int) -> Optional[int]:
    """The line of the allow marker covering ``line`` for ``rule``, or
    None. The marker may sit on the flagged line, within the two lines
    above (the tail of a comment block annotating a short statement
    pair), or — for a call spanning lines — on a trailing continuation
    line."""
    for ln in range(line - 2, line + 3):
        if rule in src.allows.get(ln, {}):
            return ln
    return None
