"""Rule family 5 — **record-schema registry** (``record-schema``).

Every structured JSON line this stack emits funnels through ONE emitter
(``runtime/logging.json_record``), and consumers — the usage CLI, the
labs, the flight-recorder postmortems, any operator's ``grep`` — parse
those records by key. The record schema "never flickers" (trace ids
minted even with tracing off, usage stamps present even with the
observatory off), and the port emits the reference's records key for key.
This rule makes that mechanical:

1. **Extraction**: walk every ``json_record(...)`` call site in the
   package. The event name must be a string literal (a dynamic event
   name is unauditable and is itself a violation). Explicit keyword
   arguments contribute their names; a ``**star`` argument is resolved
   statically — a local dict-literal binding, a registered producer
   function whose ``return {...}`` literals define the keys
   (``BurnMonitor.note``, ``MemWatermark.note``), or the scheduler's
   ``serve_request`` record shape (the ``submit()`` literal plus every
   ``rec["key"] = ...`` store in ``serve/scheduler.py``, minus the
   ``_``-internal keys and the field payload ``T`` that
   ``Engine._public`` strips). A star argument the resolver cannot
   attribute is a violation: every emission site must be statically
   accountable or explicitly registered in ``STAR_RESOLVERS`` below.
2. **The registry**: the union of keys per event is compared against the
   committed ``heat_tpu_torch/analysis/schemas/records.json``. Any drift —
   new event, dropped event, added key, removed key — fails
   ``heat-tpu-torch check`` with the exact delta. Intentional changes are a
   two-step: ``heat-tpu-torch check --update-schemas`` rewrites the registry,
   and the registry diff rides the same PR as the code change — schema
   changes get reviewed, never slipped.
"""

from __future__ import annotations

import ast
import json
from typing import Dict, List, Optional, Set, Tuple

from .core import (Context, Violation, attr_chain, enclosing_function,
                   register)

# (file suffix, enclosing function name, star-arg name) -> producer spec:
# ("returns", file suffix, function qualname) = keys of that function's
# dict-literal returns; ("serve-record",) = the scheduler record shape.
STAR_RESOLVERS: Dict[Tuple[str, str, str], tuple] = {
    ("serve/scheduler.py", "_emit", "snap"): ("serve-record",),
    ("serve/scheduler.py", "_emit", "alert"):
        ("returns", "runtime/prof.py", "BurnMonitor.note"),
    ("serve/scheduler.py", "_mem_warn", "warn"):
        ("returns", "runtime/prof.py", "MemWatermark.note"),
}


def _const_keys(d: ast.Dict) -> Optional[Set[str]]:
    keys = set()
    for k in d.keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys.add(k.value)
        else:
            return None   # **spread or computed key: not a literal shape
    return keys


def _return_dict_keys(ctx: Context, file_suffix: str, qualname: str
                      ) -> Optional[Set[str]]:
    src = ctx.source(file_suffix)
    if src is None:
        return None
    for fn in src.functions():
        if getattr(fn, "_qualname", fn.name) == qualname:
            keys: Set[str] = set()
            found = False
            for node in ast.walk(fn):
                if isinstance(node, ast.Return) and isinstance(
                        node.value, ast.Dict):
                    k = _const_keys(node.value)
                    if k is not None:
                        keys |= k
                        found = True
            return keys if found else None
    return None


def serve_record_keys(ctx: Context) -> Optional[Set[str]]:
    """The ``serve_request`` record shape, derived from scheduler.py the
    way the engine actually builds it: the ``submit()`` dict literal plus
    every constant-key ``rec[...] = `` store anywhere in the module,
    minus ``_``-prefixed internals and the field payload ``T`` (exactly
    what ``Engine._public`` strips before emission)."""
    src = ctx.source("serve/scheduler.py")
    if src is None:
        return None
    keys: Set[str] = set()
    for node in ast.walk(src.tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1):
            t = node.targets[0]
            if (isinstance(t, ast.Name) and t.id == "rec"
                    and isinstance(node.value, ast.Dict)):
                k = _const_keys(node.value)
                if k:
                    keys |= k
            if (isinstance(t, ast.Subscript) and isinstance(
                    t.value, ast.Name) and t.value.id == "rec"
                    and isinstance(t.slice, ast.Constant)
                    and isinstance(t.slice.value, str)):
                keys.add(t.slice.value)
    if not keys:
        return None
    return {k for k in keys if not k.startswith("_") and k != "T"}


def _local_dict_keys(fn: ast.FunctionDef, name: str) -> Optional[Set[str]]:
    """Keys of a star-arg bound from a dict literal inside the enclosing
    function, plus any ``name["k"] = ...`` stores there."""
    keys: Optional[Set[str]] = None
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1):
            t = node.targets[0]
            if (isinstance(t, ast.Name) and t.id == name
                    and isinstance(node.value, ast.Dict)):
                k = _const_keys(node.value)
                if k is not None:
                    keys = (keys or set()) | k
            if (isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name) and t.value.id == name
                    and isinstance(t.slice, ast.Constant)
                    and isinstance(t.slice.value, str)):
                keys = (keys or set()) | {t.slice.value}
    return keys


def extract_schemas(ctx: Context) -> Tuple[Dict[str, dict],
                                           List[Violation]]:
    """(event -> {"keys": sorted, "sites": n}, violations)."""
    events: Dict[str, Set[str]] = {}
    sites: Dict[str, int] = {}
    out: List[Violation] = []
    for src in ctx.sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not chain or chain[-1] != "json_record":
                continue
            fn = enclosing_function(node)
            if fn is not None and fn.name == "json_record":
                continue   # the emitter's own definition/recursion
            if not node.args or not (
                    isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.append(Violation(
                    "record-schema", src.rel, node.lineno,
                    "json_record with a non-literal event name — every "
                    "record stream must be statically enumerable"))
                continue
            event = node.args[0].value
            keys: Set[str] = set()
            ok = True
            for kw in node.keywords:
                if kw.arg is not None:
                    keys.add(kw.arg)
                    continue
                star = kw.value
                sname = star.id if isinstance(star, ast.Name) else None
                resolved = None
                if sname and fn is not None:
                    resolved = _local_dict_keys(fn, sname)
                    if resolved is None:
                        for (sfx, fname, aname), spec in \
                                STAR_RESOLVERS.items():
                            if (src.rel.endswith(sfx)
                                    and fn.name == fname
                                    and sname == aname):
                                if spec[0] == "serve-record":
                                    resolved = serve_record_keys(ctx)
                                elif spec[0] == "returns":
                                    resolved = _return_dict_keys(
                                        ctx, spec[1], spec[2])
                                break
                if resolved is None:
                    ok = False
                    out.append(Violation(
                        "record-schema", src.rel, node.lineno,
                        f"unresolvable **{sname or '<expr>'} in "
                        f"json_record({event!r}, ...) — bind it from a "
                        f"dict literal, or register the producer in "
                        f"analysis/schema.py STAR_RESOLVERS so the "
                        f"registry stays exact"))
                else:
                    keys |= resolved
            if not ok:
                continue
            events[event] = events.get(event, set()) | keys
            sites[event] = sites.get(event, 0) + 1
    table = {ev: {"keys": sorted(ks), "sites": sites[ev]}
             for ev, ks in sorted(events.items())}
    return table, out


def load_registry(path) -> Optional[dict]:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return None


def write_registry(path, table: Dict[str, dict]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"version": 1,
               "comment": "committed record-schema registry — regenerate "
                          "with `heat-tpu-torch check --update-schemas` "
                          "and review the diff (a schema change is "
                          "reviewed with the code)",
               "events": table}
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")


@register("record-schema",
          "every json_record site statically resolved; key sets gated "
          "against the committed schemas/records.json")
def check(ctx: Context) -> List[Violation]:
    table, out = extract_schemas(ctx)
    reg_path = ctx.schema_registry
    if ctx.update_schemas:
        write_registry(reg_path, table)
        return out
    committed = load_registry(reg_path)
    if committed is None:
        out.append(Violation(
            "record-schema",
            reg_path.name if not reg_path.exists() else str(reg_path),
            0,
            f"schema registry {reg_path} missing/unreadable — generate "
            f"it with `heat-tpu-torch check --update-schemas` and commit it"))
        return out
    old = committed.get("events", {})
    for ev in sorted(set(old) | set(table)):
        if ev not in table:
            out.append(Violation(
                "record-schema", "analysis/schemas/records.json", 0,
                f"event {ev!r} is in the committed registry but no "
                f"longer emitted — if intentional, run `heat-tpu-torch check "
                f"--update-schemas` and commit the registry diff"))
        elif ev not in old:
            out.append(Violation(
                "record-schema", "analysis/schemas/records.json", 0,
                f"new record event {ev!r} (keys "
                f"{table[ev]['keys']}) not in the committed registry — "
                f"run `heat-tpu-torch check --update-schemas` and commit the "
                f"diff so the schema change is reviewed"))
        else:
            added = sorted(set(table[ev]["keys"]) - set(old[ev]["keys"]))
            removed = sorted(set(old[ev]["keys"]) - set(table[ev]["keys"]))
            if added or removed:
                out.append(Violation(
                    "record-schema", "analysis/schemas/records.json", 0,
                    f"key-set drift for event {ev!r}: "
                    + (f"added {added} " if added else "")
                    + (f"removed {removed} " if removed else "")
                    + "— consumers parse these records by key; if "
                      "intentional, `heat-tpu-torch check --update-schemas` "
                      "and commit the registry diff"))
    return out
