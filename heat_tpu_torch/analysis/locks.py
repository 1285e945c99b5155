"""Rule family 2 — **lock discipline** (``lock-discipline``).

The serving stack's locks form one documented order — fleet < gateway <
engine < writer < cache < observatory (prof/trace instruments): the
router is outermost in every request path, observatory instruments carry
their own locks and never take the engine lock, so a /metrics scrape can
never deadlock the boundary hot path. That order is machine-checked
twice over:

- **statically, here**: extract every ``with <lock>`` site across
  ``serve/``, ``runtime/`` and ``fleet/``, classify each lock expression
  into its rank (the table below IS ``runtime/debug.LOCK_RANKS``), and
  assert (a) no ``with`` block ever *nests* a lower-or-equal-rank
  acquisition inside a higher one, and (b) while the **engine lock** is
  held, the block performs no file/stream I/O, no device syncs or
  fetches, and no observatory-entry calls — except at explicitly
  allow-marked sanctioned seams (``Engine._emit`` is the one: the engine
  lock IS the serialization point for record JSON lines, and its
  ``prof.note_terminal`` call is the documented engine->observatory
  direction);
- **dynamically** via the opt-in watchdog (``HEAT_TPU_LOCKCHECK=1``,
  ``runtime/debug.make_lock``) that tracks per-thread held-lock stacks at
  run time and raises on the acquisition that inverts the order.

The static half is deliberately conservative: it sees lexical nesting and
a curated map of lock-taking callables, not aliasing. What it cannot see,
the dynamic watchdog does; what the watchdog only sees when a path runs,
this rule sees on every ``check``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..runtime.debug import LOCK_RANKS
from .core import Context, Violation, attr_chain, dotted, register

# one table with the dynamic watchdog's: fleet < gateway < engine < writer
# < cache < observatory < pinned
RANKS = dict(LOCK_RANKS)

# lock-expression classification: (path suffix the file must match,
# attribute-chain suffix of the with-item expression) -> rank name.
# ``self._lock``/``self._cond`` mean different locks in different files —
# the file scopes the meaning.
LOCK_EXPRS: List[Tuple[str, Tuple[str, ...], str]] = [
    ("serve/scheduler.py", ("_lock",), "engine"),
    ("serve/scheduler.py", ("_cond",), "engine"),
    ("serve/gateway.py", ("_drain_lock",), "gateway"),
    ("serve/solvecache.py", ("_lock",), "cache"),
    ("serve/probe.py", ("_lock",), "observatory"),
    ("fleet/router.py", ("_lock",), "fleet"),
    ("fleet/registry.py", ("_lock",), "fleet"),
    ("fleet/resilience.py", ("_lock",), "fleet"),
    ("runtime/async_io.py", ("_exc_lock",), "writer"),
    ("runtime/numerics.py", ("_lock",), "observatory"),
    ("runtime/prof.py", ("_lock",), "observatory"),
    ("runtime/prof.py", ("_COMPILE_LOG_LOCK",), "observatory"),
    ("runtime/trace.py", ("_lock",), "observatory"),
    ("runtime/trace.py", ("_GLOBAL_LOCK",), "observatory"),
    ("backends/pinned.py", ("_lock",), "pinned"),
]

# callables known to ACQUIRE a lock when invoked (attr-chain suffixes).
# Used for nesting edges the lexical scan cannot see.
ACQUIRING_CALLS: Dict[Tuple[str, ...], str] = {
    ("prof", "note_terminal"): "observatory",
    ("prof", "observe_chunk"): "observatory",
    ("prof", "maybe_sample_memory"): "observatory",
    ("prof", "summary"): "observatory",
    ("ledger", "add"): "observatory",
    ("burn", "note"): "observatory",
    ("hist", "observe"): "observatory",
    # engine-lock-taking entry points: calling these while holding an
    # observatory lock is the forbidden reverse direction
    ("submit",): "engine",
    ("poll",): "engine",
    ("queue_depths",): "engine",
    ("begin_drain",): "engine",
}

# I/O and device calls forbidden while the ENGINE lock is held (the
# fetch would extend the lock's critical section across a device fence;
# the I/O would serialize disk latency into admission).
_IO_CALLS = {"open", "print", "master_print", "json_record",
             "write_text", "write_bytes", "savez", "savez_compressed",
             "save", "flush", "mkdir", "rename", "unlink"}
# torch's host syncs beside the boundary-fetch seam: a tensor read to the
# host, a stream/event/device synchronize
_DEVICE_CALLS = {"host_fetch", "item", "cpu", "numpy", "tolist",
                 "synchronize", "asarray"}


def _lock_rank(src_rel: str, expr: ast.AST) -> Optional[str]:
    chain = tuple(attr_chain(expr))
    if not chain:
        return None
    for suffix, names, rank in LOCK_EXPRS:
        if src_rel.endswith(suffix) and chain[-len(names):] == tuple(names):
            return rank
    return None


def _with_lock_items(src, node: ast.With):
    for item in node.items:
        rank = _lock_rank(src.rel, item.context_expr)
        if rank is not None:
            yield rank


def _call_rank(node: ast.Call) -> Optional[str]:
    chain = tuple(attr_chain(node.func))
    if not chain:
        return None
    for suffix, rank in ACQUIRING_CALLS.items():
        if chain[-len(suffix):] == suffix:
            return rank
    return None


@register("lock-discipline",
          "gateway < engine < observatory order; no I/O/device work or "
          "unsanctioned observatory entry under the engine lock")
def check(ctx: Context) -> List[Violation]:
    out: List[Violation] = []
    for src in ctx.sources:
        if not ("serve/" in src.rel or "runtime/" in src.rel
                or "fleet/" in src.rel):
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.With):
                continue
            ranks = list(_with_lock_items(src, node))
            if not ranks:
                continue
            outer_rank = max(RANKS[r] for r in ranks)
            outer_name = max(ranks, key=lambda r: RANKS[r])
            for inner in ast.walk(node):
                if inner is node:
                    continue
                if isinstance(inner, ast.With):
                    for irank in _with_lock_items(src, inner):
                        if RANKS[irank] <= outer_rank:
                            out.append(Violation(
                                "lock-discipline", src.rel, inner.lineno,
                                f"nested `with` acquires {irank!r} lock "
                                f"(rank {RANKS[irank]}) while holding "
                                f"{outer_name!r} lock (rank {outer_rank}) "
                                f"— documented order is gateway < engine "
                                f"< observatory, strictly"))
                if isinstance(inner, ast.Call):
                    crank = _call_rank(inner)
                    if crank is not None and RANKS[crank] <= outer_rank:
                        out.append(Violation(
                            "lock-discipline", src.rel, inner.lineno,
                            f"call `{dotted(inner.func)}` acquires the "
                            f"{crank!r} lock inside a {outer_name!r}-lock "
                            f"block — the reverse of the documented "
                            f"order (deadlock seed)"))
                    name = (inner.func.attr
                            if isinstance(inner.func, ast.Attribute)
                            else inner.func.id
                            if isinstance(inner.func, ast.Name) else "")
                    if outer_name == "engine":
                        if name in _IO_CALLS:
                            out.append(Violation(
                                "lock-discipline", src.rel, inner.lineno,
                                f"I/O call `{dotted(inner.func) or name}` "
                                f"while the engine lock is held — disk/"
                                f"stream latency serializes into "
                                f"admission and the boundary hot path"))
                        elif name in _DEVICE_CALLS:
                            out.append(Violation(
                                "lock-discipline", src.rel, inner.lineno,
                                f"device call `{dotted(inner.func) or name}` "
                                f"while the engine lock is held — a device "
                                f"fence inside the admission critical "
                                f"section stalls every submitting thread"))
                        elif crank == "observatory":
                            out.append(Violation(
                                "lock-discipline", src.rel, inner.lineno,
                                f"observatory entry `{dotted(inner.func)}` "
                                f"while the engine lock is held — only "
                                f"the allow-marked sanctioned seam "
                                f"(Engine._emit) may cross engine->"
                                f"observatory under the lock"))
    return out
