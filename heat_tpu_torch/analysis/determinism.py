"""Rule family 3 — **kernel-path determinism** (``traced-determinism``).

Everything the engine promises — bit-identical replay, the byte-for-byte
holds of every hand kernel against its plain version, the countdown
mirror's exactness — rests on the code that launches a kernel (and on its
plain version) being a pure function of its inputs. A ``time.time()``
read, an unseeded draw, an environment branch or iteration over an
unordered ``set`` there makes one launch's arguments (or one pass
schedule, one program order) depend on something no caller passed:
results then differ between runs and the byte-identity gates fail
unreproducibly — the worst kind of flake.

Mechanics: the rule finds the **entry points** — in the kernel wrapper
modules (``ops/cuda_stencil.py``, ``ops/cuda_lanes.py``,
``ops/cuda_lab.py``) every function from which a kernel launch
(``_kernel_fn``, the built library's entry) is reachable inside its
module, and every plain version (``*plain*``); in ``ops/stencil.py`` the
torch step (``ftcs_step_*``) — builds a conservative same-repo call
graph (name references inside the entry and its enclosing factory, with
function-scoped ``from ..x import y`` imports resolved across scanned
modules), and bans inside every reachable function:

- wall-clock reads: ``time.*``, ``perf_counter``/``monotonic``,
  ``datetime.*``, ``wall_clock`` (the engine's own clock seam);
- entropy: ``random.*``, ``np.random.*``, ``secrets.*``, ``uuid.*``, and
  ``torch.rand*``/``randn*``/``randint``/``randperm`` without an explicit
  ``generator=``;
- environment reads: ``os.environ`` / ``os.getenv`` (a launch that
  branches on an env var is a fork nobody versioned);
- iteration over an unordered ``set`` (``for x in set(...)``, set
  literals/comprehensions) — ``sorted(...)`` around it is the fix and
  passes automatically.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .core import Context, Violation, attr_chain, register

_CLOCK_BASES = {"time", "datetime"}
_ENTROPY_BASES = {"random", "secrets", "uuid"}
_BANNED_NAMES = {"perf_counter", "monotonic", "wall_clock", "time_ns",
                 "getenv"}
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "bernoulli", "multinomial",
                "normal"}

# the kernel wrapper modules, and the launch seam whose reach marks an entry
KERNEL_MODULES = ("ops/cuda_stencil.py", "ops/cuda_lanes.py",
                  "ops/cuda_lab.py")
LAUNCH_SEAM = "_kernel_fn"
# the torch step: its plain FTCS step functions
STEP_MODULE = "ops/stencil.py"
STEP_PREFIX = "ftcs_step"


def _module_functions(src) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in src.tree.body
            if isinstance(n, ast.FunctionDef)}


def _entry_functions(src) -> List[ast.FunctionDef]:
    """The module-level functions of a kernel module that launch a kernel
    (reach ``_kernel_fn`` through same-module calls) or are a plain
    version; the torch step functions of ``ops/stencil.py``."""
    top = _module_functions(src)
    if src.rel.endswith(STEP_MODULE):
        return [f for n, f in top.items() if n.startswith(STEP_PREFIX)]
    if not any(src.rel.endswith(m) for m in KERNEL_MODULES):
        return []
    refs = {n: {x.id for x in ast.walk(f) if isinstance(x, ast.Name)}
            for n, f in top.items()}
    launches = {n for n, r in refs.items() if LAUNCH_SEAM in r
                and n != LAUNCH_SEAM}
    changed = True
    while changed:
        changed = False
        for n, r in refs.items():
            if n not in launches and n != LAUNCH_SEAM and r & launches:
                launches.add(n)
                changed = True
    return [f for n, f in top.items() if n in launches or "plain" in n]


def entry_points(ctx: Context) -> List[Tuple[str, str]]:
    """``(path, qualname)`` of every entry the rule starts from."""
    return [(s.rel, getattr(f, "_qualname", f.name))
            for s in ctx.sources for f in _entry_functions(s)]


def _function_scope_imports(fn: ast.FunctionDef) -> Dict[str, str]:
    """name -> source module tail, for ``from ..x.y import name`` inside
    the function (the deferred-import idiom this repo uses)."""
    out = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = (
                    node.module.rsplit(".", 1)[-1] + ":" + alias.name)
    return out


def _function_index(ctx: Context):
    """(rel -> {name: function}, module stem -> [sources]) of ``ctx``,
    built once per context."""
    idx = getattr(ctx, "_function_index", None)
    if idx is None:
        by_src: Dict[str, Dict[str, ast.FunctionDef]] = {}
        mod_of: Dict[str, List] = {}
        for s in ctx.sources:
            by_src[s.rel] = {f.name: f for f in s.functions()}
            mod_of.setdefault(s.path.stem, []).append(s)
        idx = ctx._function_index = (by_src, mod_of)
    return idx


def _reachable(ctx: Context, src, entry: ast.FunctionDef
               ) -> List[Tuple[object, ast.FunctionDef]]:
    """(source, function) pairs conservatively reachable from ``entry``:
    same-module functions referenced by name from the entry or its
    enclosing factory chain, plus cross-module functions named in
    function-scoped imports, one hop deep per module."""
    by_src, mod_of = _function_index(ctx)

    seen: Set[Tuple[str, str]] = set()
    work: List[Tuple[object, ast.FunctionDef]] = [(src, entry)]
    # the enclosing factory's locals bind helpers the entry calls through;
    # include the factory itself
    parent = getattr(entry, "_parent", None)
    while parent is not None:
        if isinstance(parent, ast.FunctionDef):
            work.append((src, parent))
        parent = getattr(parent, "_parent", None)
    out = []
    while work:
        s, fn = work.pop()
        key = (s.rel, getattr(fn, "_qualname", fn.name))
        if key in seen:
            continue
        seen.add(key)
        out.append((s, fn))
        imports = _function_scope_imports(fn)
        names = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
        local = by_src[s.rel]
        for name in names:
            if name in local and local[name] is not fn:
                work.append((s, local[name]))
            elif name in imports:
                mod_tail, fname = imports[name].split(":")
                for cand in mod_of.get(mod_tail, []):
                    f2 = by_src[cand.rel].get(fname)
                    if f2 is not None:
                        work.append((cand, f2))
    return out


def _unseeded_draw(node: ast.Call, chain: List[str]) -> bool:
    return (len(chain) >= 2 and chain[0] == "torch"
            and chain[-1] in _TORCH_DRAWS
            and not any(kw.arg == "generator" for kw in node.keywords))


def _check_body(src, fn: ast.FunctionDef, entry_q: str,
                out: List[Violation], seen: Set) -> None:
    q = getattr(fn, "_qualname", fn.name)
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            base = chain[0] if chain else ""
            leaf = chain[-1] if chain else ""
            bad = None
            if base in _CLOCK_BASES or leaf in _BANNED_NAMES & {
                    "perf_counter", "monotonic", "wall_clock", "time_ns"}:
                bad = "wall-clock read"
            elif base in _ENTROPY_BASES or (
                    len(chain) >= 2 and chain[:2] == ["np", "random"]):
                bad = "entropy source"
            elif _unseeded_draw(node, chain):
                bad = "entropy source"
            elif leaf == "getenv" or (len(chain) >= 2
                                      and chain[-2:] == ["os", "environ"]):
                bad = "environment read"
            if bad:
                key = (src.rel, node.lineno, bad)
                if key not in seen:
                    seen.add(key)
                    out.append(Violation(
                        "traced-determinism", src.rel, node.lineno,
                        f"{bad} `{'.'.join(chain)}` in {q}, reachable "
                        f"from kernel entry {entry_q} — a launch and its "
                        f"plain version must be a pure function of their "
                        f"inputs (hoist the value to an argument)"))
        if isinstance(node, ast.Attribute) and node.attr == "environ":
            chain = attr_chain(node)
            if chain[:1] == ["os"]:
                key = (src.rel, node.lineno, "environ")
                if key not in seen:
                    seen.add(key)
                    out.append(Violation(
                        "traced-determinism", src.rel, node.lineno,
                        f"environment read `os.environ` in {q}, "
                        f"reachable from kernel entry {entry_q} — an env "
                        f"branch on the launch path is an unversioned "
                        f"fork"))
        it = None
        if isinstance(node, (ast.For,)):
            it = node.iter
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                               ast.DictComp)):
            it = node.generators[0].iter
        if it is not None and _is_unordered(it):
            key = (src.rel, it.lineno, "set-iter")
            if key not in seen:
                seen.add(key)
                out.append(Violation(
                    "traced-determinism", src.rel, it.lineno,
                    f"iteration over an unordered set in {q}, reachable "
                    f"from kernel entry {entry_q} — the order becomes the "
                    f"launch order or the pass schedule; wrap in "
                    f"sorted()"))


def _is_unordered(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        chain = attr_chain(node.func)
        return bool(chain) and chain[-1] in ("set", "frozenset")
    return False


@register("traced-determinism",
          "no clocks/entropy/env reads/set iteration reachable from a "
          "kernel launch or its plain version")
def check(ctx: Context) -> List[Violation]:
    out: List[Violation] = []
    seen: Set = set()
    for src in ctx.sources:
        for entry in _entry_functions(src):
            entry_q = getattr(entry, "_qualname", entry.name)
            for s, fn in _reachable(ctx, src, entry):
                _check_body(s, fn, f"{src.rel}:{entry_q}", out, seen)
    return out
