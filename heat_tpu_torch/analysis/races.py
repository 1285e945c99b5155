"""Rule family 6 — **cross-thread guard-map analysis** (``races``).

``lock-discipline`` proves locks are acquired in rank order; nothing in
it proves shared state is actually *protected* — an attribute written
with no lock at all passes every order check. This rule is the static
half of the classic lockset pair (Eraser, Savage et al. SOSP '97;
ThreadSanitizer, Serebryany & Iskhodzhanov WBIA '09): infer, per shared
field, the set of locks that guard every write, and fail the build when a
field written from two threads has an empty guard intersection. The
dynamic half (``HEAT_TPU_RACECHECK=1``, ``runtime/debug.py``) checks the
same property at run time from the lock-order watchdog's per-thread held
stacks.

Mechanics, in four passes over the package AST:

1. **Thread roster.** Thread-shared *classes* are seeded from spawn
   sites (``threading.Thread(target=self._m, name="...")`` — the method
   is an entry on that named thread), from ``BaseHTTPRequestHandler``
   subclasses (every ``do_*`` method is an ``http-handler`` entry), and
   from lock ownership (a class that builds a ``make_lock``/
   ``threading.Lock`` field declared itself shared). Classes whose
   constructor takes a monitored class as an annotated parameter
   (``outer: "Engine"`` — the runner pattern) join the set too. Public
   methods of externally-constructed classes are entries on the
   ``client`` thread; ``DRIVER_ENTRIES`` pins the offline drive path
   (``Engine.run``) to the same logical thread as the online scheduler
   loop — the API contract makes the two drive modes mutually
   exclusive. ``POOL_ENTRIES`` pins the engine checkpoint's lane-field
   jobs to the pool of writer threads that runs one generation's fields
   concurrently (``_run_concurrently``); a pool label counts as two
   writing threads, since its threads run at once.
2. **Thread propagation.** Entry labels flow along a conservative
   call-graph closure — ``self.m()``, calls through constructor-typed
   fields and locals (``self.prof = Observatory(...)``;
   ``writer = SnapshotWriter(...)``), nested functions (a local
   function passed to ``writer.submit`` runs on the writer thread —
   ``SINK_CALLS``), with ``determinism._reachable`` reused for
   module-level spawn targets. Internal classes (every constructor
   site inside monitored methods) inherit their constructors' threads.
3. **Access classification.** Every ``self.f`` (and typed
   ``self.outer.f``) access in a monitored class is recorded as
   read/write with its guard set: lexically enclosing ``with <lock>:``
   items, plus locks every caller provably holds at every call site of
   a ``_``-private helper (the helper-held fixpoint). ``Condition``
   fields alias to the lock they wrap; ``Event``/``Queue``/
   ``Semaphore`` fields are self-synchronizing and their method calls
   are not accesses. ``__init__`` writes are construction
   (happens-before publication) and exempt.
4. **The guard map.** Per field, the write-guard intersection decides
   the committed classification in ``analysis/schemas/guards.json``:
   ``lock:<name>`` (a common guard), ``thread-confined(<t>)`` /
   ``single-writer(<t>)`` (one writing thread), ``unguarded-readonly``
   (no post-init writes), or ``allow(<reason>)`` for violating fields
   sanctioned with ``# heat-tpu: allow[races] why``. A field written
   from >= 2 threads with an empty intersection and no marker is a
   violation; the map itself is drift-gated exactly like the record
   registry — ``check --update-schemas`` rewrites it and the diff rides
   the same change as the code.
"""

from __future__ import annotations

import ast
import json
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import (Context, Source, Violation, _allow_line, attr_chain,
                   register)
from .determinism import _reachable

# Offline drive entry points that share the online scheduler thread's
# logical identity (see module docstring, pass 1).
DRIVER_THREAD = "driver"
DRIVER_ENTRIES: Dict[Tuple[str, str], str] = {
    ("Engine", "run"): DRIVER_THREAD,
}

# (receiver name, call attr) -> thread: a function object passed as an
# argument runs on that thread (the SnapshotWriter job-submission seam).
SINK_CALLS: Dict[Tuple[str, str], str] = {
    ("writer", "submit"): "heat-snapshot-writer",
}

# (class, unit) -> thread-pool label: nested jobs that a pool runs several
# at once (one engine-checkpoint generation's lane fields, written by up to
# eight threads)
POOL_THREAD = "heat-snapshot-writer-ckpt"
POOL_ENTRIES: Dict[Tuple[str, str], str] = {
    ("Engine", "_field_job.job"): POOL_THREAD,
}
POOL_THREADS = frozenset(POOL_ENTRIES.values())

CLIENT = "client"
INIT = "init"

_LOCK_FACTORIES = {"make_lock", "Lock", "RLock"}
_SELFSYNC_FACTORIES = {"Event", "Queue", "SimpleQueue", "Semaphore",
                       "BoundedSemaphore", "Barrier"}
_MUTATORS = {"append", "appendleft", "add", "extend", "insert", "remove",
             "discard", "pop", "popleft", "popitem", "clear", "update",
             "setdefault", "sort", "reverse", "subtract"}
_ANNOT_NAME_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


class _ClassInfo:
    """Everything the rule knows about one monitored class."""

    def __init__(self, src: Source, node: ast.ClassDef,
                 bases: Tuple[ast.ClassDef, ...] = ()):
        self.src = src
        self.node = node
        self.name = node.name
        # the class and its package base classes, most derived first: a
        # method or field a base defines is the subclass's own (the
        # runners share their loop through a base with no __init__)
        self.nodes = (node,) + tuple(bases)
        self.methods: Dict[str, ast.FunctionDef] = {}
        for cls in reversed(self.nodes):
            self.methods.update(
                {n.name: n for n in cls.body
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))})
        self.lock_fields: Dict[str, str] = {}   # field -> canonical lock
        self.selfsync: Set[str] = set()
        self.typed: Dict[str, str] = {}         # ref field -> class name
        self.entries: Dict[str, str] = {}       # method -> thread label
        self.ctor_threads: Set[str] = set()     # threads that construct it
        self.external = False                   # constructed outside the
        #                                         monitored closure
        self.is_handler = any(
            attr_chain(b)[-1:] == ["BaseHTTPRequestHandler"]
            for b in node.bases)


def _enclosing_class(node: ast.AST) -> Optional[ast.ClassDef]:
    cur = getattr(node, "_parent", None)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = getattr(cur, "_parent", None)
    return None


def _enclosing_unit(node: ast.AST) -> Optional[ast.FunctionDef]:
    cur = getattr(node, "_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "_parent", None)
    return None


def _shallow(fn: ast.AST):
    """Nodes of ``fn`` excluding nested function bodies (a nested def is
    its own unit — it may run on a different thread than its encloser)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _annot_class(node: Optional[ast.AST], classes: Dict[str, _ClassInfo]
                 ) -> Optional[str]:
    """The monitored class named by a parameter annotation — handles
    ``Engine``, ``"Engine"`` and ``Optional["Engine"]`` shapes."""
    if node is None:
        return None
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on 3.9+
        return None
    for name in _ANNOT_NAME_RE.findall(text):
        if name in classes:
            return name
    return None


def _init_helpers(ci: "_ClassInfo") -> Set[str]:
    """Private methods called only from ``__init__`` (``self.m(...)``, at
    least once): their writes are construction too (a shared init helper
    such as the runners' ``_init_loop``)."""
    callers: Dict[str, Set[str]] = {}
    for mname, m in ci.methods.items():
        for node in ast.walk(m):
            if isinstance(node, ast.Attribute):
                ac = attr_chain(node)
                if len(ac) == 2 and ac[0] == "self" and ac[1] in ci.methods:
                    callers.setdefault(ac[1], set()).add(mname)
    return {m for m, cs in callers.items()
            if m.startswith("_") and not m.startswith("__")
            and cs == {"__init__"}}


def _thread_of_spawn(call: ast.Call) -> Tuple[Optional[List[str]], str]:
    """(target attr chain, thread label) for a ``threading.Thread(...)``
    call; (None, "") when it is not one or the target is opaque."""
    chain = attr_chain(call.func)
    if not chain or chain[-1] != "Thread":
        return None, ""
    target = None
    label = ""
    for kw in call.keywords:
        if kw.arg == "target":
            target = attr_chain(kw.value)
        elif kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            label = kw.value.value
    if not target:
        return None, ""
    return target, (label or target[-1])


class _Model:
    """The package-wide model: monitored classes, thread sets per
    (class, unit), and the raw access stream."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.classes: Dict[str, _ClassInfo] = {}
        # (class, unit-name) -> set of thread labels
        self.threads: Dict[Tuple[str, str], Set[str]] = {}
        # (class, unit-name) -> locks provably held on every entry
        self.entry_held: Dict[Tuple[str, str], Optional[frozenset]] = {}
        # accesses: (class, field, kind, unit-key, guards, src, line)
        self.accesses: List[tuple] = []
        self._index_classes()
        self._seed_entries()
        self._propagate_threads()
        self._collect_accesses()

    # -- pass 1: class index, lock fields, typing, constructor sites ----
    def _all_classes(self):
        for src in self.ctx.sources:
            for node in ast.walk(src.tree):
                if isinstance(node, ast.ClassDef):
                    yield src, node

    def _index_classes(self) -> None:
        by_name: Dict[str, List] = {}
        for src, node in self._all_classes():
            by_name.setdefault(node.name, []).append((src, node))
        # unambiguous names only: two classes sharing a name cannot be
        # told apart at a constructor site, so neither is typed/monitored
        candidates = {n: v[0] for n, v in by_name.items() if len(v) == 1}

        def bases_of(node) -> Tuple[ast.ClassDef, ...]:
            out: List[ast.ClassDef] = []
            todo = list(node.bases)
            while todo:
                b = attr_chain(todo.pop(0))
                if b and b[-1] in candidates and len(out) < 8:
                    base = candidates[b[-1]][1]
                    out.append(base)
                    todo.extend(base.bases)
            return tuple(out)

        def info_of(name):
            src, node = candidates[name]
            ci = _ClassInfo(src, node, bases_of(node))
            self._scan_fields(ci)
            return ci

        infos = {n: info_of(n) for n in candidates}
        monitored: Set[str] = set()
        for n, ci in infos.items():
            if ci.lock_fields or ci.is_handler or self._spawns(ci):
                monitored.add(n)
        # second wave: runner-pattern classes (ctor annotated with a
        # monitored class) join the set
        for n, ci in infos.items():
            if n in monitored:
                continue
            init = ci.methods.get("__init__")
            if init is None:
                continue
            for a in init.args.args[1:]:
                if _annot_class(a.annotation, {m: infos[m]
                                               for m in monitored}):
                    monitored.add(n)
                    break
        self.classes = {n: infos[n] for n in monitored}
        # typed ref fields may point at any monitored class
        for ci in self.classes.values():
            self._scan_typed(ci)

    def _spawns(self, ci: _ClassInfo) -> bool:
        for node in (n for c in ci.nodes for n in ast.walk(c)):
            if isinstance(node, ast.Call):
                target, _ = _thread_of_spawn(node)
                if target and target[:1] == ["self"] and len(target) == 2:
                    return True
        return False

    def _scan_fields(self, ci: _ClassInfo) -> None:
        """Lock / condition / self-synchronizing fields from ``self.f =
        <factory>(...)`` assignments anywhere in the class."""
        cond_wraps: Dict[str, Optional[str]] = {}
        for node in (n for c in ci.nodes for n in ast.walk(c)):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1):
                continue
            t = node.targets[0]
            tc = attr_chain(t)
            if len(tc) != 2 or tc[0] != "self":
                continue
            if not isinstance(node.value, ast.Call):
                continue
            fc = attr_chain(node.value.func)
            leaf = fc[-1] if fc else ""
            if leaf in _LOCK_FACTORIES:
                ci.lock_fields[tc[1]] = tc[1]
            elif leaf == "Condition":
                wrapped = None
                if node.value.args:
                    ac = attr_chain(node.value.args[0])
                    if len(ac) == 2 and ac[0] == "self":
                        wrapped = ac[1]
                cond_wraps[tc[1]] = wrapped
            elif leaf in _SELFSYNC_FACTORIES:
                ci.selfsync.add(tc[1])
        for f, wrapped in cond_wraps.items():
            # a Condition guards as the lock it wraps; a bare Condition
            # carries its own lock
            ci.lock_fields[f] = (ci.lock_fields.get(wrapped, wrapped)
                                 if wrapped else f)

    def _scan_typed(self, ci: _ClassInfo) -> None:
        for mname, m in ci.methods.items():
            # annotated parameters of the method that binds the field
            # (__init__, or a shared init helper such as _init_loop)
            params: Dict[str, str] = {}
            for a in list(m.args.args[1:]) + m.args.kwonlyargs:
                k = _annot_class(a.annotation, self.classes)
                if k:
                    params[a.arg] = k
            self._scan_typed_in(ci, m, params)

    def _scan_typed_in(self, ci: _ClassInfo, unit: ast.AST,
                       params: Dict[str, str]) -> None:
        for node in ast.walk(unit):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1):
                continue
            tc = attr_chain(node.targets[0])
            if len(tc) != 2 or tc[0] != "self":
                continue
            if isinstance(node.value, ast.Call):
                fc = attr_chain(node.value.func)
                if fc and fc[-1] in self.classes:
                    ci.typed[tc[1]] = fc[-1]
            elif isinstance(node.value, ast.Name) \
                    and node.value.id in params:
                ci.typed[tc[1]] = params[node.value.id]

    # -- pass 2: entries + propagation ----------------------------------
    def _seed_entries(self) -> None:
        # spawn sites: self-method targets label their method
        for src in self.ctx.sources:
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.Call):
                    continue
                target, label = _thread_of_spawn(node)
                if not target:
                    continue
                if target[:1] == ["self"] and len(target) == 2:
                    cls = _enclosing_class(node)
                    if cls is not None and cls.name in self.classes:
                        self.classes[cls.name].entries[target[1]] = label
                elif len(target) == 1:
                    # module-level target: determinism's resolver closes
                    # over it; module functions hold no self state, so
                    # the closure is only scanned to stay conservative
                    for fn in [f for f in src.functions()
                               if f.name == target[0]]:
                        _reachable(self.ctx, src, fn)
        for ci in self.classes.values():
            if ci.is_handler:
                for m in ci.methods:
                    if m.startswith("do_"):
                        ci.entries[m] = "http-handler"
            for (cname, m), label in DRIVER_ENTRIES.items():
                if cname == ci.name and m in ci.methods:
                    ci.entries[m] = label
            # one driver label for online spawn entries named like the
            # scheduler loop: the offline run() pin only helps if both
            # drive modes share a label
            for m, label in list(ci.entries.items()):
                if "scheduler" in label:
                    ci.entries[m] = DRIVER_THREAD
        self._mark_external()

    def _mark_external(self) -> None:
        """A class constructed anywhere outside monitored-class methods
        is externally published: its public methods are client entries."""
        inside: Dict[str, Set[Tuple[str, str]]] = {n: set()
                                                   for n in self.classes}
        outside: Set[str] = set()
        for src in self.ctx.sources:
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.Call):
                    continue
                fc = attr_chain(node.func)
                if not fc or fc[-1] not in self.classes:
                    continue
                name = fc[-1]
                cls = _enclosing_class(node)
                unit = _enclosing_unit(node)
                if (cls is not None and cls.name in self.classes
                        and unit is not None
                        and cls.name != name):
                    inside[name].add((cls.name, unit.name))
                else:
                    outside.add(name)
        for n, ci in self.classes.items():
            # a BaseHTTPRequestHandler subclass has no visible ctor site,
            # but its construction protocol is known: the framework
            # instantiates it per connection ON the handler thread
            ci.external = (n in outside or not inside[n]) \
                and not ci.is_handler
            ci._ctor_units = inside[n]  # resolved to threads after prop.

    def _unit_key(self, cname: str, uname: str) -> Tuple[str, str]:
        return (cname, uname)

    def _edges_of(self, ci: _ClassInfo, uname: str, unit: ast.AST
                  ) -> Tuple[List[Tuple[str, str]],
                             List[Tuple[str, str, str]]]:
        """(call edges, sink-assigned nested units) of one unit."""
        edges: List[Tuple[str, str]] = []
        sinks: List[Tuple[str, str, str]] = []
        local_types = self._local_types(ci, unit)
        nested = {n.name for n in ast.iter_child_nodes(unit)
                  if isinstance(n, ast.FunctionDef)}
        for node in _shallow(unit):
            if isinstance(node, ast.Attribute):
                # any reference to a method — a call head, a property
                # access, a bound method handed out as a callback — is an
                # edge: the target runs on (at least) this unit's threads
                ac = attr_chain(node)
                if len(ac) == 2 and ac[0] == "self" \
                        and ac[1] in ci.methods:
                    edges.append((ci.name, ac[1]))
                elif (len(ac) == 3 and ac[0] == "self"
                        and ac[1] in ci.typed
                        and ac[2] in
                        self.classes[ci.typed[ac[1]]].methods):
                    edges.append((ci.typed[ac[1]], ac[2]))
                elif (len(ac) == 2 and ac[0] in local_types
                        and ac[1] in
                        self.classes[local_types[ac[0]]].methods):
                    edges.append((local_types[ac[0]], ac[1]))
            if not isinstance(node, ast.Call):
                continue
            fc = attr_chain(node.func)
            if len(fc) >= 2 and (fc[-2], fc[-1]) in SINK_CALLS:
                for arg in node.args:
                    if isinstance(arg, ast.Name) and arg.id in nested:
                        sinks.append((ci.name, f"{uname}.{arg.id}",
                                      SINK_CALLS[(fc[-2], fc[-1])]))
        # plain nested defs inherit the encloser's thread via an edge
        for n in ast.iter_child_nodes(unit):
            if isinstance(n, ast.FunctionDef):
                edges.append((ci.name, f"{uname}.{n.name}"))
        return edges, sinks

    def _local_types(self, ci: _ClassInfo, unit: ast.AST
                     ) -> Dict[str, str]:
        out: Dict[str, str] = {}
        args = getattr(unit, "args", None)
        if args is not None:
            for a in list(args.args) + list(args.kwonlyargs):
                k = _annot_class(a.annotation, self.classes)
                if k:
                    out[a.arg] = k
        for node in _shallow(unit):
            if not isinstance(node, ast.Assign):
                continue
            names = [t.id for t in node.targets
                     if isinstance(t, ast.Name)]
            if not names:
                continue
            if isinstance(node.value, ast.Call):
                fc = attr_chain(node.value.func)
                if fc and fc[-1] in self.classes:
                    for nm in names:
                        out[nm] = fc[-1]
            else:
                vc = attr_chain(node.value)
                if (len(vc) == 2 and vc[0] == "self"
                        and vc[1] in ci.typed):
                    for nm in names:
                        out[nm] = ci.typed[vc[1]]
        return out

    def _units_of(self, ci: _ClassInfo):
        for mname, m in ci.methods.items():
            yield mname, m
            for n in ast.walk(m):
                if isinstance(n, ast.FunctionDef) and n is not m:
                    parent_unit = _enclosing_unit(n)
                    prefix = (parent_unit.name if parent_unit is not None
                              else mname)
                    yield f"{prefix}.{n.name}", n

    def _propagate_threads(self) -> None:
        threads: Dict[Tuple[str, str], Set[str]] = {}
        edges: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        pinned: Set[Tuple[str, str]] = set()
        for ci in self.classes.values():
            for uname, unit in self._units_of(ci):
                key = self._unit_key(ci.name, uname)
                threads.setdefault(key, set())
                es, sinks = self._edges_of(ci, uname, unit)
                edges[key] = es
                for cn, un, label in sinks:
                    threads.setdefault((cn, un), set()).add(label)
                    pinned.add((cn, un))
            for m, label in ci.entries.items():
                threads[(ci.name, m)].add(label)
                pinned.add((ci.name, m))
            for (cname, un), label in POOL_ENTRIES.items():
                if cname == ci.name and (cname, un) in threads:
                    threads[(cname, un)].add(label)
                    pinned.add((cname, un))
            if ci.external:
                for m in ci.methods:
                    if m == "__init__":
                        threads[(ci.name, m)].add(CLIENT)
                    elif not m.startswith("_") \
                            and (ci.name, m) not in pinned:
                        threads[(ci.name, m)].add(CLIENT)
        outer_changed = True
        while outer_changed:
            outer_changed = False
            changed = True
            while changed:
                changed = False
                for key, es in edges.items():
                    src_threads = threads.get(key) or set()
                    if not src_threads:
                        continue
                    for callee in es:
                        if callee in pinned or callee not in threads:
                            continue
                        if callee[1] == "__init__":
                            continue  # construction is exempt
                        before = len(threads[callee])
                        threads[callee] |= src_threads
                        if len(threads[callee]) != before:
                            changed = True
                            outer_changed = True
            # internal classes inherit their constructors' threads as a
            # floor — __init__ included, so callbacks handed out during
            # construction (on_compile=outer._note_compile) carry the
            # constructing thread into their targets on the next round
            for ci in self.classes.values():
                if ci.external:
                    ci.ctor_threads = {CLIENT}
                    continue
                if ci.is_handler:
                    ci.ctor_threads = {"http-handler"}
                for cu in getattr(ci, "_ctor_units", ()):
                    ci.ctor_threads |= threads.get(cu) or set()
                for m in ci.methods:
                    if (ci.name, m) in pinned:
                        continue
                    before = len(threads[(ci.name, m)])
                    threads[(ci.name, m)] |= ci.ctor_threads
                    if len(threads[(ci.name, m)]) != before:
                        outer_changed = True
        # a unit nothing reaches still runs on SOME caller thread
        for key, ts in threads.items():
            if not ts and key[1] != "__init__":
                ts.add(CLIENT)
        self.threads = threads

    # -- pass 3: accesses + helper-held fixpoint ------------------------
    def _guard_of_with(self, ci: _ClassInfo, item: ast.withitem,
                      local_types: Dict[str, str]) -> Optional[str]:
        chain = attr_chain(item.context_expr)
        if not chain:
            return None
        if len(chain) == 2 and chain[0] == "self" \
                and chain[1] in ci.lock_fields:
            return f"{ci.name}.{ci.lock_fields[chain[1]]}"
        if len(chain) == 3 and chain[0] == "self" \
                and chain[1] in ci.typed:
            k = self.classes[ci.typed[chain[1]]]
            if chain[2] in k.lock_fields:
                return f"{k.name}.{k.lock_fields[chain[2]]}"
        if len(chain) == 2 and chain[0] in local_types:
            k = self.classes[local_types[chain[0]]]
            if chain[1] in k.lock_fields:
                return f"{k.name}.{k.lock_fields[chain[1]]}"
        return None

    def _lexical_guards(self, node: ast.AST, unit: ast.AST,
                        ci: _ClassInfo, local_types) -> frozenset:
        out: Set[str] = set()
        cur = node
        while cur is not None and cur is not unit:
            parent = getattr(cur, "_parent", None)
            if isinstance(parent, ast.With) and cur in parent.body:
                for item in parent.items:
                    g = self._guard_of_with(ci, item, local_types)
                    if g:
                        out.add(g)
            cur = parent
        return frozenset(out)

    def _field_of(self, ci: _ClassInfo, node: ast.AST,
                  local_types: Dict[str, str]
                  ) -> Optional[Tuple[str, str]]:
        """(owner class, field) named by an attribute chain rooted at
        ``self`` — directly, through one typed ref hop, or through a
        typed local (``outer = self.outer; outer.counter += 1``)."""
        chain = attr_chain(node)
        if len(chain) == 2 and chain[0] == "self":
            return ci.name, chain[1]
        if len(chain) == 3 and chain[0] == "self" \
                and chain[1] in ci.typed:
            return ci.typed[chain[1]], chain[2]
        if len(chain) == 2 and chain[0] in local_types:
            return local_types[chain[0]], chain[1]
        return None

    def _is_plain_field(self, owner: str, field: str) -> bool:
        k = self.classes[owner]
        # methods, locks, self-sync primitives and typed object refs are
        # not data fields: a call through them is dispatch, not mutation
        return (field not in k.methods
                and field not in k.lock_fields
                and field not in k.selfsync
                and field not in k.typed)

    def _collect_accesses(self) -> None:
        call_sites: Dict[Tuple[str, str],
                         List[Tuple[Tuple[str, str], frozenset]]] = {}
        raw: List[tuple] = []
        for ci in self.classes.values():
            construction = {"__init__"} | _init_helpers(ci)
            for uname, unit in self._units_of(ci):
                ukey = self._unit_key(ci.name, uname)
                if uname in construction:
                    continue
                local_types = self._local_types(ci, unit)

                def note(node, owner, field, kind):
                    if not self._is_plain_field(owner, field):
                        return
                    g = self._lexical_guards(node, unit, ci, local_types)
                    raw.append((owner, field, kind, ukey, g,
                                ci.src.rel, node.lineno))

                for node in _shallow(unit):
                    if isinstance(node, (ast.Assign, ast.AugAssign,
                                         ast.AnnAssign)):
                        targets = (node.targets
                                   if isinstance(node, ast.Assign)
                                   else [node.target])
                        flat = []
                        for t in targets:
                            if isinstance(t, (ast.Tuple, ast.List)):
                                flat.extend(t.elts)
                            else:
                                flat.append(t)
                        for t in flat:
                            base = t
                            while isinstance(base, (ast.Subscript,
                                                    ast.Starred)):
                                base = base.value
                            fld = self._field_of(ci, base, local_types)
                            if fld:
                                note(t, fld[0], fld[1], "W")
                                if isinstance(node, ast.AugAssign) or \
                                        isinstance(t, ast.Subscript):
                                    note(t, fld[0], fld[1], "R")
                    elif isinstance(node, ast.Delete):
                        for t in node.targets:
                            base = t
                            while isinstance(base, ast.Subscript):
                                base = base.value
                            fld = self._field_of(ci, base, local_types)
                            if fld:
                                note(t, fld[0], fld[1], "W")
                    elif isinstance(node, ast.Call):
                        fc = attr_chain(node.func)
                        if len(fc) >= 3 and fc[-1] in _MUTATORS:
                            fld = self._field_of(
                                ci, node.func.value,  # type: ignore
                                local_types)
                            if fld:
                                note(node, fld[0], fld[1], "W")
                        # record call edges with guards for the
                        # helper-held fixpoint
                        if len(fc) == 2 and fc[0] == "self" \
                                and fc[1] in ci.methods:
                            g = self._lexical_guards(node, unit, ci,
                                                     local_types)
                            call_sites.setdefault(
                                (ci.name, fc[1]), []).append((ukey, g))
                    elif isinstance(node, ast.Attribute) \
                            and isinstance(node.ctx, ast.Load):
                        parent = getattr(node, "_parent", None)
                        if isinstance(parent, (ast.Attribute, ast.Call)) \
                                and getattr(parent, "func", None) is node:
                            continue  # method call heads handled above
                        fld = self._field_of(ci, node, local_types)
                        if fld:
                            note(node, fld[0], fld[1], "R")
        # helper-held fixpoint: a _-private helper inherits exactly the
        # locks EVERY observed call site provably holds; public methods
        # and thread entries hold nothing on entry by definition
        held: Dict[Tuple[str, str], frozenset] = {}
        private: Set[Tuple[str, str]] = set()
        for ci in self.classes.values():
            for uname, _u in self._units_of(ci):
                key = (ci.name, uname)
                held[key] = frozenset()
                base = uname.split(".")[0]
                if (base.startswith("_") and not base.startswith("__")
                        and base not in ci.entries):
                    private.add(key)
        for _ in range(3):  # enough for the repo's helper-call depth
            for callee, sites in call_sites.items():
                if callee not in private:
                    continue
                eff = None
                for caller, g in sites:
                    site = g | held.get(caller, frozenset())
                    eff = site if eff is None else (eff & site)
                held[callee] = frozenset(eff or ())
        self.entry_held = held
        self.accesses = [
            (owner, field, kind, ukey,
             guards | self.entry_held.get(ukey, frozenset()), rel, line)
            for owner, field, kind, ukey, guards, rel, line in raw]


def _short_guard(owner: str, guard: str) -> str:
    cls, _, field = guard.partition(".")
    return field if cls == owner else guard


def build_guard_map(ctx: Context) -> Tuple[Dict[str, str],
                                           List[Violation]]:
    """(field -> classification, violations). The map is the committed
    artifact; the violations are the unguarded multi-thread writes."""
    model = _Model(ctx)
    out: List[Violation] = []
    by_field: Dict[Tuple[str, str], List[tuple]] = {}
    for acc in model.accesses:
        by_field.setdefault((acc[0], acc[1]), []).append(acc)
    table: Dict[str, str] = {}
    for (owner, field), accs in sorted(by_field.items()):
        writes, reads = [], []
        for _o, _f, kind, ukey, guards, rel, line in accs:
            threads = model.threads.get(ukey) or {CLIENT}
            if threads == {INIT}:
                continue
            (writes if kind == "W" else reads).append(
                (frozenset(threads), guards, rel, line))
        key = f"{owner}.{field}"
        if not writes:
            table[key] = "unguarded-readonly"
            continue
        write_threads: Set[str] = set()
        for ts, _g, _r, _l in writes:
            write_threads |= ts
        common = None
        for _ts, g, _r, _l in writes:
            common = g if common is None else (common & g)
        common = common or frozenset()
        if common:
            table[key] = "lock:" + "+".join(
                sorted(_short_guard(owner, g) for g in common))
            continue
        # a pool label is several threads at once
        if len(write_threads) + len(write_threads & POOL_THREADS) <= 1:
            t = next(iter(write_threads)) if write_threads else CLIENT
            read_threads: Set[str] = set()
            for ts, _g, _r, _l in reads:
                read_threads |= ts
            if read_threads - write_threads:
                table[key] = f"single-writer({t})"
            else:
                table[key] = f"thread-confined({t})"
            continue
        # >= 2 writing threads, empty guard intersection: a race unless
        # every bare write site carries an allow[races] marker
        bare = [(rel, line) for _ts, g, rel, line in writes if not g]
        sites = bare or [(rel, line) for _ts, _g, rel, line in writes]
        reasons = []
        unmarked = []
        for rel, line in sorted(set(sites)):
            src = next((s for s in ctx.sources if s.rel == rel), None)
            ln = None if src is None else _allow_line(src, "races", line)
            if ln is not None:
                reasons.append(src.allows[ln]["races"])
            else:
                unmarked.append((rel, line))
        if not unmarked and reasons:
            table[key] = f"allow({reasons[0]})"
        else:
            table[key] = "UNGUARDED"
        threads_s = "+".join(sorted(write_threads))
        for rel, line in sorted(set(sites)):
            out.append(Violation(
                "races", rel, line,
                f"field {key} is written from threads [{threads_s}] "
                f"with no common lock — guard every write with one "
                f"shared lock, or allow-mark the benign pattern "
                f"(# heat-tpu: allow[races] why)"))
    return table, out


def guards_path(ctx: Context):
    return ctx.schema_registry.with_name("guards.json")


def load_guard_map(path) -> Optional[dict]:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return None


def write_guard_map(path, table: Dict[str, str]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"version": 1,
               "comment": "committed cross-thread guard map — regenerate "
                          "with `heat-tpu-torch check --update-schemas` and "
                          "review the diff (a new shared field, or a "
                          "changed guard, is reviewed with the code)",
               "fields": table}
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")


@register("races",
          "per-field lockset/guard-map analysis over the thread-shared "
          "objects; unguarded multi-thread writes fail, classifications "
          "gated against schemas/guards.json")
def check(ctx: Context) -> List[Violation]:
    table, out = build_guard_map(ctx)
    path = guards_path(ctx)
    if ctx.update_schemas:
        write_guard_map(path, table)
        return out
    if not table and not path.exists():
        # a tree with no thread-shared classes needs no committed map
        return out
    committed = load_guard_map(path)
    if committed is None:
        out.append(Violation(
            "races", path.name if not path.exists() else str(path), 0,
            f"guard map {path} missing/unreadable — generate it with "
            f"`heat-tpu-torch check --update-schemas` and commit it"))
        return out
    old = committed.get("fields", {})
    rel = "analysis/schemas/guards.json"
    for key in sorted(set(old) | set(table)):
        if key not in table:
            out.append(Violation(
                "races", rel, 0,
                f"guard-map drift: field {key!r} is committed but no "
                f"longer observed — if intentional, run `heat-tpu-torch check "
                f"--update-schemas` and commit the diff"))
        elif key not in old:
            out.append(Violation(
                "races", rel, 0,
                f"guard-map drift: new shared field {key!r} "
                f"(classified {table[key]!r}) not in the committed map "
                f"— run `heat-tpu-torch check --update-schemas` and commit "
                f"the diff so the guard change is reviewed"))
        elif old[key] != table[key]:
            out.append(Violation(
                "races", rel, 0,
                f"guard-map drift: field {key!r} changed "
                f"{old[key]!r} -> {table[key]!r} — a guard change is a "
                f"concurrency-contract change; if intentional, "
                f"`heat-tpu-torch check --update-schemas` and commit the diff"))
    return out
