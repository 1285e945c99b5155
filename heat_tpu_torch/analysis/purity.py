"""Rule family 1 — **hot-path purity** (``hot-path-purity``).

The serve hot loop's performance rests on one discipline: the dispatch and
round-robin paths enqueue device work and NEVER wait on it — the only
device->host transfer is the boundary fetch, funneled through the
``host_fetch`` / ``fetch_boundary`` seams so it can be watchdogged,
traced, and monkeypatch-proven. One stray ``.item()`` or ``.cpu()`` in
``dispatch_fill`` silently re-fences every chunk.

This rule bans, inside the **hot function set** (the dispatch/round-robin
paths of ``serve/scheduler.py`` — the runners' shared loop, the hooks each
runner overrides, the drive loops — the chunk dispatchers of
``serve/engine.py`` and the lane-kernel chunk of ``ops/cuda_lanes.py``):

- torch's host syncs: ``.item()``, ``.cpu()``, ``.numpy()``,
  ``.tolist()``, ``torch.cuda.synchronize`` and ``Event``/``Stream``
  ``.synchronize()``;
- ``np.asarray`` / ``np.array`` (of a tensor, a host round trip) and
  direct ``host_fetch`` calls;
- ``float(...)`` / ``int(...)`` applied to a boundary ``handle`` (the
  classic scalarization sync).

The sanctioned seams — ``host_fetch``, ``fetch_boundary``,
``LaneEngine.fetch_remaining`` — are *in* the hot set and carry explicit
``# heat-tpu: allow[hot-path-purity]`` markers: the rule proves every
other site clean and the markers document why those are the exception.
"""

from __future__ import annotations

import ast
from typing import List

from .core import (Context, Violation, attr_chain, call_name, dotted,
                   register)

# qualnames (suffix-matched against FunctionDef._qualname) per file: the
# runners' shared loop (_Runner), the hooks it calls that each runner
# overrides (the bucket group's and the mega slot's), and the drive loops
_RUNNER_LOOP = ("dispatch_fill", "process_boundary", "sync_round",
                "_judge_lanes", "_maybe_poison")
_RUNNER_HOOKS = ("_dispatch", "_next_k", "_fenced_k", "_snapshot",
                 "_poison", "_perturb", "_fetch_boundary")
SCHEDULER_HOT = (tuple(f"_Runner.{m}" for m in _RUNNER_LOOP)
                 + tuple(f"{cls}.{m}" for cls in ("_GroupRunner",
                                                  "MegaLaneRunner")
                         for m in _RUNNER_HOOKS)
                 + ("Engine.run", "Engine._serve_loop"))
ENGINE_HOT = (
    "LaneEngine.dispatch_chunk", "MegaLaneEngine.dispatch_chunk",
    # the sanctioned seams themselves — their D2H calls carry markers
    "host_fetch", "fetch_boundary", "LaneEngine.fetch_remaining",
)
LANES_HOT = ("lane_chunk",)
COMMON_HOT = ("host_fetch",)
# file suffix -> hot qualnames
HOT_FILES = {
    "serve/scheduler.py": SCHEDULER_HOT,
    "serve/engine.py": ENGINE_HOT,
    "ops/cuda_lanes.py": LANES_HOT,
    "backends/common.py": COMMON_HOT,
}

_SYNC_CALLS = {"item", "cpu", "numpy", "tolist", "synchronize"}
_FETCH_CALLS = {"asarray", "array", "host_fetch"}
_ARRAY_MODULES = {"np", "numpy"}


def hot_functions(src, quals):
    for fn in src.functions():
        q = getattr(fn, "_qualname", fn.name)
        for want in quals:
            if q == want or q.endswith("." + want):
                yield fn, want
                break


def _check_fn(src, fn: ast.FunctionDef, out: List[Violation]) -> None:
    seen_lines = set()

    def report(node, msg):
        key = (node.lineno, msg)
        if key in seen_lines:
            return
        seen_lines.add(key)
        out.append(Violation("hot-path-purity", src.rel, node.lineno, msg))

    q = getattr(fn, "_qualname", fn.name)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        chain = attr_chain(node.func)
        if name in _SYNC_CALLS and isinstance(node.func, ast.Attribute):
            report(node, f"device sync `{dotted(node.func) or name}()` in "
                         f"hot function {q} — the dispatch path must "
                         f"never fence (route through the boundary-fetch "
                         f"seam)")
        elif name in _FETCH_CALLS and (
                name == "host_fetch"
                or (chain and chain[0] in _ARRAY_MODULES)):
            report(node, f"eager host round trip "
                         f"`{dotted(node.func) or name}(...)` in hot "
                         f"function {q} — the only sanctioned D2H is the "
                         f"host_fetch/fetch_boundary seam")
        elif (isinstance(node.func, ast.Name)
              and node.func.id in ("float", "int") and node.args):
            arg_names = {n.id for n in ast.walk(node.args[0])
                         if isinstance(n, ast.Name)}
            if arg_names & {"handle", "boundary_handle"}:
                report(node, f"`{node.func.id}()` scalarization of a "
                             f"device boundary handle in hot function "
                             f"{q} — fetch through the seam instead")


@register("hot-path-purity",
          "no device syncs / eager fetches in the serve dispatch paths")
def check(ctx: Context) -> List[Violation]:
    out: List[Violation] = []
    for src in ctx.sources:
        for suffix, quals in HOT_FILES.items():
            if src.rel.endswith(suffix):
                for fn, _ in hot_functions(src, quals):
                    _check_fn(src, fn, out)
    return out
