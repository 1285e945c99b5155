"""Deterministic fault injection for the solve path.

Makes the failure modes of a long solve injectable and deterministic, so
the crash -> resume -> converge loop (checkpoint quarantine, async-writer
retry, NaN rollback) is a tested subsystem:

- ``crash@N[:proc=P]``       — hard worker death (``os._exit``) at step >= N
- ``nan@N[:proc=P]``         — flip one cell of the field to NaN at step >= N
                               (a soft-error analog; pairs with
                               ``--on-nan rollback``)
- ``ckpt-corrupt@N``         — scribble over the checkpoint published at
                               step >= N (bitrot / torn-write analog)
- ``ckpt-truncate@N``        — cut that checkpoint file in half instead
- ``sink-error@N[:times=K]`` — the first K checkpoint writes at step >= N
                               raise a transient ``OSError(EIO)`` (the class
                               ``async_io.SnapshotWriter`` retries)
- ``sink-slow:ms=M``         — every checkpoint write sleeps M ms first

The grammar and the solve-scope semantics are ``heat_tpu.runtime.faults``'s;
its serving and fleet kinds come with the slices that port those layers.

Specs come from ``--inject`` (``HeatConfig.inject``) or the
``HEAT_TPU_FAULTS`` env var; multiple faults are comma-separated, e.g.
``"nan@6,ckpt-corrupt@8"``. Grammar per fault: ``kind[@step][:key=val]...``.

Every fault is **restart-gated**: by default it fires only in incarnation 0
(``restart=R`` selects another, ``restart=-1`` fires in every one), read
from ``HEAT_TPU_RESTART``, so an injected crash kills the first run and not
the resumed one.

Strictly opt-in: with no spec, ``plan_for`` returns ``None`` and every call
site skips on one ``is not None`` test.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from .logging import master_print

ENV_VAR = "HEAT_TPU_FAULTS"
RESTART_ENV_VAR = "HEAT_TPU_RESTART"

# Distinctive exit code for an injected crash, so "chaos did this" is told
# apart from a real rc=1 traceback death.
CRASH_RC = 43

_KINDS = ("crash", "nan", "ckpt-corrupt", "ckpt-truncate", "sink-error",
          "sink-slow")


@dataclasses.dataclass
class Fault:
    kind: str
    step: Optional[int] = None  # fires at the first boundary/step >= this
    proc: Optional[int] = None  # None = every process
    times: int = 1              # sink-error: how many writes fail
    ms: float = 0.0             # sink-slow: delay
    restart: int = 0            # incarnation filter (-1 = every incarnation)
    fired: bool = False


def _restart_count() -> int:
    try:
        return int(os.environ.get(RESTART_ENV_VAR, "0"))
    except ValueError:
        return 0


def _process_index() -> int:
    """This process's rank: the ``torch.distributed`` rank when a group is
    initialised, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def parse_spec(spec: str) -> List[Fault]:
    """Parse a fault spec; raises ValueError with the grammar on any typo
    (config validation calls this so a bad spec dies at parse time, not at
    step N of a long solve)."""
    faults = []
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        head, _, tail = entry.partition(":")
        kind, _, step_s = head.partition("@")
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in {entry!r}; grammar is "
                f"'kind[@step][:key=val]...' with kind one of {_KINDS}")
        f = Fault(kind=kind)
        if step_s:
            try:
                f.step = int(step_s)
            except ValueError:
                raise ValueError(f"bad step {step_s!r} in fault {entry!r}")
        for kv in filter(None, tail.split(":")):
            key, eq, val = kv.partition("=")
            if not eq or key not in ("proc", "times", "ms", "restart"):
                raise ValueError(
                    f"bad fault param {kv!r} in {entry!r}; keys are "
                    f"proc=, times=, ms=, restart=")
            try:
                setattr(f, key, float(val) if key == "ms" else int(val))
            except ValueError:
                raise ValueError(f"bad value {val!r} for {key} in {entry!r}")
        if f.kind in ("crash", "nan") and f.step is None:
            raise ValueError(f"fault {entry!r} needs a step: '{f.kind}@N'")
        faults.append(f)
    return faults


class FaultPlan:
    """One parsed spec with its firing state (fire-once flags, sink-error
    budgets). Plans are cached per spec string so the drive loop, the
    checkpoint writer, and the async sink all decrement the SAME budgets
    within a process."""

    def __init__(self, spec: str):
        self.spec = spec
        self.faults = parse_spec(spec)

    def _live(self, kind: str):
        for f in self.faults:
            if f.kind != kind:
                continue
            if f.restart != -1 and f.restart != _restart_count():
                continue
            if f.proc is not None and f.proc != _process_index():
                continue
            yield f

    # --- step-loop faults (backends.common.drive / serial loop) ----------
    def maybe_crash(self, step: int) -> None:
        for f in self._live("crash"):
            if not f.fired and step >= f.step:
                f.fired = True
                print(f"fault: injected crash at step {step} "
                      f"(proc {_process_index()}, spec {self.spec!r})",
                      file=sys.stderr, flush=True)
                os._exit(CRASH_RC)

    def maybe_nan(self, step: int, T):
        """Flip the center cell to NaN once the step arrives; returns the
        (possibly replaced) field."""
        for f in self._live("nan"):
            if not f.fired and step >= f.step:
                f.fired = True
                master_print(f"fault: injected NaN at step {step} "
                             f"(spec {self.spec!r})")
                T = _inject_nan(T)
        return T

    # --- checkpoint-sink faults (runtime.checkpoint.save) -----------------
    def sink_fault(self, step: int) -> None:
        """Called at the top of a checkpoint write: transient-error and
        slow-sink faults land here, BEFORE any bytes move."""
        for f in self._live("sink-slow"):
            if f.ms > 0:
                time.sleep(f.ms / 1000.0)
        for f in self._live("sink-error"):
            if f.times > 0 and (f.step is None or step >= f.step):
                f.times -= 1
                raise OSError(
                    errno.EIO,
                    f"injected transient sink error at step {step} "
                    f"({f.times} more to come; spec {self.spec!r})")

    def damage_checkpoint(self, path: Path, step: int) -> None:
        """Called after a checkpoint file is published: corrupt/truncate
        faults damage it in place (the bitrot the quarantine path must
        catch on the next resume)."""
        for f in self._live("ckpt-corrupt"):
            if not f.fired and (f.step is None or step >= f.step):
                f.fired = True
                data = bytearray(path.read_bytes())
                mid = len(data) // 2
                for i in range(mid, min(mid + 64, len(data))):
                    data[i] ^= 0xFF
                path.write_bytes(bytes(data))
                master_print(f"fault: corrupted checkpoint {path.name} "
                             f"(spec {self.spec!r})")
        for f in self._live("ckpt-truncate"):
            if not f.fired and (f.step is None or step >= f.step):
                f.fired = True
                data = path.read_bytes()
                path.write_bytes(data[:len(data) // 2])
                master_print(f"fault: truncated checkpoint {path.name} "
                             f"(spec {self.spec!r})")


def _inject_nan(T):
    import numpy as np
    import torch

    idx = tuple(s // 2 for s in T.shape)
    if isinstance(T, torch.Tensor):
        T[idx] = float("nan")   # the drive loop owns its field buffer
        return T
    T = np.array(T)
    T[idx] = np.nan
    return T


_PLANS: Dict[str, FaultPlan] = {}


def plan_for(cfg=None) -> Optional[FaultPlan]:
    """The active fault plan for this run, or None (the overwhelmingly
    common case). ``cfg.inject`` wins over ``HEAT_TPU_FAULTS``. Plans cache
    per spec so firing state is shared across the drive loop and the
    checkpoint module within a process."""
    spec = (getattr(cfg, "inject", "") or os.environ.get(ENV_VAR, "")).strip()
    if not spec:
        return None
    plan = _PLANS.get(spec)
    if plan is None:
        plan = _PLANS[spec] = FaultPlan(spec)
    return plan


def reset() -> None:
    """Drop all cached firing state (tests re-running a spec)."""
    _PLANS.clear()
