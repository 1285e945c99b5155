"""Backend registry for the fleet router (``heat_tpu.fleet.registry``'s
contract).

One :class:`Backend` per engine gateway the router fronts: its address,
health-probe state, the last machine-readable ``GET /v1/status`` payload
(the placement policy's food), and the router-local accounting the
status payload cannot know yet (work routed there whose terminal record
has not come back). The :class:`BackendRegistry` owns them all under one
lock of rank ``fleet`` (the order is fleet < gateway < engine: the router
is outermost in every request path, and two fleet-rank locks never
nest): every mutation goes through a registry method, and the placement
policy reads consistent snapshots.

Backends come from the ``--backends host:port,...`` flag or a backends
file (one ``[name=]host:port`` per line, ``#`` comments) re-read when
its mtime changes — new entries join the fleet live; removing a line
does NOT evict a live backend (in-flight work may still be streaming
back from it), it only stops new placements once the probe marks it
down.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple


def parse_backends(spec: str) -> List[Tuple[str, str]]:
    """``[name=]host:port,...`` -> ``[(name, "host:port"), ...]``.
    Unnamed entries get positional names ``b0, b1, ...`` (stable across
    restarts as long as the flag order is); duplicate names or
    addresses are a config error, not a silent merge."""
    out: List[Tuple[str, str]] = []
    for i, raw in enumerate(s.strip() for s in spec.split(",")):
        if not raw:
            continue
        name, eq, addr = raw.partition("=")
        if not eq:
            name, addr = f"b{i}", raw
        host, colon, port = addr.rpartition(":")
        if not colon or not host or not port.isdigit():
            raise ValueError(f"bad backend {raw!r}: expected "
                             f"[name=]host:port")
        out.append((name.strip(), addr.strip()))
    names = [n for n, _ in out]
    addrs = [a for _, a in out]
    for kind, vals in (("name", names), ("address", addrs)):
        dup = {v for v in vals if vals.count(v) > 1}
        if dup:
            raise ValueError(f"duplicate backend {kind}(s) in "
                             f"{spec!r}: {sorted(dup)}")
    return out


def load_backends_file(path) -> List[Tuple[str, str]]:
    """One ``[name=]host:port`` per line; ``#`` comments and blank lines
    ignored. Same grammar as the flag, one entry per line."""
    lines = []
    for line in Path(path).read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            lines.append(line)
    return parse_backends(",".join(lines))


class Backend:
    """One engine gateway as the router sees it. All mutable fields are
    guarded by the owning registry's lock (mutations go through registry
    methods); ``name``/``address`` are immutable identity."""

    def __init__(self, name: str, address: str):
        self.name = name
        self.address = address              # "host:port"
        # --- health (probe thread) ---------------------------------------
        self.healthy = True                 # optimistic until a probe says
                                            # otherwise, so a cold fleet
                                            # routes before the first tick
        self.draining = False               # backend answered 503 draining
        self.lost = False                   # transitioned down (recovery
                                            # ran or is running)
        self.fault_down = False             # backend-down chaos: the
                                            # router refuses to connect
        self.probe_passes = 0
        self.probe_fails = 0
        self.consecutive_failures = 0
        # --- placement food ----------------------------------------------
        self.status: Optional[dict] = None  # last GET /v1/status payload
        self.status_t = 0.0                 # monotonic stamp of it
        self.pending_steps = 0              # routed, no terminal record yet
        self.pending_requests = 0
        # --- counters ----------------------------------------------------
        self.routed = 0
        self.delivered = 0
        self.retried = 0
        self.stolen_from = 0
        self.stolen_to = 0

    def __repr__(self) -> str:  # debugging/statusz ergonomics
        return (f"Backend({self.name}@{self.address} "
                f"{'up' if self.healthy else 'DOWN'})")


class BackendRegistry:
    """The fleet's member list + per-backend state, under one lock."""

    def __init__(self, backends: List[Tuple[str, str]] = (),
                 backends_file=None):
        self._lock = threading.Lock()   # rank: fleet (fleet < gateway
                                        # < engine; never nests with the
                                        # router's own fleet lock)
        self._backends: Dict[str, Backend] = {}
        self._file = Path(backends_file) if backends_file else None
        self._file_mtime: Optional[float] = None
        for name, addr in backends:
            self._backends[name] = Backend(name, addr)
        if self._file is not None:
            self.refresh_file()

    # --- membership -------------------------------------------------------
    def snapshot(self) -> List[Backend]:
        """The live member list (registration order). Backend field
        reads after release are racy-by-design advisory reads — the
        placement policy tolerates a stale backlog number; every
        *mutation* goes back through a registry method."""
        with self._lock:
            return list(self._backends.values())

    def get(self, name: str) -> Optional[Backend]:
        with self._lock:
            return self._backends.get(name)

    def refresh_file(self) -> List[str]:
        """Re-read the backends file when its mtime moved; returns the
        names of newly joined backends. Lines that disappeared do not
        evict live members (see module doc)."""
        if self._file is None:
            return []
        try:
            mtime = self._file.stat().st_mtime
        except OSError:
            return []
        with self._lock:
            if self._file_mtime == mtime:
                return []
            self._file_mtime = mtime
        joined = []
        for name, addr in load_backends_file(self._file):
            with self._lock:
                if name not in self._backends:
                    self._backends[name] = Backend(name, addr)
                    joined.append(name)
        return joined

    # --- probe results ----------------------------------------------------
    def note_probe(self, name: str, ok: bool, draining: bool = False,
                   status: Optional[dict] = None,
                   now: float = 0.0) -> Tuple[bool, bool]:
        """Fold one health-probe round in; returns ``(was_healthy,
        is_healthy)`` so the caller sees the down transition (the
        flight-dump + recovery trigger) exactly once."""
        with self._lock:
            b = self._backends.get(name)
            if b is None:
                return (False, False)
            was = b.healthy and not b.lost
            if ok:
                b.probe_passes += 1
                b.consecutive_failures = 0
            else:
                b.probe_fails += 1
                b.consecutive_failures += 1
            b.draining = draining
            b.healthy = ok and not draining and not b.fault_down
            if status is not None:
                b.status = status
                b.status_t = now
            return (was, b.healthy)

    def set_fault_down(self, name: str,
                       down: bool = True) -> Optional[Backend]:
        """backend-down / backend-flap chaos: drop the TCP target —
        every future connect to it fails as if the host vanished
        (``down=False`` restores it: the flap's up half-period).
        ``healthy`` is left for the next probe round to flip: the
        router must DISCOVER the loss the way it would a real one
        (probe fails -> was/is transition -> flight dump + recovery),
        not be told by the drill. Placement never routes here meanwhile
        — ``eligible`` checks ``fault_down`` itself."""
        with self._lock:
            b = self._backends.get(name)
            if b is not None:
                b.fault_down = down
            return b

    def mark_lost(self, name: str) -> None:
        with self._lock:
            b = self._backends.get(name)
            if b is not None:
                b.lost = True
                b.healthy = False

    def mark_found(self, name: str) -> None:
        """Re-admit a lost backend (half-open canary passed through the
        router path): clear ``lost`` so placement and stealing see it
        again. The next probe round re-establishes ``healthy``; we set
        it optimistically here so the canary's verdict takes effect
        before the next tick."""
        with self._lock:
            b = self._backends.get(name)
            if b is not None:
                b.lost = False
                b.healthy = not b.fault_down and not b.draining
                b.consecutive_failures = 0

    # --- router-local accounting -----------------------------------------
    def note_routed(self, name: str, requests: int, steps: int) -> None:
        with self._lock:
            b = self._backends.get(name)
            if b is not None:
                b.routed += requests
                b.pending_requests += requests
                b.pending_steps += steps

    def note_done(self, name: str, steps: int) -> None:
        with self._lock:
            b = self._backends.get(name)
            if b is not None:
                b.delivered += 1
                b.pending_requests = max(0, b.pending_requests - 1)
                b.pending_steps = max(0, b.pending_steps - steps)

    def note_unrouted(self, name: str, requests: int, steps: int) -> None:
        """Work taken away from a backend (retry, steal, re-drive):
        reverse the pending accounting without counting a delivery."""
        with self._lock:
            b = self._backends.get(name)
            if b is not None:
                b.pending_requests = max(0, b.pending_requests - requests)
                b.pending_steps = max(0, b.pending_steps - steps)

    def note_retry(self, name: str) -> None:
        with self._lock:
            b = self._backends.get(name)
            if b is not None:
                b.retried += 1

    def note_steal(self, victim: str, thief: str) -> None:
        with self._lock:
            v = self._backends.get(victim)
            t = self._backends.get(thief)
            if v is not None:
                v.stolen_from += 1
            if t is not None:
                t.stolen_to += 1
