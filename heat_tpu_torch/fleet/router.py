"""The fleet router: one stdlib-HTTP process in front of N engine gateways.

``python -m heat_tpu_torch fleet --backends host:port,... --listen
HOST:PORT`` runs this in front of independent ``python -m heat_tpu_torch
serve --listen`` processes (the contract is ``heat_tpu.fleet.router``'s).
Admission moves to the edge, placement becomes a policy over live backend
status, and the engine's drain-to-checkpoint handoff becomes a
**work-stealing migration primitive** between backends. The router holds
no tensors and does no arithmetic on results; its backends keep the
card-by-default rule of ``serve``.

- ``POST /v1/solve`` — the same NDJSON front door every gateway has.
  The router validates each line with ``parse_request_obj`` (edge
  admission: malformed lines are rejected here and never travel),
  mints/echoes ``X-Trace-Id``, picks a backend per request via the
  placement policy (fleet/placement.py) fed from each gateway's
  ``GET /v1/status`` control payload, forwards per-backend batches, and
  streams every backend's chunked ndjson records back to the caller as
  they land — one merged stream, exactly-once per request id.
- **Retry-on-alternate**: a forward that provably never reached
  admission (connect refused/reset, 503 draining, 429 all-shed) is
  re-placed on the next-best backend; only when every backend refuses
  does the client see a terminal rejection record (error
  ``unroutable:``/``overloaded:`` — the router's refusal told apart
  from a backend's 429).
- **Checkpoint-handoff work stealing**: when the imbalance estimator
  sees one backend's predicted backlog exceed ``--steal-threshold``
  seconds while another idles, the router POSTs ``/drainz?handoff=1``
  to the victim, waits for the engine manifest generation to land in
  the victim's checkpoint dir, and re-drives the orphaned queued +
  in-flight work through ``resume_engine``'s skip-set front door on the
  idle backend (``POST /v1/resume``) — mid-flight lanes continue at
  their last checkpointed boundary, bit-identical bytes across the
  migration (tests/test_torch_fleet.py holds it). The same path recovers a
  backend that dies outright: manifest-covered work resumes, the rest
  re-drives fresh (deterministic solver — same bytes either way), and
  the delivered-set dedup guarantees no double-served ids.
- Fleet-wide ``/metrics`` + ``/statusz`` + ``/v1/usage`` aggregation
  with per-backend labels; ``/v1/usage`` merges the per-engine ledgers
  so fleet totals reconcile exactly with per-backend billing.
- ``/tracez`` — the router's OWN Tracer: forward spans per backend
  track, synthesized backend-side solve spans from each record's
  ``solve_s`` + ``trace_id``, so ``python -m heat_tpu_torch trace``
  renders one fleet timeline; the ring is flight-dumped when a backend is
  lost.

Threading model mirrors the gateway: handler threads (admission +
client streaming), one relay thread per forwarded batch, one health/
imbalance thread, recovery/steal threads spawned on demand, pollers
for resumed orphans. All router tables live under one lock of rank
``fleet`` (the order is fleet < gateway < engine: the router is outermost
in every request path); backend state lives under the registry's own
fleet-rank lock, and the two NEVER nest.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import queue as queue_lib
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple
from urllib.parse import parse_qs, urlsplit

from ..runtime import checkpoint as ckpt_mod
from ..runtime import faults
from ..runtime import prof as prof_mod
from ..runtime import trace as trace_mod
from ..runtime.logging import json_record, master_print
from ..serve.api import parse_request_obj
from ..serve.gateway import MAX_BODY_BYTES, _TRACE_ID_RE
from ..serve.scheduler import TERMINAL_STATUSES
from . import placement, resilience
from .registry import BackendRegistry


@dataclasses.dataclass
class FleetConfig:
    """Router-level knobs (per-backend engine knobs live with each
    ``serve`` process)."""

    policy: str = "least-loaded"   # placement policy (fleet/placement.py)
    health_interval_s: float = 2.0  # /healthz + /v1/status probe cadence
    steal_threshold_s: float = 0.0  # imbalance estimator: steal when
                                    # max-min predicted backlog exceeds
                                    # this many seconds (0 = stealing
                                    # off; forced steals via Router.steal
                                    # still work)
    steal_cooldown_s: float = 10.0  # min wall between automatic steals
                                    # (thrash guard)
    steal_timeout_s: float = 60.0   # drain-to-manifest wait bound
    ckpt_root: Optional[str] = None  # fallback checkpoint root: backend
                                    # K's manifests under <root>/<K> when
                                    # its status payload names no dir
    cache_dir: Optional[str] = None  # shared solve-cache dir (the same
                                    # --cache-dir the backends serve
                                    # from): the router consults it
                                    # read-only BEFORE placement — a
                                    # fleet-wide full hit is served at
                                    # the edge and never touches a
                                    # backend; a prefix hit prefers
                                    # cache-enabled backends so the
                                    # frontier is actually consumed
    inject: str = ""                # fleet fault spec (backend-down /
                                    # backend-slow; runtime/faults.py)
    retry_after_s: float = 1.0
    connect_timeout_s: float = 5.0
    stream_timeout_s: float = 600.0
    flightrec_dir: str = "."        # backend-loss flight dumps land here
    trace_buffer: int = trace_mod.DEFAULT_BUFFER
    quiet: bool = True
    # --- resilience layer (fleet/resilience.py) ---------------------------
    breaker_trip: int = 3           # consecutive errors that open the
                                    # per-backend circuit breaker
    breaker_cooldown_s: float = 5.0  # open -> half-open wait (doubles on
                                    # every failed canary, capped)
    breaker_burn_ticks: int = 8     # consecutive burn-demoted health
                                    # ticks that open the breaker
    retry_budget_cap: float = 20.0  # fleet retry-token bucket size
    retry_budget_ratio: float = 0.2  # tokens refilled per delivered
                                    # success (SRE retry budget: retries
                                    # capped as a fraction of successes)
    retry_backoff_s: float = 0.05   # base of the jittered exponential
                                    # backoff between re-placements
    hedge_factor: float = 0.0       # hedge an interactive row once it
                                    # waited factor x predicted service
                                    # time (0 = hedging off)
    hedge_floor_s: float = 0.75     # minimum wait before any hedge (a
                                    # cold predictor must not duplicate
                                    # every row)
    cut_redrive_wait_s: float = 3.0  # after a mid-stream cut against a
                                    # LIVE backend: how long to poll it
                                    # for terminal records before
                                    # re-dispatching elsewhere


class Router:
    """The long-running fleet front-end over a :class:`BackendRegistry`.

    >>> reg = BackendRegistry(parse_backends("127.0.0.1:8001,127.0.0.1:8002"))
    >>> rt = Router(reg, "127.0.0.1", 0).start()
    >>> rt.address
    >>> rt.close()
    """

    def __init__(self, registry: BackendRegistry, host: str = "127.0.0.1",
                 port: int = 0, fcfg: Optional[FleetConfig] = None):
        self.registry = registry
        self.fcfg = fcfg or FleetConfig()
        if self.fcfg.policy not in placement.POLICIES:
            raise ValueError(f"unknown placement policy "
                             f"{self.fcfg.policy!r}; known: "
                             f"{placement.POLICIES}")
        self.tracer = trace_mod.Tracer(capacity=self.fcfg.trace_buffer)
        self._plan = faults.plan_for_spec(self.fcfg.inject)
        # fleet-tier solve cache: READ-ONLY over the shared --cache-dir
        # the backends publish into (the router never writes entries;
        # ownership of publish/evict/quarantine stays with the engines)
        self.solvecache = None
        self._edge_ledger = prof_mod.UsageLedger()
        if self.fcfg.cache_dir:
            from ..serve.solvecache import SolveCache

            self.solvecache = SolveCache(self.fcfg.cache_dir,
                                         readonly=True)
        self._lock = threading.Lock()   # rank: fleet (outermost)
        # retry budget + per-backend breakers are self-locked at the
        # same fleet rank: their METHODS are only ever called while
        # holding no other fleet lock (the dict get-or-create below is
        # the one thing the router lock guards)
        self._budget = resilience.RetryBudget(self.fcfg.retry_budget_cap,
                                              self.fcfg.retry_budget_ratio)
        # --- under self._lock -------------------------------------------
        self._requests: Dict[str, dict] = {}   # rid -> routing state
        self._live_relays: Dict[str, set] = {}  # backend -> relay sockets
        self._recovering: Set[str] = set()     # backends mid-recovery/steal
        self._steals: List[dict] = []          # steal event log (statusz)
        self._breakers: Dict[str, resilience.Breaker] = {}
        self._forwards = 0                     # chaos counter (backend-down@N)
        self._rr = 0                           # round-robin tiebreak clock
        self._duplicates = 0
        self._edge_rejected = 0
        self._cache_edge_hits = 0
        self._cache_prefix_hints = 0
        self._retries = 0
        self._lost = 0
        self._deadline_shed = 0
        self._brownout_shed = 0
        self._stream_cuts = 0
        self._hedges = {"fired": 0, "won": 0, "lost": 0, "cancelled": 0}
        self._canary_seq = 0
        self._draining = False
        self._last_steal_t = 0.0
        self._last_breaker_transition_t = 0.0
        # -----------------------------------------------------------------
        self.httpd = ThreadingHTTPServer((host, port), _FleetHandler)
        self.httpd.daemon_threads = True
        self.httpd.router = self
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._health: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "Router":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True,
                                        name="heat-tpu-torch-fleet-http")
        self._thread.start()
        self._health = threading.Thread(target=self._health_loop,
                                        daemon=True,
                                        name="heat-tpu-torch-fleet-health")
        self._health.start()
        return self

    def request_drain(self) -> None:
        """Stop admission (healthz flips 503; new solves get 503). The
        backends are independent processes and are NOT drained — drain
        them individually, or steal their work first."""
        with self._lock:
            self._draining = True

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def pending_count(self) -> int:
        with self._lock:
            return sum(1 for st in self._requests.values()
                       if not st["delivered"])

    def close(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()

    # --- HTTP client helpers ----------------------------------------------
    def _conn(self, backend, timeout: float) -> http.client.HTTPConnection:
        if backend.fault_down:
            raise ConnectionRefusedError(
                f"injected backend-down: {backend.name}")
        if self._plan is not None:
            ms = self._plan.backend_partition_ms(backend.name)
            if ms is not None:
                # backend-partition chaos: the host is alive but the
                # network to it black-holes — every connect hangs for
                # the partition latency, then times out
                time.sleep(ms / 1e3)
                raise TimeoutError(
                    f"injected backend-partition: {backend.name}")
        host, _, port = backend.address.rpartition(":")
        return http.client.HTTPConnection(host, int(port), timeout=timeout)

    def _http(self, backend, method: str, path: str, body=None,
              headers=(), timeout: Optional[float] = None
              ) -> Tuple[int, bytes]:
        conn = self._conn(backend,
                          timeout or self.fcfg.connect_timeout_s)
        try:
            conn.request(method, path, body=body, headers=dict(headers))
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    # --- edge admission + placement ---------------------------------------
    def admit_lines(self, body: bytes, client_q: Optional[queue_lib.Queue],
                    trace_id: str) -> Tuple[List[dict], List[dict]]:
        """Parse NDJSON lines at the edge. Returns ``(immediate,
        accepted_states)``: per-line rejection records that never travel,
        and the routing-state dicts registered for the valid rows (not
        yet dispatched — the handler calls :meth:`dispatch` next, after
        it has sent response headers for the 202 path)."""
        immediate, states = [], []
        now = time.monotonic()
        for line in body.decode("utf-8", "replace").splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                obj = json.loads(line)
                row = parse_request_obj(obj)
            except Exception as e:  # noqa: BLE001 — per-line record
                immediate.append({"id": None, "status": "rejected",
                                  "error": f"{type(e).__name__}: {e}"})
                continue
            if row.error is not None:
                immediate.append({"id": row.id, "status": "rejected",
                                  "error": row.error})
                continue
            st = {"id": row.id, "line": obj, "n": int(row.cfg.n),
                  "steps": int(row.cfg.ntime), "backend": None,
                  "tried": [], "delivered": False, "rec": None,
                  "q": client_q, "t0": now, "trace_id": trace_id,
                  "cfg": row.cfg, "until": row.until,
                  "tenant": row.tenant or "default",
                  "class": row.slo_class or "standard",
                  # edge-minted deadline: the monotonic instant this
                  # row's budget expires; decremented per hop/retry via
                  # X-Deadline-Ms so no backend starts expired work
                  "deadline_t": (now + row.deadline_ms / 1e3
                                 if row.deadline_ms else None),
                  "hedged": False, "hedge_backend": None,
                  "dispatch_t": None, "expect_s": None}
            with self._lock:
                if row.id in self._requests:
                    self._edge_rejected += 1
                    immediate.append(
                        {"id": row.id, "status": "rejected",
                         "error": f"duplicate request id {row.id!r} "
                                  f"(already routed by this fleet)"})
                    continue
                self._requests[row.id] = st
            states.append(st)
        with self._lock:
            self._edge_rejected += len(
                [r for r in immediate if r["status"] == "rejected"])
        return immediate, states

    def _choose(self, n: Optional[int], exclude: Set[str], prefer=None):
        # an OPEN breaker excludes its backend from placement outright;
        # half-open admits exactly the canary, which bypasses _choose
        blocked = self._breaker_blocked()
        backends = [b for b in self.registry.snapshot()
                    if b.name not in exclude and b.name not in blocked]
        with self._lock:
            self._rr += 1
            rr = self._rr
        return placement.choose(self.fcfg.policy, backends, n, rr,
                                prefer=prefer)

    # --- fleet-tier solve cache -------------------------------------------
    def _cache_backends(self) -> Set[str]:
        """Backends whose status payload says the solve cache is on —
        the only ones that can consume a cached frontier."""
        return {b.name for b in self.registry.snapshot()
                if (b.status or {}).get("cache") is not None}

    def _consult_cache(self, states: List[dict]) -> List[dict]:
        """Consult the shared solve cache BEFORE placement. A fleet-wide
        full hit is served right here at the edge (zero backends
        touched, billed cached in the router's edge ledger); a prefix
        hit tags the state so placement prefers a cache-enabled backend
        (the one holding the snapshot). Returns the states that still
        need a backend."""
        if self.solvecache is None:
            return states
        remaining = []
        for st in states:
            cfg = st.get("cfg")
            if cfg is None or st.get("until", "steps") != "steps":
                remaining.append(st)
                continue
            try:
                hit = self.solvecache.lookup(cfg)
            except OSError:
                hit = None   # a flaky shared mount must not stop routing
            if hit is not None and hit["kind"] == "full":
                if self._serve_edge_hit(st, cfg, hit):
                    continue
                remaining.append(st)
            else:
                if hit is not None:
                    with self._lock:
                        st["prefer_cached"] = True
                        self._cache_prefix_hints += 1
                remaining.append(st)
        return remaining

    def _serve_edge_hit(self, st: dict, cfg, hit: dict) -> bool:
        """Deliver a fleet-wide full hit at the edge: a synthesized
        terminal record pointing at the validated cache entry, billed
        cached (zero lane-seconds/steps) in the router's edge ledger so
        ``/v1/usage`` reconciles fleet-wide."""
        rec = {"event": "serve_request", "id": st["id"], "status": "ok",
               "exit": "cached", "cached": True,
               "tenant": st["tenant"], "class": st["class"],
               "n": int(cfg.n), "ndim": int(cfg.ndim),
               "ntime": int(cfg.ntime), "until": "steps", "error": None,
               "solve_s": 0.0, "steps_done": int(cfg.ntime),
               "steps_per_s": None, "path": hit["path"],
               "placement": "fleet-cache", "trace_id": st["trace_id"],
               "usage": {"lane_s": 0.0, "steps": 0, "chunks": 0,
                         "bytes_written": int(hit["nbytes"]),
                         "steps_saved": int(cfg.ntime), "cached": True}}
        if not self._deliver(st["id"], rec, backend=None):
            return False
        self._edge_ledger.add(st["tenant"], st["class"], "ok",
                              rec["usage"], placement="fleet-cache")
        with self._lock:
            self._cache_edge_hits += 1
        json_record("fleet_cache_hit", id=st["id"], step=hit["step"],
                    path=hit["path"])
        if self.tracer.enabled:
            self.tracer.instant(
                "cache-hit", self.tracer.track("fleet router",
                                               "placement"),
                cat="fleet", args={"id": st["id"], "step": hit["step"]})
        return True

    def _chaos_forward(self, chosen_name: str) -> None:
        """backend-down@N / backend-slow chaos, one call per forwarded
        request (strictly opt-in: None plan = one falsy test)."""
        if self._plan is None:
            return
        self._plan.backend_slow()
        with self._lock:
            self._forwards += 1
            nth = self._forwards
        target = self._plan.backend_down_target(nth)
        if target is not None:
            victim = target or chosen_name
            self.registry.set_fault_down(victim)
            json_record("fleet_backend_down_injected", backend=victim,
                        at_forward=nth)
            self._close_relays(victim)

    def dispatch(self, states: List[dict]) -> None:
        """Place every state on a backend and spawn one relay per
        (backend, batch). States that cannot be placed anywhere get a
        terminal rejection record delivered locally."""
        batches: Dict[str, List[dict]] = {}
        addr: Dict[str, str] = {}
        states = self._consult_cache(states)
        now = time.monotonic()
        level = placement.brownout_level(self.registry.snapshot())
        for st in states:
            with self._lock:
                tried = set(st["tried"])
                prefer_cached = st.get("prefer_cached", False)
                dt = st["deadline_t"]
            if dt is not None and now > dt:
                self._shed_deadline(st, "placement")
                continue
            if level and self._shed_brownout(st, level):
                continue
            b, decision = self._choose(
                st["n"], tried,
                prefer=self._cache_backends() if prefer_cached else None)
            if b is None:
                self._reject_unroutable(st, decision.get("reason",
                                                         "no-backend"))
                continue
            self._chaos_forward(b.name)
            if b.fault_down:   # the chaos drill just dropped OUR target
                b2, _ = self._choose(st["n"], tried | {b.name})
                if b2 is None:
                    self._reject_unroutable(st, "no-backend-after-fault")
                    continue
                b = b2
            # the hedge trigger's expectation: predicted queue wait plus
            # this row's own service time on the chosen backend — an
            # advisory read of registry-guarded fields, so it stays a
            # bare read OUTSIDE the router lock (registry.snapshot doc)
            expect = (placement.predicted_backlog_s(b)
                      + st["steps"] * placement.s_per_lane_step(b.status))
            with self._lock:
                st["backend"] = b.name
                st["dispatch_t"] = time.monotonic()
                st["expect_s"] = expect
            if self.tracer.enabled:
                self.tracer.instant(
                    "placed", self.tracer.track("fleet router", "placement"),
                    cat="fleet", args={"id": st["id"], **decision})
            batches.setdefault(b.name, []).append(st)
            addr[b.name] = b.address
        for name, sts in batches.items():
            self.registry.note_routed(name, len(sts),
                                      sum(s["steps"] for s in sts))
            threading.Thread(
                target=self._relay, args=(name, addr[name], sts),
                daemon=True, name=f"heat-tpu-torch-fleet-relay-{name}").start()

    def _reject_unroutable(self, st: dict, why: str) -> None:
        rec = {"id": st["id"], "status": "rejected",
               "error": f"unroutable: no eligible backend ({why}); "
                        f"the fleet is down or nothing can serve "
                        f"n={st['n']}"}
        self._deliver(st["id"], rec, backend=None)

    # --- relays -----------------------------------------------------------
    def _relay(self, name: str, address: str, sts: List[dict]) -> None:
        """Forward one batch as a streaming POST /v1/solve and pump the
        backend's chunked record lines into delivery. A failure BEFORE
        admission (connect error, 503, 429, non-200) retries the batch
        on an alternate backend; a break MID-stream hands the
        undelivered rows to checkpoint recovery."""
        b = self.registry.get(name)
        if b is None:
            for st in sts:
                self._reject_unroutable(st, f"backend {name} vanished")
            return
        # deadline propagation: rewrite each row's budget to what is
        # LEFT of the edge-minted one (hops and retries ate the rest),
        # shedding rows that arrive at this hop already spent
        now = time.monotonic()
        live, expired = [], []
        min_remaining_ms: Optional[float] = None
        with self._lock:
            for st in sts:
                dt = st["deadline_t"]
                if dt is None:
                    live.append(st)
                    continue
                remaining_ms = (dt - now) * 1e3
                if remaining_ms < 1.0:
                    expired.append(st)
                    continue
                st["line"] = dict(st["line"],
                                  deadline_ms=round(remaining_ms, 3))
                live.append(st)
                min_remaining_ms = (remaining_ms
                                    if min_remaining_ms is None
                                    else min(min_remaining_ms,
                                             remaining_ms))
        if expired:
            self.registry.note_unrouted(name, len(expired),
                                        sum(s["steps"] for s in expired))
            for st in expired:
                self._shed_deadline(st, f"relay to {name}")
        sts = live
        if not sts:
            return
        body = ("\n".join(json.dumps(st["line"], sort_keys=True)
                          for st in sts) + "\n").encode()
        headers = {"Content-Type": "application/x-ndjson",
                   "X-Trace-Id": sts[0]["trace_id"]}
        if min_remaining_ms is not None:
            headers["X-Deadline-Ms"] = f"{min_remaining_ms:.3f}"
        tr = self.tracer
        fwd_track = (tr.track(f"backend {name}", "forward")
                     if tr.enabled else None)
        t0 = time.perf_counter()
        try:
            conn = self._conn(b, self.fcfg.stream_timeout_s)
            conn.request("POST", "/v1/solve", body=body, headers=headers)
            sock = conn.sock
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            self._retry_batch(name, sts, f"connect: {type(e).__name__}: {e}")
            return
        if resp.status != 200:
            reason = f"http {resp.status}"
            try:
                resp.read()
            except (OSError, http.client.HTTPException):
                pass
            conn.close()
            if resp.status == 504:
                # the backend judged the propagated deadline spent
                # before admission: terminal, not retryable — more hops
                # only burn more of a budget that is already gone
                self.registry.note_unrouted(name, len(sts),
                                            sum(s["steps"]
                                                for s in sts))
                for st in sts:
                    self._shed_deadline(st, f"backend {name} admission")
                return
            # 503 = draining, 429 = every line shed, anything else =
            # it never streamed: none of these admitted the work
            self._retry_batch(name, sts, reason,
                              overloaded=(resp.status == 429))
            return
        if tr.enabled:
            tr.complete(f"forward x{len(sts)}", fwd_track, t0, cat="rpc",
                        args={"backend": name, "requests": len(sts)})
        with self._lock:
            self._live_relays.setdefault(name, set()).add(sock)
        broke = False
        nrecords = 0
        try:
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                rid = rec.get("id")
                if rid is not None:
                    self._deliver(rid, rec, backend=name)
                    nrecords += 1
                if (self._plan is not None
                        and self._plan.stream_cut_fire(name, nrecords)):
                    # stream-cut chaos: the relay connection dies after
                    # N records while the backend stays healthy — the
                    # hardened exactly-once re-drive path below
                    json_record("fleet_stream_cut", backend=name,
                                after=nrecords)
                    broke = True
                    break
        except (OSError, ValueError, http.client.HTTPException):
            # a socket shut down by _close_relays ends the chunked body
            # early: the mid-stream break the steal path engineers
            broke = True
        finally:
            with self._lock:
                live = self._live_relays.get(name)
                if live is not None:
                    live.discard(sock)
            try:
                conn.close()
            except OSError:
                pass
        with self._lock:
            missing = [st for st in sts
                       if not st["delivered"] and st["backend"] == name]
            recovering = name in self._recovering
        if missing and not recovering:
            # stream ended without every record. If the backend still
            # answers /healthz the CONNECTION died, not the backend
            # (stream-cut chaos, a proxy hiccup): its admitted rows are
            # still computing there, so take the bounded re-drive path.
            # Only a genuinely dead backend pays for checkpoint
            # recovery.
            why = "relay-" + ("broke" if broke else "eof")
            if self._backend_alive(name):
                with self._lock:
                    self._stream_cuts += 1
                self._redrive_after_cut(name, missing, why)
            else:
                self._recover_backend(name, why)

    def _retry_batch(self, name: str, sts: List[dict], why: str,
                     overloaded: bool = False) -> None:
        """Never-admitted rows: re-place on alternates (the retry
        counter is per batch hop, so statusz shows the churn)."""
        self.registry.note_retry(name)
        self.registry.note_unrouted(name, len(sts),
                                    sum(s["steps"] for s in sts))
        if not overloaded:
            # a 429 is a LOAD signal, not a backend fault: the retry
            # budget handles it; breakers only trip on real errors
            self._breaker_event(
                name, self._breaker(name).note_error(why,
                                                     time.monotonic()),
                why)
        with self._lock:
            self._retries += 1
            for st in sts:
                st["tried"].append(name)
                st["backend"] = None
            hops = max(len(st["tried"]) for st in sts)
        json_record("fleet_retry", backend=name, requests=len(sts),
                    why=why)
        if not self._budget.take():
            # SRE retry budget: retries are capped as a fraction of
            # successes — a dry bucket means the fleet is amplifying
            # its own overload, so shed instead of re-dispatching
            json_record("fleet_retry_budget_exhausted", backend=name,
                        requests=len(sts))
            for st in sts:
                self._deliver(st["id"],
                              {"id": st["id"], "status": "rejected",
                               "error": "overloaded: fleet retry "
                                        "budget exhausted; retry "
                                        "later"}, backend=None)
            return
        # jittered exponential backoff before re-placement (full
        # jitter decorrelates a retry herd without coordination)
        time.sleep(resilience.backoff_s(hops - 1,
                                        self.fcfg.retry_backoff_s))
        # registry snapshot BEFORE taking the router lock: both locks
        # rank "fleet" and same-rank locks must never nest
        alive = {b.name for b in self.registry.snapshot()
                 if not b.lost and not b.fault_down}
        remaining = []
        for st in sts:
            with self._lock:
                exhausted = alive <= set(st["tried"])
            if exhausted:
                err = ("overloaded: every backend shed this request; "
                       "retry later" if overloaded else
                       f"unroutable: every backend refused ({why})")
                self._deliver(st["id"],
                              {"id": st["id"], "status": "rejected",
                               "error": err}, backend=None)
            else:
                remaining.append(st)
        if remaining:
            self.dispatch(remaining)

    def _close_relays(self, name: str) -> None:
        """Break every live relay stream to ``name`` (steal or injected
        drop): shutting the socket down ends the relay thread's read at
        once, and the thread routes its undelivered rows into recovery.
        (Closing the response instead, as the reference does, waits for
        the lock of the buffered reader the relay is parked in, so until
        the backend's next byte: up to the stream timeout when none
        comes.)"""
        with self._lock:
            live = list(self._live_relays.get(name, ()))
        for sock in live:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    # --- resilience: breakers, canaries, shedding, hedging ----------------
    def _breaker(self, name: str) -> resilience.Breaker:
        """Get-or-create the per-backend breaker. Only the dict op is
        under the router lock — Breaker methods self-lock at the same
        fleet rank, so callers invoke them after release."""
        with self._lock:
            br = self._breakers.get(name)
            if br is None:
                br = resilience.Breaker(
                    name, trip_threshold=self.fcfg.breaker_trip,
                    cooldown_s=self.fcfg.breaker_cooldown_s,
                    burn_trip_ticks=self.fcfg.breaker_burn_ticks)
                self._breakers[name] = br
        return br

    def _breaker_blocked(self) -> Set[str]:
        """Backends whose breaker refuses new placements right now."""
        with self._lock:
            brs = list(self._breakers.values())
        return {br.backend for br in brs if not br.allows()}

    def _breaker_event(self, name: str, new_state: Optional[str],
                       reason: str) -> None:
        """Record a breaker transition (None = the feed didn't trip
        anything): structured record, trace instant, and the timestamp
        the steal loop's thrash guard keys on."""
        if new_state is None:
            return
        with self._lock:
            self._last_breaker_transition_t = time.monotonic()
        json_record("fleet_breaker_transition", backend=name,
                    state=new_state, reason=reason)
        if self.tracer.enabled:
            self.tracer.instant(
                f"breaker {new_state}",
                self.tracer.track("fleet router", "resilience"),
                cat="fleet", args={"backend": name, "reason": reason})
        master_print(f"fleet: breaker[{name}] -> {new_state} ({reason})")

    def _canary_sweep(self, now: float) -> None:
        """Move cooled-down open breakers to half-open and launch one
        router-path canary each (the breaker holds the single slot)."""
        with self._lock:
            brs = list(self._breakers.values())
        for br in brs:
            if br.try_half_open(now):
                self._breaker_event(br.backend, resilience.HALF_OPEN,
                                    "cooldown-elapsed")
                threading.Thread(
                    target=self._run_canary, args=(br.backend,),
                    daemon=True,
                    name=f"heat-tpu-torch-fleet-canary-{br.backend}").start()

    def _run_canary(self, name: str) -> None:
        """Half-open re-admission: run the sine canary THROUGH the
        router's forward path against the suspect backend and verify
        the returned field against the closed-form answer. /healthz
        alone is not enough — a backend that answers health checks but
        serves wrong bytes stays out. A pass closes the breaker AND
        clears ``lost`` (mark_found); a failure doubles the cooldown."""
        b = self.registry.get(name)
        ok = (b is not None and not b.fault_down and not b.draining
              and self._canary_solve(b))
        state = self._breaker(name).canary_result(ok, time.monotonic())
        self._breaker_event(name, state,
                            "canary-pass" if ok else "canary-fail")
        if ok:
            self.registry.mark_found(name)
            json_record("fleet_breaker_readmit", backend=name)

    def _canary_solve(self, b) -> bool:
        """One end-to-end known-answer solve against backend ``b``
        (serve/probe.py's contract: ``_probe`` tenant, batch class,
        field fetched back and compared in f64 max-norm)."""
        import numpy as np

        from ..serve import probe as probe_mod

        with self._lock:
            self._canary_seq += 1
            rid = f"_breaker-canary-{b.name}-{self._canary_seq:04d}"
        req = dict(probe_mod.DEFAULT_PROBE_REQUEST, id=rid,
                   tenant=probe_mod.PROBE_TENANT, **{"class": "batch"})
        try:
            code, data = self._http(
                b, "POST", "/v1/solve",
                body=(json.dumps(req) + "\n").encode(),
                headers={"Content-Type": "application/x-ndjson"},
                timeout=self.fcfg.stream_timeout_s)
            if code != 200:
                return False
            rec = None
            for line in data.decode("utf-8", "replace").splitlines():
                if line.strip():
                    cand = json.loads(line)
                    if cand.get("id") == rid:
                        rec = cand
            if rec is None or rec.get("status") != "ok":
                return False
            code, data = self._http(b, "GET",
                                    f"/v1/requests/{rid}?field=1")
            if code != 200:
                return False
            T = json.loads(data).get("T")
            if T is None:
                return False
            err = float(np.max(np.abs(
                np.asarray(T, dtype=np.float64)
                - probe_mod.expected_probe_field(req))))
            return err <= probe_mod.PROBE_TOL[req["dtype"]]
        except (OSError, ValueError, KeyError,
                http.client.HTTPException):
            return False

    def _shed_deadline(self, st: dict, where: str) -> None:
        """Terminal ``deadline`` record minted at the edge: the row's
        propagated budget is spent, so it never starts (zero device
        steps billed to the tenant)."""
        rec = {"id": st["id"], "status": "deadline",
               "tenant": st["tenant"], "class": st["class"],
               "error": f"deadline: edge-minted budget exhausted at "
                        f"{where}; the request never started there "
                        f"(zero device steps billed)"}
        with self._lock:
            self._deadline_shed += 1
        json_record("fleet_deadline_shed", id=st["id"],
                    slo_class=st["class"], where=where)
        self._deliver(st["id"], rec, backend=None)

    def _shed_brownout(self, st: dict, level: int) -> bool:
        """Brownout degradation: when EVERY eligible backend's fast AND
        slow burn windows fire, shed by class at the edge — batch first
        (level 1), then standard too (level 2); interactive is never
        shed. Replaces the old all-burn behaviour for these classes
        (demotion disabled, work placed anyway): shedding the deferrable
        classes gives every replica headroom to recover."""
        cls = st["class"]
        if cls == "interactive" or (level < 2 and cls != "batch"):
            return False
        rec = {"id": st["id"], "status": "rejected",
               "tenant": st["tenant"], "class": cls,
               "error": f"brownout: every backend is burning SLO "
                        f"budget in both windows; {cls} admission "
                        f"shed at the edge (level {level})",
               "retry_after_s": self.fcfg.retry_after_s}
        with self._lock:
            self._brownout_shed += 1
        json_record("fleet_brownout_shed", id=st["id"], slo_class=cls,
                    level=level)
        self._deliver(st["id"], rec, backend=None)
        return True

    def _backend_alive(self, name: str) -> bool:
        """Quick liveness check for the stream-cut path: is the backend
        still answering /healthz after its relay stream broke?"""
        b = self.registry.get(name)
        if b is None or b.lost or b.fault_down:
            return False
        try:
            code, _ = self._http(b, "GET", "/healthz")
        except (OSError, http.client.HTTPException):
            return False
        return code == 200

    def _redrive_after_cut(self, name: str, missing: List[dict],
                           why: str) -> None:
        """Mid-stream break against a LIVE backend (stream-cut chaos, a
        proxy hiccup): the rows were already admitted there, so poll
        that same backend for their terminal records first — recomputing
        elsewhere would waste device steps. Rows still unfinished after
        the bounded wait re-dispatch on a survivor; the exactly-once
        chokepoint keeps the client stream duplicate-free either way,
        reconciled against any manifest adoption racing this."""
        json_record("fleet_stream_redrive", backend=name,
                    rows=len(missing), why=why)
        pending = {st["id"]: st for st in missing}
        deadline = time.monotonic() + self.fcfg.cut_redrive_wait_s
        while pending and time.monotonic() < deadline:
            b = self.registry.get(name)
            if b is None or b.lost or b.fault_down:
                break
            for rid in sorted(pending):
                try:
                    code, data = self._http(b, "GET",
                                            f"/v1/requests/{rid}")
                except (OSError, http.client.HTTPException):
                    break
                if code != 200:
                    continue
                try:
                    rec = json.loads(data)
                except ValueError:
                    continue
                if rec.get("status") in TERMINAL_STATUSES:
                    pending.pop(rid)
                    self._deliver(rid, rec, backend=name)
            if self._stop.wait(0.1):
                break
        leftovers = [st for st in pending.values()]
        if not leftovers:
            return
        self.registry.note_unrouted(name, len(leftovers),
                                    sum(s["steps"] for s in leftovers))
        with self._lock:
            for st in leftovers:
                st["tried"].append(name)
                st["backend"] = None
        self.dispatch(leftovers)

    def _maybe_hedge(self, now: float) -> None:
        """Tail-latency hedging (Dean & Barroso, "The Tail at Scale"):
        an interactive row that has waited past ``hedge_factor`` x its
        predicted service time (+ floor) is duplicated onto a second
        breaker-closed backend. The first terminal record wins at the
        exactly-once chokepoint; the loser is deadline-preempted at its
        next chunk boundary via POST /v1/cancel."""
        with self._lock:
            cands = [st for st in self._requests.values()
                     if (not st["delivered"] and not st["hedged"]
                         and st["class"] == "interactive"
                         and st["backend"] is not None
                         and st["dispatch_t"] is not None
                         and now - st["dispatch_t"]
                         > self.fcfg.hedge_factor * (st["expect_s"] or 0)
                         + self.fcfg.hedge_floor_s)]
        for st in cands:
            with self._lock:
                if st["hedged"] or st["delivered"]:
                    continue
                primary = st["backend"]
                tried = set(st["tried"])
            if primary is None:
                continue
            b, _ = self._choose(st["n"], tried | {primary})
            if b is None:
                continue   # nowhere to hedge to — the primary stands
            with self._lock:
                if st["hedged"] or st["delivered"]:
                    continue
                st["hedged"] = True
                st["hedge_backend"] = b.name
                self._hedges["fired"] += 1
            json_record("fleet_hedge", id=st["id"], primary=primary,
                        hedge=b.name)
            if self.tracer.enabled:
                self.tracer.instant(
                    "hedge-fired",
                    self.tracer.track("fleet router", "resilience"),
                    cat="fleet", args={"id": st["id"],
                                       "primary": primary,
                                       "hedge": b.name})
            self.registry.note_routed(b.name, 1, st["steps"])
            threading.Thread(
                target=self._hedge_relay, args=(st, b.name), daemon=True,
                name=f"heat-tpu-torch-fleet-hedge-{b.name}").start()

    def _hedge_relay(self, st: dict, name: str) -> None:
        """Forward the hedge twin (id suffixed ``~hedge``, reserved
        tenant ``_hedge`` so per-backend ledgers attribute the duplicate
        cost — the real tenant is billed once, on the primary) and
        promote its record to the primary id iff it finishes ok; the
        exactly-once chokepoint settles the race with the primary."""
        rid = st["id"]
        hid = f"{rid}~hedge"
        with self._lock:
            line = dict(st["line"])
            dt = st["deadline_t"]
            steps = st["steps"]
        line["id"] = hid
        line["tenant"] = "_hedge"
        if dt is not None:
            line["deadline_ms"] = max(1.0,
                                      (dt - time.monotonic()) * 1e3)
        won = False
        b = self.registry.get(name)
        try:
            conn = self._conn(b, self.fcfg.stream_timeout_s)
            conn.request(
                "POST", "/v1/solve",
                body=(json.dumps(line, sort_keys=True) + "\n").encode(),
                headers={"Content-Type": "application/x-ndjson",
                         "X-Trace-Id": st["trace_id"]})
            resp = conn.getresponse()
            if resp.status == 200:
                while True:
                    raw = resp.readline()
                    if not raw:
                        break
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        rec = json.loads(raw)
                    except ValueError:
                        continue
                    if (rec.get("id") == hid
                            and rec.get("status") in TERMINAL_STATUSES):
                        # only an OK twin may speak for the primary id:
                        # a cancelled/failed hedge must never mask a
                        # primary that is still computing
                        if rec.get("status") == "ok":
                            rec2 = dict(rec, id=rid,
                                        tenant=st["tenant"], hedged=True)
                            won = self._deliver(rid, rec2, backend=name)
                        break
            else:
                resp.read()
            conn.close()
        except (OSError, ValueError, http.client.HTTPException):
            pass
        if not won:
            # the twin lost (or never finished): reverse its pending
            # accounting — note_done ran for the winner only
            self.registry.note_unrouted(name, 1, steps)
            with self._lock:
                self._hedges["lost"] += 1

    def _cancel_loser(self, rid: str, winner: str, primary: str,
                      hedge_backend: str, steps: int) -> None:
        """Deadline-preempt the losing side of a hedged pair at its
        next chunk boundary (POST /v1/cancel) so it stops burning
        device time, and settle the accounting for a hedge win."""
        if winner == hedge_backend:
            loser, lrid = primary, rid
            self.registry.note_unrouted(primary, 1, steps)
            with self._lock:
                self._hedges["won"] += 1
        else:
            loser, lrid = hedge_backend, f"{rid}~hedge"
        lb = self.registry.get(loser)
        if lb is None:
            return
        try:
            code, data = self._http(
                lb, "POST", "/v1/cancel",
                body=json.dumps({"id": lrid}).encode(),
                headers={"Content-Type": "application/json"})
            if code == 200 and json.loads(data).get("cancelled"):
                with self._lock:
                    self._hedges["cancelled"] += 1
        except (OSError, ValueError, http.client.HTTPException):
            pass

    # --- delivery (exactly-once) ------------------------------------------
    def _deliver(self, rid: str, rec: dict,
                 backend: Optional[str]) -> bool:
        """The single exactly-once chokepoint: the first terminal record
        for a request id wins; every later one (re-driven work finishing
        twice, a poller racing a relay) is dropped and counted."""
        with self._lock:
            st = self._requests.get(rid)
            if st is None:
                return False   # not router-tracked (direct-to-backend)
            if st["delivered"]:
                self._duplicates += 1
                return False
            st["delivered"] = True
            st["rec"] = rec
            q = st["q"]
            steps = st["steps"]
            hedged = st["hedged"]
            hedge_backend = st["hedge_backend"]
            primary = st["backend"]
        if backend is not None:
            self.registry.note_done(backend, steps)
            self._breaker(backend).note_success()
            if rec.get("status") == "ok":
                self._budget.credit()
            if hedged and hedge_backend is not None:
                # the other side of the hedged pair is still computing:
                # deadline-preempt it and settle the accounting (the
                # loser's eventual record lands here as a duplicate)
                threading.Thread(
                    target=self._cancel_loser,
                    args=(rid, backend, primary, hedge_backend, steps),
                    daemon=True,
                    name=f"heat-tpu-torch-fleet-unhedge-{rid}").start()
        tr = self.tracer
        if tr.enabled and backend is not None:
            t1 = tr.now()
            solve_s = rec.get("solve_s") or 0.0
            tid = rec.get("trace_id")
            track = tr.track(f"backend {backend}", "solve")
            tr.complete(str(rid), track, t1 - float(solve_s), t1,
                        cat="serve", trace_id=tid,
                        args={"status": rec.get("status")})
            if tid:
                tr.flow("f", track, tid)
        if q is not None:
            q.put(rec)
        return True

    # --- health + imbalance ----------------------------------------------
    def _health_loop(self) -> None:
        while not self._stop.wait(self.fcfg.health_interval_s):
            self._health_tick()

    def _health_tick(self) -> None:
        self.registry.refresh_file()
        now = time.monotonic()
        if self._plan is not None:
            # backend-flap chaos: square-wave the fault_down bit so the
            # router DISCOVERS each edge through its own probes
            for bname, down in self._plan.backend_flap_states(
                    now).items():
                fb = self.registry.get(bname)
                if fb is None or fb.fault_down == down:
                    continue
                self.registry.set_fault_down(bname, down)
                json_record("fleet_backend_flap", backend=bname,
                            down=down)
                if down:
                    self._close_relays(bname)
        for b in self.registry.snapshot():
            if b.lost:
                # re-admission goes exclusively through the breaker's
                # half-open canary (the sweep below), never a bare probe
                continue
            ok, draining, status = False, False, None
            if not b.fault_down:
                try:
                    code, _ = self._http(b, "GET", "/healthz")
                    draining = code == 503
                    ok = code == 200
                    if ok:
                        scode, sbody = self._http(b, "GET", "/v1/status")
                        if scode == 200:
                            status = json.loads(sbody)
                except (OSError, ValueError,
                        http.client.HTTPException):
                    ok = False
            was, is_now = self.registry.note_probe(
                b.name, ok, draining=draining, status=status, now=now)
            br = self._breaker(b.name)
            if ok:
                br.note_success()
            else:
                self._breaker_event(b.name,
                                    br.note_error("probe", now), "probe")
            self._breaker_event(
                b.name,
                br.note_burn(placement.burn_demoted(status), now),
                "slo-burn")
            if was and not is_now and not draining:
                # hard down transition (connect failure / 500 / chaos):
                # recover its orphans; a 503-draining backend still
                # finishes its in-flight work, so only placement stops
                threading.Thread(
                    target=self._recover_backend,
                    args=(b.name, "health-probe"), daemon=True,
                    name=f"heat-tpu-torch-fleet-recover-{b.name}").start()
        self._canary_sweep(now)
        if self.fcfg.hedge_factor > 0:
            self._maybe_hedge(now)
        if self.fcfg.steal_threshold_s > 0:
            self._maybe_steal(now)

    def _maybe_steal(self, now: float) -> None:
        with self._lock:
            if (self._recovering
                    or now - self._last_steal_t
                    < self.fcfg.steal_cooldown_s
                    # breaker-aware cooldown: a breaker that just moved
                    # means the fleet is mid-incident — a steal now
                    # would thrash against a flapping backend
                    or (self._last_breaker_transition_t > 0
                        and now - self._last_breaker_transition_t
                        < self.fcfg.steal_cooldown_s)):
                return
        blocked = self._breaker_blocked()
        cands = [b for b in self.registry.snapshot()
                 if b.healthy and not b.lost and not b.fault_down
                 and b.name not in blocked]
        if len(cands) < 2:
            return
        scores = {b.name: placement.predicted_backlog_s(b) for b in cands}
        victim = max(cands, key=lambda b: scores[b.name])
        thief = min(cands, key=lambda b: scores[b.name])
        if (victim.name == thief.name
                or scores[victim.name] - scores[thief.name]
                < self.fcfg.steal_threshold_s
                or placement.backlog_steps(victim) <= 0):
            return
        with self._lock:
            self._last_steal_t = now
        threading.Thread(
            target=self.steal, args=(victim.name, thief.name),
            kwargs={"reason": "imbalance"}, daemon=True,
            name="heat-tpu-torch-fleet-steal").start()

    # --- checkpoint recovery + work stealing ------------------------------
    def _ckpt_dir(self, b) -> Optional[Path]:
        st = b.status or {}
        d = ((st.get("engine_ckpt") or {}).get("dir")
             or (Path(self.fcfg.ckpt_root) / b.name
                 if self.fcfg.ckpt_root else None))
        if d is None:
            return None
        d = Path(d)
        return d if d.is_dir() else None

    def _orphans_of(self, name: str) -> List[dict]:
        with self._lock:
            return [st for st in self._requests.values()
                    if st["backend"] == name and not st["delivered"]]

    def _adopt(self, victim: str, thief_b, detail: dict,
               orphans: List[dict]) -> Tuple[List[dict], List[dict]]:
        """Split a victim's orphans after a resume on ``thief_b``:
        manifest-covered ids are reassigned and polled there;
        everything else (including manifest-``done`` ids whose records
        died with the victim) re-drives fresh — the solver is
        deterministic, so either path produces identical bytes."""
        recovered = set(detail.get("recovered") or ())
        polled, redrive = [], []
        for st in orphans:
            if st["id"] in recovered:
                polled.append(st)
            else:
                redrive.append(st)
        moved_steps = sum(s["steps"] for s in polled + redrive)
        self.registry.note_unrouted(victim, len(polled) + len(redrive),
                                    moved_steps)
        with self._lock:
            for st in polled:
                st["tried"].append(victim)
                st["backend"] = thief_b.name
            for st in redrive:
                st["tried"].append(victim)
                st["backend"] = None
        if polled:
            self.registry.note_routed(thief_b.name, len(polled),
                                      sum(s["steps"] for s in polled))
            threading.Thread(
                target=self._poll_recovered,
                args=(thief_b.name, [st["id"] for st in polled]),
                daemon=True,
                name=f"heat-tpu-torch-fleet-poll-{thief_b.name}").start()
        if redrive:
            self.dispatch(redrive)
        return polled, redrive

    def _recover_backend(self, name: str, reason: str) -> None:
        """A backend is gone (probe failure, relay break, chaos drop):
        flight-dump the fleet timeline, resume its newest checkpoint
        manifest onto the least-loaded survivor, poll the resumed ids
        there, and re-drive whatever the manifest does not cover."""
        with self._lock:
            if name in self._recovering:
                return
            self._recovering.add(name)
            self._lost += 1
        try:
            self.registry.mark_lost(name)
            self._breaker_event(
                name, self._breaker(name).trip("lost", time.monotonic()),
                "lost")
            b = self.registry.get(name)
            master_print(f"fleet: backend {name} lost ({reason}) — "
                         f"recovering")
            json_record("fleet_backend_lost", backend=name, reason=reason)
            self.tracer.flight_dump(self.fcfg.flightrec_dir,
                                    f"backend {name} lost ({reason})")
            self._close_relays(name)
            orphans = self._orphans_of(name)
            detail: dict = {}
            d = self._ckpt_dir(b) if b is not None else None
            thief, _ = self._choose(None, {name})
            if d is not None and thief is not None:
                try:
                    code, data = self._http(
                        thief, "POST", "/v1/resume",
                        body=json.dumps({"dir": str(d)}).encode(),
                        headers={"Content-Type": "application/json"},
                        timeout=self.fcfg.steal_timeout_s)
                    if code == 200:
                        detail = json.loads(data)
                except (OSError, ValueError,
                        http.client.HTTPException) as e:
                    master_print(f"fleet: resume of {name}'s checkpoint "
                                 f"on {thief.name} failed ({e}) — "
                                 f"re-driving fresh")
            polled, redrive = self._adopt(
                name, thief, detail, orphans) if thief is not None \
                else ([], orphans)
            if thief is None:
                for st in redrive:
                    self._reject_unroutable(st, "fleet-exhausted")
            json_record("fleet_recovery", backend=name, reason=reason,
                        generation=detail.get("generation", 0),
                        recovered=len(polled), redriven=len(redrive))
        finally:
            with self._lock:
                self._recovering.discard(name)

    def steal(self, victim: str, thief: Optional[str] = None,
              reason: str = "forced") -> Optional[dict]:
        """Work stealing as checkpoint handoff: drain the victim to a
        checkpoint (``/drainz?handoff=1``), pick up the manifest
        generation from its checkpoint dir, resume it on the thief, and
        re-point the orphans. Returns the steal event dict (also on
        /statusz) or None if a recovery already owns the victim."""
        t0 = time.monotonic()
        with self._lock:
            if victim in self._recovering:
                return None
            self._recovering.add(victim)
        try:
            vb = self.registry.get(victim)
            if vb is None:
                return None
            gen_before = int(((vb.status or {}).get("engine_ckpt")
                              or {}).get("generation") or 0)
            d = self._ckpt_dir(vb)
            self.registry.mark_lost(victim)   # placement stops NOW; the
            # probe loop must not start a second, competing recovery
            try:
                self._http(vb, "POST", "/drainz?handoff=1",
                           timeout=self.fcfg.connect_timeout_s)
            except (OSError, http.client.HTTPException) as e:
                master_print(f"fleet: steal drain of {victim} failed "
                             f"({e}) — falling back to loss recovery")
            self._close_relays(victim)
            t_drain = time.monotonic()
            generation = 0
            if d is not None:
                deadline = t0 + self.fcfg.steal_timeout_s
                while time.monotonic() < deadline:
                    manifest, _ = ckpt_mod.latest_engine_manifest(d)
                    if (manifest is not None
                            and int(manifest["generation"]) > gen_before):
                        generation = int(manifest["generation"])
                        break
                    if self._stop.wait(0.1):
                        break
            tb = (self.registry.get(thief) if thief
                  else self._choose(None, {victim})[0])
            detail: dict = {}
            if generation and tb is not None:
                try:
                    code, data = self._http(
                        tb, "POST", "/v1/resume",
                        body=json.dumps({"dir": str(d)}).encode(),
                        headers={"Content-Type": "application/json"},
                        timeout=self.fcfg.steal_timeout_s)
                    if code == 200:
                        detail = json.loads(data)
                except (OSError, ValueError,
                        http.client.HTTPException) as e:
                    master_print(f"fleet: steal resume on "
                                 f"{tb.name} failed ({e})")
            t_resume = time.monotonic()
            orphans = self._orphans_of(victim)
            polled, redrive = self._adopt(
                victim, tb, detail, orphans) if tb is not None \
                else ([], orphans)
            if tb is None:
                for st in redrive:
                    self._reject_unroutable(st, "fleet-exhausted")
            self.registry.note_steal(victim, tb.name if tb else "")
            event = {"victim": victim,
                     "thief": tb.name if tb is not None else None,
                     "reason": reason, "generation": generation,
                     "recovered": len(polled), "redriven": len(redrive),
                     "drain_s": round(t_drain - t0, 3),
                     "resume_s": round(t_resume - t_drain, 3),
                     "wall_s": round(time.monotonic() - t0, 3)}
            with self._lock:
                self._steals.append(event)
            json_record("fleet_steal", **event)
            master_print(f"fleet: stole {len(polled) + len(redrive)} "
                         f"request(s) from {victim} -> "
                         f"{event['thief']} (gen {generation}, "
                         f"{event['wall_s']}s)")
            return event
        finally:
            with self._lock:
                self._recovering.discard(victim)

    def _poll_recovered(self, thief_name: str, rids: List[str]) -> None:
        """Relay terminal records for resumed orphans by polling the
        thief's ``GET /v1/requests/<id>`` (a resumed request has no
        streaming response anywhere — the victim's stream died with
        it)."""
        pending = set(rids)
        deadline = time.monotonic() + self.fcfg.stream_timeout_s
        while pending and time.monotonic() < deadline:
            tb = self.registry.get(thief_name)
            if tb is None or tb.lost:
                break    # thief died too; its own recovery re-drives
            for rid in sorted(pending):
                try:
                    code, data = self._http(tb, "GET",
                                            f"/v1/requests/{rid}")
                except (OSError, http.client.HTTPException):
                    break
                if code != 200:
                    continue
                try:
                    rec = json.loads(data)
                except ValueError:
                    continue
                if rec.get("status") in TERMINAL_STATUSES:
                    pending.discard(rid)
                    self._deliver(rid, rec, backend=thief_name)
            if self._stop.wait(0.15):
                break
        for rid in sorted(pending):
            self._deliver(rid, {"id": rid, "status": "error",
                                "error": "steal: resumed request did "
                                         "not finish within the stream "
                                         "timeout"},
                          backend=thief_name)

    # --- observability snapshots ------------------------------------------
    def snapshot(self) -> dict:
        """Router + per-backend state for /metrics, /statusz and
        /v1/status — one consistent read of the router tables, then the
        registry (the two locks never nest)."""
        with self._lock:
            router = {"pending": sum(1 for st in self._requests.values()
                                     if not st["delivered"]),
                      "requests": len(self._requests),
                      "duplicates": self._duplicates,
                      "edge_rejected": self._edge_rejected,
                      "cache_edge_hits": self._cache_edge_hits,
                      "cache_prefix_hints": self._cache_prefix_hints,
                      "retries": self._retries,
                      "lost": self._lost,
                      "forwards": self._forwards,
                      "draining": self._draining,
                      "deadline_shed": self._deadline_shed,
                      "brownout_shed": self._brownout_shed,
                      "stream_cuts": self._stream_cuts,
                      "hedges": dict(self._hedges),
                      "steals": list(self._steals)}
            brs = list(self._breakers.values())
        # breaker/budget snapshots take their own fleet-rank locks, so
        # they are read strictly after the router lock is released
        router["retry_budget"] = self._budget.snapshot()
        router["breakers"] = dict(resilience.breaker_rows(brs))
        backends = {}
        for b in self.registry.snapshot():
            backends[b.name] = {
                "address": b.address,
                "healthy": b.healthy, "draining": b.draining,
                "lost": b.lost, "fault_down": b.fault_down,
                "demoted": placement.burn_demoted(b.status),
                "backlog_s": round(placement.predicted_backlog_s(b), 6),
                "backlog_steps": placement.backlog_steps(b),
                "pending_requests": b.pending_requests,
                "routed": b.routed, "delivered": b.delivered,
                "retried": b.retried,
                "stolen_from": b.stolen_from, "stolen_to": b.stolen_to,
                "probe_passes": b.probe_passes,
                "probe_fails": b.probe_fails,
                "consecutive_failures": b.consecutive_failures,
                "mega_capable": bool(((b.status or {}).get("mega")
                                      or {}).get("capable")),
                "engine_ckpt_generation": int(
                    ((b.status or {}).get("engine_ckpt")
                     or {}).get("generation") or 0),
                "serve_resumed": (b.status or {}).get("serve_resumed", 0),
                "queued_now": (b.status or {}).get("queued_now", 0),
                "cache_enabled": (b.status or {}).get("cache")
                is not None,
            }
        return {"kind": "heat-tpu-fleet-status",
                "policy": self.fcfg.policy,
                "steal_threshold_s": self.fcfg.steal_threshold_s,
                "hedge_factor": self.fcfg.hedge_factor,
                "brownout_level": placement.brownout_level(
                    self.registry.snapshot()),
                "uptime_s": round(trace_mod.process_uptime_s(), 3),
                "cache": (self.solvecache.stats()
                          if self.solvecache is not None else None),
                "router": router, "backends": backends}

    def fleet_usage(self) -> dict:
        """Fleet-wide ``/v1/usage``: every reachable backend's ledger,
        merged (exact reconciliation — the sums are the per-engine sums)
        plus the raw per-backend payloads. Edge-served cache hits never
        touched a backend, so their ledger rides along as the pseudo-
        backend ``_edge`` — fleet totals still equal the sum of the
        parts."""
        per_backend = {}
        for b in self.registry.snapshot():
            if b.lost or b.fault_down:
                continue
            try:
                code, data = self._http(b, "GET", "/v1/usage")
                if code == 200:
                    per_backend[b.name] = json.loads(data)
            except (OSError, ValueError, http.client.HTTPException):
                continue
        edge = self._edge_ledger.snapshot()
        if edge["totals"]["requests"]:
            per_backend["_edge"] = edge
        return merge_usage(per_backend)


def merge_usage(per_backend: Dict[str, dict]) -> dict:
    """Pure merge of per-engine ``/v1/usage`` ledgers: per-(tenant,
    class) fields and engine totals are summed across backends, and the
    raw payloads ride along under ``per_backend`` so the reconciliation
    is auditable — fleet totals equal the sum of per-engine ledgers by
    construction."""
    fields = ("lane_s", "steps", "chunks", "bytes_written",
              "steps_saved", "cached", "requests")
    tenants: Dict[str, dict] = {}
    totals = {f: 0 for f in fields}
    for payload in per_backend.values():
        for tname, t in (payload.get("tenants") or {}).items():
            tdst = tenants.setdefault(tname, {"classes": {}})
            for cname, c in (t.get("classes") or {}).items():
                cdst = tdst["classes"].setdefault(
                    cname, {f: 0 for f in fields})
                for f in fields:
                    cdst[f] = round(cdst[f] + c.get(f, 0), 9)
        for f in fields:
            totals[f] = round(totals[f]
                              + (payload.get("totals") or {}).get(f, 0), 9)
    return {"kind": "heat-tpu-fleet-usage",
            "backends": sorted(per_backend),
            "tenants": tenants, "totals": totals,
            "per_backend": per_backend}


def render_fleet_metrics(router: Router) -> str:
    """The router's ``/metrics`` (Prometheus text format): router-native
    series with per-backend labels. Pure function of the router so tests
    assert without a socket."""
    from ..serve.gateway import escape_label_value

    s = router.snapshot()
    out = []

    def metric(name, mtype, help_text, samples):
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            lbl = ("{" + ",".join(
                f'{k}="{escape_label_value(v)}"' for k, v in labels) + "}"
                   if labels else "")
            out.append(f"{name}{lbl} {value}")

    metric("heat_tpu_fleet_info", "gauge",
           "Router identity/config (value is always 1).",
           [([("policy", s["policy"]),
              ("steal_threshold_s", s["steal_threshold_s"])], 1)])
    metric("heat_tpu_fleet_uptime_seconds", "gauge",
           "Seconds since this router process started.",
           [([], s["uptime_s"])])
    metric("heat_tpu_fleet_draining", "gauge",
           "1 once the router's /drainz has been called.",
           [([], int(s["router"]["draining"]))])
    bk = sorted(s["backends"].items())
    metric("heat_tpu_fleet_backend_up", "gauge",
           "1 while the backend passes health probes and accepts "
           "placements.",
           [([("backend", n)], int(b["healthy"])) for n, b in bk]
           or [([], 0)])
    metric("heat_tpu_fleet_backend_demoted", "gauge",
           "1 while burn-aware placement demotes the backend (fast AND "
           "slow SLO burn windows over threshold for some class).",
           [([("backend", n)], int(b["demoted"])) for n, b in bk]
           or [([], 0)])
    metric("heat_tpu_fleet_backend_backlog_seconds", "gauge",
           "Predicted backlog seconds per backend (cost model x queue "
           "work + router-pending) — the least-loaded placement score.",
           [([("backend", n)], b["backlog_s"]) for n, b in bk]
           or [([], 0)])
    metric("heat_tpu_fleet_routed_total", "counter",
           "Requests forwarded, per backend.",
           [([("backend", n)], b["routed"]) for n, b in bk] or [([], 0)])
    metric("heat_tpu_fleet_delivered_total", "counter",
           "Terminal records delivered to clients, per serving backend.",
           [([("backend", n)], b["delivered"]) for n, b in bk]
           or [([], 0)])
    metric("heat_tpu_fleet_retried_total", "counter",
           "Batch forwards retried on an alternate backend (the "
           "never-reached-admission path), per refused backend.",
           [([("backend", n)], b["retried"]) for n, b in bk]
           or [([], 0)])
    metric("heat_tpu_fleet_probe_failures_total", "counter",
           "Health-probe failures, per backend.",
           [([("backend", n)], b["probe_fails"]) for n, b in bk]
           or [([], 0)])
    metric("heat_tpu_fleet_backends_lost_total", "counter",
           "Backends transitioned to lost (recovery ran).",
           [([], s["router"]["lost"])])
    metric("heat_tpu_fleet_steals_total", "counter",
           "Checkpoint-handoff work steals, per victim backend.",
           [([("backend", n)], b["stolen_from"]) for n, b in bk]
           or [([], 0)])
    metric("heat_tpu_fleet_requests_pending", "gauge",
           "Router-tracked requests awaiting a terminal record.",
           [([], s["router"]["pending"])])
    metric("heat_tpu_fleet_duplicates_dropped_total", "counter",
           "Terminal records dropped by the exactly-once delivery "
           "chokepoint (a re-driven request finishing twice).",
           [([], s["router"]["duplicates"])])
    metric("heat_tpu_fleet_edge_rejected_total", "counter",
           "Request lines rejected at the router edge (parse/validate/"
           "duplicate) without ever reaching a backend.",
           [([], s["router"]["edge_rejected"])])
    metric("heat_tpu_fleet_cache_edge_hits_total", "counter",
           "Requests served entirely at the edge from the shared solve "
           "cache (zero backends touched).",
           [([], s["router"]["cache_edge_hits"])])
    metric("heat_tpu_fleet_cache_prefix_hints_total", "counter",
           "Placements steered toward a cache-enabled backend by a "
           "prefix hit in the shared solve cache.",
           [([], s["router"]["cache_prefix_hints"])])
    cache = s.get("cache") or {}
    metric("heat_tpu_fleet_cache_entries", "gauge",
           "Entries in the shared solve-cache dir as the router sees "
           "it (read-only).", [([], cache.get("entries", 0))])
    metric("heat_tpu_fleet_cache_bytes", "gauge",
           "Bytes the shared solve-cache dir holds as the router sees "
           "it.", [([], cache.get("bytes", 0))])
    metric("heat_tpu_fleet_flightrec_dumps_total", "counter",
           "Fleet-timeline flight dumps written on backend loss.",
           [([], router.tracer.dumps)])
    breakers = sorted((s["router"].get("breakers") or {}).items())
    metric("heat_tpu_fleet_breaker_state", "gauge",
           "Per-backend circuit-breaker state (0 closed, 1 half-open, "
           "2 open).",
           [([("backend", n)], b["code"]) for n, b in breakers]
           or [([], 0)])
    metric("heat_tpu_fleet_breaker_transitions_total", "counter",
           "Circuit-breaker state transitions, per backend.",
           [([("backend", n)], b["transitions"]) for n, b in breakers]
           or [([], 0)])
    hedges = s["router"]["hedges"]
    metric("heat_tpu_fleet_hedges_total", "counter",
           "Hedged interactive dispatches by outcome (fired = twin "
           "sent, won = twin's record reached the client first, lost = "
           "twin discarded, cancelled = loser preempted mid-solve).",
           [([("outcome", k)], v) for k, v in sorted(hedges.items())])
    rb = s["router"]["retry_budget"]
    metric("heat_tpu_fleet_retry_budget_remaining", "gauge",
           "Tokens left in the fleet-wide retry budget (retries are "
           "capped as a fraction of delivered successes).",
           [([], round(rb["tokens"], 6))])
    metric("heat_tpu_fleet_retry_budget_denied_total", "counter",
           "Re-dispatches refused because the retry budget was dry "
           "(the rows were shed instead of amplifying overload).",
           [([], rb["denied"])])
    metric("heat_tpu_fleet_deadline_shed_total", "counter",
           "Rows shed because their edge-minted deadline budget was "
           "already spent (at placement, a relay hop, or backend "
           "admission) — they never started device work.",
           [([], s["router"]["deadline_shed"])])
    metric("heat_tpu_fleet_brownout_shed_total", "counter",
           "Rows shed by class at the edge during fleet-wide brownout "
           "(every backend burning SLO budget in both windows).",
           [([], s["router"]["brownout_shed"])])
    metric("heat_tpu_fleet_stream_cuts_total", "counter",
           "Mid-stream relay breaks against a still-live backend that "
           "took the bounded re-drive path instead of loss recovery.",
           [([], s["router"]["stream_cuts"])])
    return "\n".join(out) + "\n"


def render_fleet_statusz(router: Router) -> str:
    """The router's ``/statusz``: the fleet at a glance for an operator
    mid-incident — per-backend health/backlog/burn table, the steal
    log, and where the flight dumps went."""
    s = router.snapshot()
    r = s["router"]
    lines = [f"heat_tpu_torch fleet router — statusz "
             f"(uptime {s['uptime_s']:.0f}s, policy {s['policy']}, "
             f"steal threshold "
             f"{s['steal_threshold_s'] or 'off'}"
             f"{'s' if s['steal_threshold_s'] else ''}, "
             f"{'DRAINING' if r['draining'] else 'admitting'})", ""]
    lines.append(
        f"requests: {r['requests']} routed total, {r['pending']} "
        f"pending, {r['edge_rejected']} rejected at the edge, "
        f"{r['retries']} batch retr{'y' if r['retries'] == 1 else 'ies'}, "
        f"{r['duplicates']} duplicate record(s) dropped")
    cache = s.get("cache")
    if cache is None:
        lines.append("solve cache: not shared with this router "
                     "(--cache-dir unset)")
    else:
        lines.append(
            f"solve cache (read-only over {cache['dir']}): "
            f"{r['cache_edge_hits']} edge hit(s), "
            f"{r['cache_prefix_hints']} prefix placement hint(s), "
            f"{cache['entries']} entr(ies) / "
            f"{cache['bytes'] / 2**20:.2f} MiB on disk")
    rb = r["retry_budget"]
    lines.append(
        f"retry budget: {rb['tokens']:.1f}/{rb['cap']:g} tokens "
        f"(+{rb['ratio']:g}/success; {rb['taken']} taken, "
        f"{rb['denied']} denied) — {r['deadline_shed']} deadline-shed, "
        f"{r['brownout_shed']} brownout-shed"
        f"{' [BROWNOUT L' + str(s['brownout_level']) + ']' if s.get('brownout_level') else ''}, "
        f"{r['stream_cuts']} stream cut(s) re-driven")
    h = r["hedges"]
    lines.append(
        f"hedging ({'factor ' + format(s['hedge_factor'], 'g') if s.get('hedge_factor') else 'off'}): "
        f"{h['fired']} fired, {h['won']} won, {h['lost']} lost, "
        f"{h['cancelled']} loser(s) cancelled")
    breakers = r.get("breakers") or {}
    open_brs = {n: b for n, b in breakers.items()
                if b["state"] != "closed"}
    if open_brs:
        lines.append(f"breakers ({len(open_brs)} not closed):")
        for n, bs in sorted(open_brs.items()):
            lines.append(
                f"  {n}: {bs['state'].upper()} — "
                f"{bs['consecutive_errors']} consecutive error(s), "
                f"burn {bs['burn_ticks']} tick(s), cooldown "
                f"{bs['cooldown_s']:g}s, last {bs['last_reason'] or '-'} "
                f"({bs['transitions']} transition(s))")
    else:
        lines.append(f"breakers: all {len(breakers)} closed")
    lines.append(f"backends ({len(s['backends'])}; "
                 f"{r['lost']} lost so far):")
    for name, b in sorted(s["backends"].items()):
        state = ("FAULT-DOWN" if b["fault_down"] else
                 "LOST" if b["lost"] else
                 "draining" if b["draining"] else
                 "up" if b["healthy"] else "DOWN")
        lines.append(
            f"  {name} @ {b['address']}: {state}"
            f"{' DEMOTED(burn)' if b['demoted'] else ''} — backlog "
            f"{b['backlog_s']:.3f}s ({b['backlog_steps']} steps, "
            f"{b['pending_requests']} router-pending), routed "
            f"{b['routed']}, delivered {b['delivered']}, retried "
            f"{b['retried']}, probes {b['probe_passes']}/"
            f"{b['probe_fails']} fail, ckpt gen "
            f"{b['engine_ckpt_generation']}, resumed "
            f"{b['serve_resumed']}, stolen {b['stolen_from']}x from / "
            f"{b['stolen_to']}x to"
            f"{', mega' if b['mega_capable'] else ''}")
    steals = r["steals"]
    lines.append("")
    lines.append(f"steals ({len(steals)}):")
    if not steals:
        lines.append("  (none)")
    for ev in steals[-10:]:
        lines.append(
            f"  {ev['victim']} -> {ev['thief']} [{ev['reason']}]: gen "
            f"{ev['generation']}, {ev['recovered']} resumed + "
            f"{ev['redriven']} re-driven, drain {ev['drain_s']}s + "
            f"resume {ev['resume_s']}s = {ev['wall_s']}s")
    if router.tracer.dumps:
        lines.append("")
        lines.append(f"flight-recorder dumps ({router.tracer.dumps}):")
        for p in router.tracer.dump_paths:
            lines.append(f"  {p}")
    return "\n".join(lines) + "\n"


class _FleetHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def rt(self) -> Router:
        return self.server.router

    def log_message(self, fmt, *args):  # noqa: D102
        if not self.rt.fcfg.quiet:
            master_print(f"fleet: {self.address_string()} {fmt % args}")

    @property
    def trace_id(self) -> str:
        tid = getattr(self, "_trace_id", None)
        if tid is None:
            inbound = (self.headers.get("X-Trace-Id") or "").strip()
            tid = (inbound if _TRACE_ID_RE.match(inbound)
                   else self.rt.tracer.mint_trace_id())
            self._trace_id = tid
        return tid

    def _send_headers(self, code: int, body_len: int, ctype: str,
                      headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(body_len))
        has_tid = False
        for k, v in headers:
            self.send_header(k, str(v))
            has_tid = has_tid or k == "X-Trace-Id"
        if not has_tid:
            self.send_header("X-Trace-Id", self.trace_id)
        self.end_headers()

    def _json(self, code: int, obj, headers=()) -> None:
        body = (json.dumps(obj, sort_keys=True) + "\n").encode()
        self._send_headers(code, len(body), "application/json", headers)
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _text(self, code: int, text: str, ctype: str) -> None:
        body = text.encode()
        self._send_headers(code, len(body), ctype)
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    # --- routes -----------------------------------------------------------
    def do_GET(self):  # noqa: N802
        parts = urlsplit(self.path)
        path = parts.path
        rt = self.rt
        if path == "/healthz":
            ups = [b for b in rt.registry.snapshot() if b.healthy]
            if rt.draining:
                self._json(503, {"status": "draining",
                                 "backends_up": len(ups)},
                           headers=[("Retry-After",
                                     int(rt.fcfg.retry_after_s))])
            elif ups:
                self._json(200, {"status": "ok",
                                 "backends_up": len(ups)})
            else:
                self._json(503, {"status": "no-backends"},
                           headers=[("Retry-After",
                                     int(rt.fcfg.retry_after_s))])
        elif path == "/metrics":
            self._text(200, render_fleet_metrics(rt),
                       "text/plain; version=0.0.4")
        elif path == "/statusz":
            self._text(200, render_fleet_statusz(rt),
                       "text/plain; charset=utf-8")
        elif path == "/v1/status":
            payload = rt.snapshot()
            payload["address"] = rt.address
            self._json(200, payload)
        elif path == "/v1/usage":
            self._json(200, rt.fleet_usage())
        elif path == "/tracez":
            self._text(200, json.dumps(rt.tracer.to_chrome()),
                       "application/json")
        elif path == "/drainz":
            self._drainz()
        elif path.startswith("/v1/requests/"):
            self._request_status(path[len("/v1/requests/"):])
        else:
            self._json(404, {"error": f"no route for GET {path}"})

    def do_POST(self):  # noqa: N802
        parts = urlsplit(self.path)
        if parts.path == "/drainz":
            self._drainz()
        elif parts.path == "/v1/solve":
            self._solve(parts)
        else:
            self._json(404, {"error": f"no route for POST {parts.path}"})

    def _drainz(self) -> None:
        self.rt.request_drain()
        self._json(200, {"draining": True,
                         "pending": self.rt.pending_count()})

    def _request_status(self, rid: str) -> None:
        """Record lookup: answered locally once delivered, proxied to
        the owning backend while in flight."""
        rt = self.rt
        with rt._lock:
            st = rt._requests.get(rid)
            rec = st["rec"] if st else None
            owner = st["backend"] if st else None
        if rec is not None:
            self._json(200, rec)
            return
        if owner is None:
            self._json(404, {"error": f"unknown request id {rid!r}"})
            return
        b = rt.registry.get(owner)
        if b is None:
            self._json(404, {"error": f"backend {owner!r} vanished"})
            return
        try:
            code, data = rt._http(b, "GET", f"/v1/requests/{rid}")
            self._json(code, json.loads(data))
        except (OSError, ValueError, http.client.HTTPException) as e:
            self._json(502, {"error": f"backend {owner} unreachable: "
                                      f"{type(e).__name__}: {e}"})

    def _read_body(self) -> Optional[bytes]:
        n = self.headers.get("Content-Length")
        if n is None:
            self._json(411, {"error": "Content-Length required"})
            return None
        n = int(n)
        if n > MAX_BODY_BYTES:
            self._json(413, {"error": f"body exceeds {MAX_BODY_BYTES} "
                                      f"bytes"})
            return None
        return self.rfile.read(n)

    def _solve(self, parts) -> None:
        rt = self.rt
        tr = rt.tracer
        if not tr.enabled:
            return self._solve_inner(parts)
        t0 = tr.now()
        try:
            self._solve_inner(parts)
        finally:
            tr.complete("POST /v1/solve", tr.thread_track("fleet router"),
                        t0, cat="http")

    def _solve_inner(self, parts) -> None:
        rt = self.rt
        if rt.draining:
            self._json(503, {"error": "draining: fleet admission "
                                      "stopped (/drainz)"},
                       headers=[("Retry-After",
                                 int(rt.fcfg.retry_after_s))])
            return
        body = self._read_body()
        if body is None:
            return
        wait = parse_qs(parts.query).get("wait", ["1"])[0] not in ("0",
                                                                   "false")
        results: Optional[queue_lib.Queue] = (queue_lib.Queue() if wait
                                              else None)
        immediate, states = rt.admit_lines(body, results, self.trace_id)
        if not immediate and not states:
            self._json(400, {"error": "empty body: expected one JSON "
                                      "request object per line"})
            return
        if not wait:
            rt.dispatch(states)
            self._json(202, {"accepted": [st["id"] for st in states],
                             "records": immediate})
            return
        self._stream(immediate, states, results)

    def _stream(self, immediate, states, results) -> None:
        """Chunked NDJSON back to the client: rejection records first,
        then each request's terminal record as its backend (original,
        retried, or stolen-to) produces it."""
        rt = self.rt
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Trace-Id", self.trace_id)
        self.end_headers()

        def chunk(obj) -> bool:
            data = (json.dumps(obj, sort_keys=True, default=str)
                    + "\n").encode()
            try:
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                return True
            except (BrokenPipeError, ConnectionResetError):
                return False

        alive = True
        for rec in immediate:
            alive = alive and chunk(rec)
        rt.dispatch(states)
        pending = {st["id"] for st in states}
        deadline = time.monotonic() + rt.fcfg.stream_timeout_s
        while pending and alive:
            try:
                rec = results.get(timeout=max(0.05,
                                              deadline - time.monotonic()))
            except queue_lib.Empty:
                chunk({"error": f"stream timeout after "
                                f"{rt.fcfg.stream_timeout_s:g}s; poll "
                                f"GET /v1/requests/<id> for the rest",
                       "pending": sorted(pending)})
                break
            rid = rec.get("id")
            if rid in pending:
                pending.discard(rid)
                alive = alive and chunk(rec)
        try:
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass
