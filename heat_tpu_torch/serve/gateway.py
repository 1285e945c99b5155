"""Online serving gateway: streaming HTTP admission over the lane engine.

The port of ``heat_tpu.serve.gateway``. ``python -m heat_tpu_torch serve
--listen HOST:PORT`` turns the batch drain into a long-running service on
the card (the lane kernels serve every request). The engine's scheduler runs on its own thread
(``Engine.start()``); this module is the stdlib-only front door that
feeds it while lanes run and exposes the operational surface an online
system owes its operators:

- ``POST /v1/solve`` — newline-delimited JSON request objects (the exact
  ``serve --requests`` line format, ``serve/api.py``). Default response
  is a chunked ``application/x-ndjson`` stream: one record line per
  request, written the moment that request's lane retires (iteration-
  level admission is only *online* because of this — a request arriving
  mid-chunk is admitted at the next boundary). ``?wait=0`` returns 202
  with the accepted ids immediately; poll instead.
- ``GET /v1/requests/<id>`` — one record snapshot (404 unknown id);
  ``?field=1`` inlines the final field as JSON lists — the read the
  canary prober (serve/probe.py) verifies solutions through.
- ``GET /healthz`` — 200 while admitting, 503 once draining (the flip a
  load balancer keys on), plus a scheduler-crash indicator.
- ``POST /drainz`` — graceful drain: stops admission (healthz flips
  immediately, new solves get 503), lets every in-flight lane and queued
  request finish, then shuts the scheduler down. Idempotent; repeated
  calls report progress.
- ``GET /metrics`` — Prometheus text format: request counters by status,
  per-tenant queue-depth gauges, per-class end-to-end latency histograms
  and the queue-depth-at-submit histogram (serve/policy.py), plus every
  counter ``Engine.summary()`` tracks (quarantines, rollbacks, deadline
  misses, shed, watchdog, compiles, boundary waits), build identity
  (``heat_tpu_build_info``) and process uptime. User-supplied label
  values (tenant/class) are escaped per the exposition format.
- ``GET /tracez`` — the engine's event ring (runtime/trace.py) as Chrome
  trace-event JSON, on demand: load it straight into Perfetto to see
  lane occupancy, chunk pipelining, and queue waits of the live engine.
  Every response to ``/v1/solve`` echoes the minted per-request trace
  ids in an ``X-Trace-Id`` header (and every NDJSON record carries its
  ``trace_id``), so client logs join against the timeline.
- ``GET /statusz`` — human-readable operator snapshot (text): engine
  counters, the online chunk-cost model (runtime/prof.py), compile
  observatory, memory watermarks, SLO burn rates, top tenants by usage,
  flight-recorder dump paths. The "what is this server doing right now"
  page; everything on it is also machine-readable elsewhere.
- ``GET /v1/usage`` — the per-tenant usage ledger as JSON: lane-seconds,
  steps, chunks, and bytes written per (tenant, class) plus engine-wide
  totals, reconciling exactly with the ``usage`` stamps on the
  per-request records (``python -m heat_tpu_torch usage URL`` renders it
  as a table).

**Every** response carries an ``X-Trace-Id`` header — success, 4xx/5xx
error paths, ``/drainz``, all of it: the inbound header is echoed when
the client sent one (charset-checked), else an id is minted, so a
client log line always joins against the server's trace no matter how
the request ended. ``/v1/solve`` responses override the default with
the per-request ids they minted.

Backpressure is the admission bounds made visible: a submit shed by
``--max-queue`` or ``--tenant-quota`` answers **429 with Retry-After**
instead of queueing without bound, and a draining gateway answers 503
with the same header. Per-lane fault domains flow through unchanged — a
quarantined lane's request streams back as a structured ``nonfinite``
record over HTTP, exactly the record the JSONL drain would have printed.

Threading model: ``ThreadingHTTPServer`` handler threads call only the
engine's thread-safe surface (``submit``/``poll``/``wait``/listeners);
the scheduler thread never blocks on a socket. Result streaming is
listener-driven (no polling loops): each streaming POST registers a
results listener, submits, then relays matching records from a local
queue until its batch completes.
"""

from __future__ import annotations

import json
import queue as queue_lib
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from ..config import SLO_CLASSES
from ..runtime import debug
from ..runtime import prof as prof_mod
from ..runtime import trace as trace_mod
from ..runtime.logging import master_print
from .api import parse_request_obj, submit_parsed
from .scheduler import Engine, TERMINAL_STATUSES

MAX_BODY_BYTES = 16 << 20   # one POST body; a solve request is ~100 bytes,
                            # so this bounds even absurd batch lines
_OVERLOAD_PREFIX = "overloaded:"

# Inbound X-Trace-Id values we will echo verbatim: ids we mint plus any
# sane client-correlation token. Anything else (header-splitting
# attempts, binary junk) is replaced by a freshly minted id.
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._,-]{1,200}$")


def escape_label_value(v) -> str:
    """Escape one Prometheus label VALUE per the text exposition format:
    backslash, double-quote, and newline must be escaped — ``tenant`` and
    ``class`` are user-supplied request strings, and a tenant named
    ``a"b`` (or one smuggling a newline) must corrupt its own label, not
    the whole scrape."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def render_metrics(engine: Engine) -> str:
    """The ``/metrics`` payload (Prometheus text exposition format).

    Pure function of the engine so tests can assert on it without a
    socket; the gateway handler just serves it."""
    s = engine.summary()
    out = []

    def metric(name, mtype, help_text, samples):
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            lbl = ("{" + ",".join(
                f'{k}="{escape_label_value(v)}"' for k, v in labels) + "}"
                   if labels else "")
            out.append(f"{name}{lbl} {value}")

    import torch

    from .. import __version__

    dev = engine.device
    metric("heat_tpu_build_info", "gauge",
           "Build/runtime identity (value is always 1).",
           [([("version", __version__), ("torch", torch.__version__),
              ("device", torch.cuda.get_device_name(dev)
               if dev.type == "cuda" else "cpu")], 1)])
    metric("heat_tpu_process_uptime_seconds", "gauge",
           "Seconds since this serving process started.",
           [([], round(trace_mod.process_uptime_s(), 3))])
    metric("heat_tpu_serve_info", "gauge",
           "Static engine configuration (value is always 1).",
           [([("policy", s["policy"]),
              ("dispatch_depth", s["dispatch_depth"]),
              ("classes", "|".join(sorted(SLO_CLASSES,
                                          key=SLO_CLASSES.get)))], 1)])
    metric("heat_tpu_serve_draining", "gauge",
           "1 once /drainz has been called (healthz returns 503).",
           [([], int(engine.draining))])
    metric("heat_tpu_serve_scheduler_up", "gauge",
           "1 while the online scheduler thread is alive and healthy.",
           [([], int(engine.online and engine.loop_error is None))])
    metric("heat_tpu_serve_requests_total", "counter",
           "Requests ever submitted, by current/terminal status.",
           [([("status", st)], s[st]) for st in
            (*TERMINAL_STATUSES, "queued", "running") if s.get(st)]
           or [([("status", "ok")], 0)])
    metric("heat_tpu_serve_requests_by_placement_total", "counter",
           "Requests by placement tier: packed = stacked bucket lanes, "
           "mega = mesh-spanning sharded mega-lane.",
           [([("placement", p)], c)
            for p, c in sorted((s.get("placement") or {}).items())]
           or [([("placement", "packed")], 0)])
    metric("heat_tpu_serve_mega_lanes", "gauge",
           "Concurrent mega-lane slots (--mega-lanes; 0 = bucket "
           "overflow stays a rejection).",
           [([], s.get("mega_lanes", 0))])
    metric("heat_tpu_serve_mega_compiles_total", "counter",
           "Mega-lane programs compiled (chunk/seed/crop; warm "
           "re-admissions of the same oversized config compile nothing).",
           [([], s.get("mega_compiles", 0))])
    metric("heat_tpu_serve_queue_depth", "gauge",
           "Requests queued (not yet admitted to a lane), per tenant.",
           [([("tenant", t)], n)
            for t, n in sorted(engine.queue_depths().items())]
           or [([], 0)])
    for name, key, help_text in (
            ("heat_tpu_serve_shed_total", "shed",
             "Submits rejected by --max-queue / --tenant-quota."),
            ("heat_tpu_serve_deadline_misses_total", "deadline_misses",
             "Requests preempted or shed past their deadline_ms."),
            ("heat_tpu_serve_lanes_quarantined_total", "lanes_quarantined",
             "Requests failed nonfinite (lane quarantined)."),
            ("heat_tpu_serve_rollbacks_total", "rollbacks",
             "Per-lane restore-and-re-step events (--serve-on-nan rollback)."),
            ("heat_tpu_serve_watchdog_fired_total", "watchdog_fired",
             "Boundary-fetch watchdog timeouts."),
            ("heat_tpu_serve_lane_grows_total", "lane_grows",
             "Online lane-tier growth events (group rebuilt wider)."),
            ("heat_tpu_serve_chunks_dispatched_total", "chunks_dispatched",
             "Chunk programs dispatched across all bucket groups."),
            ("heat_tpu_serve_step_compiles_total", "step_compiles",
             "Steady stepping programs compiled (one per bucket x tier)."),
            ("heat_tpu_serve_boundary_waits_total", "boundary_waits",
             "Chunk-boundary fetches taken.")):
        metric(name, "counter", help_text, [([], s[key])])
    metric("heat_tpu_serve_boundary_wait_seconds_total", "counter",
           "Host wall seconds blocked on chunk-boundary fetches.",
           [([], s["boundary_wait_s"])])
    metric("heat_tpu_serve_resumed_requests_total", "counter",
           "Requests re-admitted from an engine-state checkpoint "
           "(serve --resume): in-flight lanes continued at their last "
           "boundary plus queued requests re-queued in policy order.",
           [([], s.get("serve_resumed", 0))])
    metric("heat_tpu_engine_ckpt_generation", "gauge",
           "Newest durable engine-checkpoint generation this process "
           "has published (0 = none yet; --engine-ckpt-interval).",
           [([], s.get("engine_ckpt_generation", 0))])
    metric("heat_tpu_flightrec_dumps_total", "counter",
           "Flight-recorder dumps written (watchdog fire / quarantine-"
           "after-rollbacks / numerics violation / scheduler crash); "
           "paths in the structured flightrec records and on /statusz.",
           [([], engine.tracer.dumps)])

    # --- numerics observatory (runtime/numerics.py) ------------------------
    metric("heat_tpu_numerics_enabled", "gauge",
           "1 while the numerics observatory ingests boundary stats "
           "(--numerics); the guard label names the violation routing.",
           [([("guard", s.get("numerics_guard", "warn"))],
             int(bool(s.get("numerics"))))])
    metric("heat_tpu_numerics_steady_total", "counter",
           "Requests whose residual EWMA converged below --steady-tol "
           "with steps still remaining (fire-once per request).",
           [([], s.get("steady_lanes", 0))])
    metric("heat_tpu_numerics_violations_total", "counter",
           "Maximum-principle escapes + heat-content jumps detected "
           "(one verdict per request; structured numerics_violation "
           "records carry the witnesses).",
           [([], s.get("numerics_violations", 0))])

    # --- semantic scheduling ----------------------------------------------
    metric("heat_tpu_serve_steady_exits_total", "counter",
           "until=steady requests retired early at their dispatch "
           "frontier (residual EWMA passed tolerance before ntime).",
           [([], s.get("steady_exits", 0))])
    metric("heat_tpu_serve_steps_saved_total", "counter",
           "Device steps NOT run thanks to steady early exits (requested"
           " minus actual, summed over steady-exited requests).",
           [([], s.get("steps_saved", 0))])
    ns = (engine.numerics.snapshot()
          if engine.numerics is not None else None)
    metric("heat_tpu_numerics_predicted_eta_steps", "gauge",
           "Predicted steps until each resident lane's residual EWMA "
           "crosses its steady tolerance (fused eigenmode + observed "
           "slope, runtime/convergence.py); absent lanes have no "
           "prediction yet.",
           [([("id", rid)], st["eta_steps"])
            for rid, st in sorted((ns or {}).get("lanes", {}).items())
            if st.get("eta_steps") is not None] or [([], 0)])

    # --- canary prober (serve/probe.py) -----------------------------------
    pr = engine.prober.stats() if engine.prober is not None else None
    metric("heat_tpu_probe_runs_total", "counter",
           "Known-answer canary probes completed, by verdict (the sine-"
           "eigenmode request verified against its closed-form decay).",
           [([("result", "pass")], (pr or {}).get("passes", 0)),
            ([("result", "fail")], (pr or {}).get("fails", 0))])
    metric("heat_tpu_probe_consecutive_failures", "gauge",
           "Current run of back-to-back probe failures (a probe_failed "
           "record fires once the alert threshold is crossed).",
           [([], (pr or {}).get("consecutive_failures", 0))])
    metric("heat_tpu_probe_last_error_norm", "gauge",
           "Max-norm error of the last probe's returned field vs the "
           "analytic lambda**s decay (NaN until a probe completes).",
           [([], pr["last_error_norm"])]
           if pr and pr.get("last_error_norm") is not None else [([], 0)])
    metric("heat_tpu_probe_last_latency_seconds", "gauge",
           "End-to-end wall seconds of the last probe through the real "
           "gateway path.",
           [([], round(pr["last_latency_s"], 6))]
           if pr and pr.get("last_latency_s") is not None else [([], 0)])

    # --- performance & cost observatory (runtime/prof.py) ----------------
    cm = s.get("cost_model") or []
    metric("heat_tpu_serve_cost_s_per_lane_step", "gauge",
           "Online chunk-cost model: EWMA seconds per lane-step, per "
           "(bucket, lane-tier, dispatch-depth, kernel).",
           [([("bucket", e["bucket"]), ("lanes", e["lanes"]),
              ("depth", e["depth"]), ("kernel", e.get("kernel", "torch")),
              ("placement", e.get("placement", "packed"))],
             e["ewma_s_per_lane_step"])
            for e in cm if e["ewma_s_per_lane_step"] is not None]
           or [([], 0)])
    metric("heat_tpu_serve_cost_chunks_observed_total", "counter",
           "Chunk boundaries the cost model has learned from, per key.",
           [([("bucket", e["bucket"]), ("lanes", e["lanes"]),
              ("depth", e["depth"]), ("kernel", e.get("kernel", "torch")),
              ("placement", e.get("placement", "packed"))],
             e["chunks"]) for e in cm]
           or [([], 0)])
    metric("heat_tpu_serve_lane_kernel_fallbacks_total", "counter",
           "(bucket, lane-tier) groups that wanted the lane kernels "
           "and degraded to the plain lane step (--serve-lane-kernel; "
           "structured lane_kernel_fallback records carry the reasons).",
           [([("requested", s.get("lane_kernel", "auto"))],
             s.get("lane_kernel_fallbacks", 0))])
    comp = prof_mod.compile_log().summary()
    metric("heat_tpu_compile_programs_total", "counter",
           "Chunk programs actually compiled by this process "
           "(kernel builds and solo warm-ups alike), "
           "by first-vs-warm key attribution.",
           [([("kind", "first")], comp["distinct"]),
            ([("kind", "warm")], comp["programs"] - comp["distinct"])])
    metric("heat_tpu_compile_seconds_total", "counter",
           "Wall seconds spent compiling chunk programs, by first-vs-"
           "warm (warm re-compile wall = persistent-cache report card).",
           [([("kind", "first")], comp["first_s"]),
            ([("kind", "warm")], comp["warm_s"])])
    mem = s.get("mem") or {}
    metric("heat_tpu_mem_bytes_in_use", "gauge",
           "Newest device-memory watermark sample (source label: "
           "allocator stats or live-array bytes).",
           [([("source", mem.get("source", "unavailable"))],
             mem.get("last_bytes") or 0)])
    metric("heat_tpu_mem_peak_bytes", "gauge",
           "Peak device-memory watermark this engine has seen.",
           [([], mem.get("peak_bytes") or 0)])
    metric("heat_tpu_mem_watermark_warnings_total", "counter",
           "Leak-sentinel firings (monotone growth past the byte floor).",
           [([], mem.get("warnings") or 0)])
    burn = s.get("slo_burn") or {}
    for name, field, help_text in (
            ("heat_tpu_slo_burn_rate", None,
             "Error-budget burn rate per class and window (1.0 = burning "
             "exactly at the sustainable rate; >threshold in both windows "
             "emits a structured slo_alert)."),
            ("heat_tpu_slo_deadline_hit_ratio", "hit",
             "Deadline-hit fraction per class and window (dated requests "
             "only; absent window = no dated traffic).")):
        samples = []
        for cls, b in sorted(burn.items()):
            for window in ("fast", "slow"):
                v = (b[f"{window}_burn"] if field is None
                     else b[f"{window}_hit_ratio"])
                if v is not None:
                    samples.append(
                        ([("class", cls), ("window", window)], v))
        metric(name, "gauge", help_text, samples or [([], 0)])
    metric("heat_tpu_slo_alerts_total", "counter",
           "Structured slo_alert records emitted, per class.",
           [([("class", cls)], b["alerts"])
            for cls, b in sorted(burn.items())] or [([], 0)])
    cache = s.get("cache") or {}
    metric("heat_tpu_cache_hits_total", "counter",
           "Solve-cache hits by kind: 'full' short-circuits admission "
           "(served byte-identically from disk, no lane), 'prefix' "
           "seeds a lane from a cached frontier and steps the delta.",
           [([("kind", "full")], cache.get("hits_full", 0)),
            ([("kind", "prefix")], cache.get("hits_prefix", 0))])
    metric("heat_tpu_cache_misses_total", "counter",
           "Solve-cache consults that found no usable entry.",
           [([], cache.get("misses", 0))])
    metric("heat_tpu_cache_evictions_total", "counter",
           "Entries LRU-evicted to honor --cache-max-bytes.",
           [([], cache.get("evictions", 0))])
    metric("heat_tpu_cache_quarantined_total", "counter",
           "Entries that failed validation on consult and were renamed "
           "to *.corrupt (cache_quarantined records carry the reason).",
           [([], cache.get("quarantined", 0))])
    metric("heat_tpu_cache_entries", "gauge",
           "Published cache entries on disk right now.",
           [([], cache.get("entries", 0))])
    metric("heat_tpu_cache_bytes", "gauge",
           "Bytes the cache directory holds right now.",
           [([], cache.get("bytes", 0))])
    usage = engine.prof.ledger.snapshot()
    for name, field, help_text in (
            ("heat_tpu_usage_lane_seconds_total", "lane_s",
             "Lane-occupancy seconds consumed, per tenant and class "
             "(the per-request usage stamps, aggregated)."),
            ("heat_tpu_usage_steps_total", "steps",
             "Simulation steps served, per tenant and class."),
            ("heat_tpu_usage_chunks_total", "chunks",
             "Chunk programs participated in, per tenant and class."),
            ("heat_tpu_usage_bytes_written_total", "bytes_written",
             "Result bytes produced, per tenant and class."),
            ("heat_tpu_usage_steps_saved_total", "steps_saved",
             "Steps not run thanks to until=steady early exits and "
             "solve-cache hits, per tenant and class (saved device time "
             "billed as saved)."),
            ("heat_tpu_usage_cached_total", "cached",
             "Requests served entirely from the solve cache (zero "
             "lane-seconds/steps billed), per tenant and class."),
            ("heat_tpu_usage_requests_total", "requests",
             "Terminal requests accounted, per tenant and class.")):
        metric(name, "counter", help_text,
               [([("tenant", tenant), ("class", cls)], c[field])
                for tenant, t in sorted(usage["tenants"].items())
                for cls, c in sorted(t["classes"].items())]
               or [([], 0)])

    def histogram(name, help_text, label, hist):
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} histogram")
        snap = hist.snapshot()
        lbl = (f'{label[0]}="{escape_label_value(label[1])}",'
               if label else "")
        for le, cum in snap["buckets"]:
            out.append(f'{name}_bucket{{{lbl}le="{le}"}} {cum}')
        suffix = "{" + lbl.rstrip(",") + "}" if label else ""
        out.append(f"{name}_sum{suffix} {snap['sum']:.6f}")
        out.append(f"{name}_count{suffix} {snap['count']}")

    for cls in sorted(engine.lat_hist):
        histogram("heat_tpu_serve_request_latency_seconds",
                  "End-to-end request latency (submit to terminal record), "
                  "per SLO class.", ("class", cls), engine.lat_hist[cls])
    histogram("heat_tpu_serve_queue_depth_observed",
              "Total queue depth observed at each accepted submit.",
              None, engine.depth_hist)
    return "\n".join(out) + "\n"


def usage_payload(engine: Engine) -> dict:
    """The ``GET /v1/usage`` body: the per-tenant usage ledger
    (runtime/prof.py) plus identity fields. Pure function of the engine
    so the exact-reconciliation test asserts on it without a socket.
    ``totals`` sums the same stamps every terminal record carries — the
    two views reconcile exactly by construction."""
    payload = engine.prof.ledger.snapshot()
    payload["prof"] = engine.scfg.prof
    payload["uptime_s"] = round(trace_mod.process_uptime_s(), 3)
    return payload


def status_payload(engine: Engine) -> dict:
    """The ``GET /v1/status`` body: the machine-readable twin of
    ``/statusz``, shaped for a fleet router's placement policy
    (heat_tpu/fleet/placement.py) — per-tenant queue depths, backlog
    step sums, the online cost-model rows (so the router can convert
    queue work into predicted backlog seconds), SLO burn gauges (the
    burn-aware demotion signal), mega capability (oversized-request
    routing), checkpoint generation (the steal handshake), and the
    prober counters the health checker folds in. Pure function of the
    engine so placement tests can assert on it without a socket; the
    handler adds the gateway-scoped fields (address, drained)."""
    s = engine.summary()
    pr = engine.prober.stats() if engine.prober is not None else None
    mega_lanes = int(s.get("mega_lanes", 0) or 0)
    return {
        "kind": "heat-tpu-engine-status",
        "uptime_s": round(trace_mod.process_uptime_s(), 3),
        "online": bool(engine.online),
        "draining": bool(engine.draining),
        "loop_error": (f"{type(engine.loop_error).__name__}: "
                       f"{engine.loop_error}"
                       if engine.loop_error is not None else None),
        "policy": s["policy"],
        "dispatch_depth": s["dispatch_depth"],
        "requests": {st: s.get(st, 0)
                     for st in (*TERMINAL_STATUSES, "queued", "running")},
        "queued_now": s.get("queued_now", 0),
        "queue_depths": engine.queue_depths(),
        "backlog": engine.backlog_snapshot(),
        "cost_model": s.get("cost_model") or [],
        "slo_burn": s.get("slo_burn") or {},
        "shed": s.get("shed", 0),
        "watchdog_fired": s.get("watchdog_fired", 0),
        "mega": {"lanes": mega_lanes,
                 "capable": mega_lanes > 0,
                 "buckets": [int(b) for b in engine.scfg.buckets],
                 "max_bucket": max((int(b) for b in engine.scfg.buckets),
                                   default=0)},
        "engine_ckpt": {"generation": s.get("engine_ckpt_generation", 0),
                        "interval": s.get("engine_ckpt_interval", 0),
                        "dir": engine.engine_ckpt_dir()},
        "cache": s.get("cache"),
        "serve_resumed": s.get("serve_resumed", 0),
        "probe": pr,
        "flightrec_dumps": engine.tracer.dumps,
    }


def render_statusz(engine: Engine) -> str:
    """The ``GET /statusz`` page: one human-readable snapshot of the
    serving process for an operator mid-incident — counters, the online
    cost model, compile observatory, memory watermarks, SLO burn, top
    tenants, flight-recorder dumps. Text on purpose: curl-able from any
    box with no dashboard in reach."""
    s = engine.summary()
    lines = [f"heat_tpu_torch serving engine — statusz "
             f"(uptime {trace_mod.process_uptime_s():.0f}s, "
             f"policy {s['policy']}, dispatch depth {s['dispatch_depth']}, "
             f"observatory {'on' if s['prof'] else 'OFF'})", ""]
    lines.append(
        f"requests: {s['requests']} total — "
        + ", ".join(f"{s.get(st, 0)} {st}" for st in
                    (*TERMINAL_STATUSES, "queued", "running")
                    if s.get(st)))
    pl = s.get("placement") or {}
    lines.append(
        f"placement: {pl.get('packed', 0)} packed / "
        f"{pl.get('mega', 0)} mega — {s.get('mega_lanes', 0)} mega "
        f"lane slot(s) (--mega-lanes; bucket-overflow requests run on "
        f"the mesh), {s.get('mega_compiles', 0)} mega compile(s)")
    lines.append(
        f"engine: {s['chunks_dispatched']} chunk(s) "
        f"({s['tail_chunks']} tail), {s['boundary_waits']} boundary "
        f"wait(s) {s['boundary_wait_s']:.3f}s, device idle "
        f"{s['device_idle_s']:.3f}s, {s['step_compiles']}+"
        f"{s['tail_compiles']} compiles {s['compile_s']:.2f}s, "
        f"{s['lane_grows']} lane grow(s), lane kernel "
        f"{s.get('lane_kernel', 'auto')} "
        f"({s.get('lane_kernel_fallbacks', 0)} fallback(s))")
    lines.append(
        f"faults: {s['lanes_quarantined']} quarantined, "
        f"{s['rollbacks']} rollback(s), {s['deadline_misses']} deadline "
        f"miss(es), {s['shed']} shed, {s['watchdog_fired']} watchdog")
    iv = s.get("engine_ckpt_interval", 0)
    lines.append(
        f"resume: engine checkpoint "
        f"{f'every {iv} boundaries' if iv else 'OFF (--engine-ckpt-interval 0)'}"
        f", last published generation {s.get('engine_ckpt_generation', 0)}, "
        f"{s.get('serve_resumed', 0)} request(s) re-admitted from a "
        f"checkpoint this incarnation")
    cache = s.get("cache")
    if cache is None:
        lines.append("solve cache: OFF (--cache off)")
    else:
        lines.append(
            f"solve cache: {cache['hits_full']} full / "
            f"{cache['hits_prefix']} prefix hit(s), "
            f"{cache['misses']} miss(es) of {cache['consults']} "
            f"consult(s), {cache['entries']} entr(ies) / "
            f"{cache['bytes'] / 2**20:.2f} MiB on disk "
            f"(budget {cache['max_bytes'] or 'unbounded'}, "
            f"{cache['evictions']} evicted, "
            f"{cache['quarantined']} quarantined) — {cache['dir']}")
    if s.get("numerics"):
        lines.append(
            f"numerics: guard {s.get('numerics_guard', 'warn')}, "
            f"{s.get('steady_lanes', 0)} steady lane(s), "
            f"{s.get('numerics_violations', 0)} violation(s); semantic "
            f"scheduling: {s.get('steady_exits', 0)} steady exit(s), "
            f"{s.get('steps_saved', 0)} step(s) saved")
        ns = engine.numerics.snapshot() if engine.numerics else None
        for rid, ln in sorted((ns or {}).get("lanes", {}).items()):
            if ln["resid_ewma"] is None:
                continue
            eta = ln.get("eta_steps")
            lines.append(
                f"  {rid}: resid ewma {ln['resid_ewma']:.3e}, heat "
                f"{ln['heat']:.6g}, range [{ln['tmin']:.4g}, "
                f"{ln['tmax']:.4g}] in [{ln['lo']:g}, {ln['hi']:g}]"
                f"{f', eta ~{eta} step(s)' if eta is not None else ''}"
                f"{' STEADY' if ln['steady'] else ''}"
                f"{' VIOLATED' if ln['violated'] else ''}")
    else:
        lines.append("numerics: observatory OFF (--numerics off)")
    pr = engine.prober.stats() if engine.prober is not None else None
    if pr is None:
        lines.append("prober: not armed (--probe-interval 0)")
    else:
        en = pr.get("last_error_norm")
        lines.append(
            f"prober: every {pr['interval_s']:g}s, {pr['passes']} pass / "
            f"{pr['fails']} fail ({pr['consecutive_failures']} "
            f"consecutive), last error norm "
            f"{'n/a' if en is None else format(en, '.3e')}, last latency "
            f"{pr.get('last_latency_s') or 0:.3f}s")
    cm = s.get("cost_model") or []
    lines.append("")
    lines.append(f"cost model ({len(cm)} key(s), s/lane-step EWMA; "
                 f"observed chunk boundaries):")
    if not cm:
        lines.append("  (no chunk boundaries observed yet)")
    for e in cm:
        ew = e["ewma_s_per_lane_step"]
        lines.append(
            f"  {e['bucket']} xL{e['lanes']} depth{e['depth']} "
            f"[{e.get('kernel', 'torch')}/{e.get('placement', 'packed')}]: "
            f"{'n/a' if ew is None else format(ew, '.3e')} s/lane-step "
            f"(p95 {e['p95_s_per_lane_step'] or 0:.0e}, "
            f"{e['chunks']} chunk(s), {e['wall_s']:.3f}s observed)")
    comp = s.get("compile", prof_mod.compile_log().summary())
    lines.append("")
    lines.append(
        f"compile observatory (process-wide): {comp['programs']} "
        f"program(s) / {comp['distinct']} distinct key(s), "
        f"{comp['total_s']:.2f}s total ({comp['first_s']:.2f}s first-time, "
        f"{comp['warm_s']:.2f}s warm re-compiles)")
    mem = s.get("mem") or {}
    lines.append(
        f"memory watermarks: peak "
        f"{(mem.get('peak_bytes') or 0) / 2**20:.1f} MiB, last "
        f"{(mem.get('last_bytes') or 0) / 2**20:.1f} MiB "
        f"({mem.get('source', 'unavailable')}; {mem.get('samples', 0)} "
        f"sample(s), {mem.get('warnings', 0)} leak warning(s))")
    burn = s.get("slo_burn") or {}
    lines.append("")
    lines.append("slo burn (dated requests; budget = 1 - target):")
    if not burn:
        lines.append("  (no dated traffic yet)")
    for cls, b in sorted(burn.items()):
        lines.append(
            f"  {cls}: target {b['target']:g}, burn fast "
            f"{b['fast_burn']:.2f}x / slow {b['slow_burn']:.2f}x, "
            f"hit fast {b['fast_hit_ratio']} / slow {b['slow_hit_ratio']} "
            f"({b['fast_events']}/{b['slow_events']} events, "
            f"{b['alerts']} alert(s))")
    usage = engine.prof.ledger.snapshot()
    tot = usage["totals"]
    lines.append("")
    lines.append(
        f"usage ledger: {tot['requests']} request(s), "
        f"{tot['lane_s']:.3f} lane-s, {tot['steps']} steps, "
        f"{tot.get('cached', 0)} cached, {tot['chunks']} chunk-slots, "
        f"{tot['bytes_written'] / 2**20:.2f} MiB written "
        f"(full detail: GET /v1/usage or the usage subcommand)")
    top = sorted(usage["tenants"].items(),
                 key=lambda kv: -kv[1]["lane_s"])[:5]
    for tenant, t in top:
        lines.append(
            f"  {tenant}: {t['lane_s']:.3f} lane-s, {t['steps']} steps "
            f"({t.get('steps_saved', 0)} saved, "
            f"{t.get('cached', 0)} cached), "
            f"{t['requests']} request(s), "
            f"{t['bytes_written'] / 2**20:.2f} MiB")
    if engine.tracer.dumps:
        lines.append("")
        lines.append(f"flight-recorder dumps ({engine.tracer.dumps}):")
        for p in engine.tracer.dump_paths:
            lines.append(f"  {p}")
    return "\n".join(lines) + "\n"


class Gateway:
    """The long-running front-end over one online :class:`Engine`.

    >>> gw = Gateway(Engine(scfg), "127.0.0.1", 0).start()
    >>> gw.address            # actual host:port (port 0 = ephemeral)
    >>> gw.request_drain()    # or POST /drainz
    >>> gw.wait_drained(30)
    >>> gw.close()
    """

    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 0, retry_after_s: float = 1.0,
                 stream_timeout_s: float = 600.0,
                 start_engine: bool = True, quiet: bool = True):
        self.engine = engine
        self.retry_after_s = retry_after_s
        self.stream_timeout_s = stream_timeout_s
        self._start_engine = start_engine
        self.quiet = quiet
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True   # a wedged client cannot hold
                                           # process exit hostage
        self.httpd.gateway = self          # handler back-pointer
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._drainer: Optional[threading.Thread] = None
        self._drain_lock = debug.make_lock("gateway:drain")
        self._drained = threading.Event()
        # race sanitizer (no-op unless HEAT_TPU_RACECHECK): engine and
        # httpd are object references on every handler's path — their
        # own fields are watched by their own instrumentation
        debug.instrument_races(
            self, label="Gateway",
            exempt=frozenset({"engine", "httpd"}))

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "Gateway":
        if self._start_engine:
            self.engine.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True,
                                        name="heat-tpu-gateway-http")
        self._thread.start()
        return self

    # --- drain ------------------------------------------------------------
    def request_drain(self, handoff: bool = False) -> bool:
        """Begin the graceful drain (idempotent): admission stops now,
        in-flight lanes and already-queued requests finish, then the
        scheduler exits. Returns True once fully drained.

        ``handoff=True`` (POST /drainz?handoff=1) is drain-to-checkpoint:
        instead of waiting for lanes to finish, the scheduler checkpoints
        the whole engine at the next empty-pipeline boundary and exits —
        a replacement process picks the work up with ``serve --resume``.
        Handoff wins over a concurrent plain drain (escalation is safe;
        de-escalation would strand in-flight work unfinished AND
        uncheckpointed)."""
        self.engine.begin_drain(handoff=handoff)
        with self._drain_lock:
            if self._drainer is None:
                self._drainer = threading.Thread(target=self._drain_worker,
                                                 daemon=True,
                                                 name="heat-tpu-gateway-drain")
                self._drainer.start()
        return self._drained.is_set()

    def _drain_worker(self) -> None:
        self.engine.shutdown()
        self._drained.set()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        return self._drained.wait(timeout)

    def close(self) -> None:
        """Tear the HTTP listener down (does NOT drain the engine — call
        request_drain/wait_drained first for a graceful exit)."""
        self.httpd.shutdown()
        self.httpd.server_close()


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 for chunked transfer encoding (the streaming response)
    protocol_version = "HTTP/1.1"

    @property
    def gw(self) -> Gateway:
        return self.server.gateway

    # --- plumbing ---------------------------------------------------------
    def log_message(self, fmt, *args):  # noqa: D102 — per-request stderr
        if not self.gw.quiet:           # lines would swamp serve output
            master_print(f"gateway: {self.address_string()} {fmt % args}")

    @property
    def trace_id(self) -> str:
        """The X-Trace-Id EVERY response to this request echoes: the
        client's inbound header when sane (so a client-side id survives
        the round trip even on a 4xx/5xx), else a freshly minted id.
        Cached per request; /v1/solve overrides it with the per-request
        ids it mints."""
        tid = getattr(self, "_trace_id", None)
        if tid is None:
            inbound = (self.headers.get("X-Trace-Id") or "").strip()
            tid = (inbound if _TRACE_ID_RE.match(inbound)
                   else self.gw.engine.tracer.mint_trace_id())
            self._trace_id = tid
        return tid

    def _send_headers(self, code: int, body_len: int, ctype: str,
                      headers=()) -> None:
        """Shared response-header path: the one place that guarantees the
        X-Trace-Id contract — an explicit
        X-Trace-Id in ``headers`` wins; every other response gets the
        request-scoped default, 429s and 400s and /drainz included."""
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

    @staticmethod
    def _sanitize(rec: dict) -> dict:
        return {k: v for k, v in rec.items() if k != "T"}

    # --- routes -----------------------------------------------------------
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        parts = urlsplit(self.path)
        path = parts.path
        eng = self.gw.engine
        if path == "/healthz":
            if eng.loop_error is not None:
                self._json(500, {"status": "error",
                                 "error": f"{type(eng.loop_error).__name__}: "
                                          f"{eng.loop_error}"})
            elif eng.draining:
                self._json(503, {"status": "draining",
                                 "drained": self.gw.wait_drained(0)},
                           headers=[("Retry-After",
                                     int(self.gw.retry_after_s))])
            else:
                self._json(200, {"status": "ok", "online": eng.online})
        elif path == "/metrics":
            self._text(200, render_metrics(eng),
                       "text/plain; version=0.0.4")
        elif path == "/statusz":
            self._text(200, render_statusz(eng), "text/plain; charset=utf-8")
        elif path == "/v1/usage":
            self._json(200, usage_payload(eng))
        elif path == "/v1/status":
            payload = status_payload(eng)
            payload["address"] = self.gw.address
            payload["drained"] = self.gw.wait_drained(0)
            self._json(200, payload)
        elif path == "/tracez":
            # the flight recorder's ring, on demand: a Chrome trace JSON
            # snapshot of the engine as it runs (loadable in Perfetto —
            # no fault required, no drain required)
            self._text(200, json.dumps(eng.tracer.to_chrome()),
                       "application/json")
        elif path == "/drainz":
            self._drainz(parts)
        elif path.startswith("/v1/requests/"):
            rid = path[len("/v1/requests/"):]
            rec = eng.poll(rid)
            if rec is None:
                self._json(404, {"error": f"unknown request id {rid!r}"})
            else:
                body = self._sanitize(rec)
                if parse_qs(parts.query).get("field", ["0"])[0] in ("1",
                                                                    "true"):
                    # ?field=1: inline the final field as nested JSON
                    # lists (f64 — bfloat16 is not JSON-spellable; its
                    # stored bits widen exactly). The canary prober
                    # verifies returned solutions through this, the same
                    # front door every client uses.
                    T = eng.field_of(rid)
                    if T is not None:
                        import numpy as np

                        from ..runtime.checkpoint import _from_storage

                        body["T"] = np.asarray(
                            _from_storage(np.asarray(T)),
                            dtype=np.float64).tolist()
                self._json(200, body,
                           headers=[("X-Trace-Id", rec["trace_id"])]
                           if rec.get("trace_id") else ())
        else:
            self._json(404, {"error": f"no route for GET {path}"})

    def do_POST(self):  # noqa: N802
        parts = urlsplit(self.path)
        if parts.path == "/drainz":
            self._drainz(parts)
        elif parts.path == "/v1/solve":
            self._solve(parts)
        elif parts.path == "/v1/resume":
            self._resume()
        elif parts.path == "/v1/cancel":
            self._cancel()
        else:
            self._json(404, {"error": f"no route for POST {parts.path}"})

    def _drainz(self, parts=None) -> None:
        """Idempotent graceful drain trigger (POST preferred; GET kept
        for curl ergonomics). ``?handoff=1`` checkpoints the engine at
        the next empty-pipeline boundary instead of finishing lanes —
        the zero-downtime handoff contract (see Gateway.request_drain)."""
        handoff = (parts is not None
                   and parse_qs(parts.query).get("handoff", ["0"])[0]
                   in ("1", "true"))
        drained = self.gw.request_drain(handoff=handoff)
        eng = self.gw.engine
        self._json(200, {"draining": True, "drained": drained,
                         "handoff": handoff,
                         "queued": sum(eng.queue_depths().values())})

    def _resume(self) -> None:
        """``POST /v1/resume`` body ``{"dir": PATH}``: re-admit the work
        a sibling engine checkpointed under ``PATH`` into THIS (live)
        engine through ``resume_engine``'s skip-set front door — the
        receiving half of the fleet router's checkpoint-handoff work
        steal (`/drainz?handoff=1` on the victim is the sending half).
        Returns the manifest generation plus the recovered/done id
        lists so the router knows exactly which orphans to poll here
        and which to re-drive fresh."""
        from . import resume as resume_mod

        eng = self.gw.engine
        if eng.draining:
            self._json(503, {"error": "draining: this backend cannot "
                                      "adopt work (/drainz)"},
                       headers=[("Retry-After",
                                 int(self.gw.retry_after_s))])
            return
        body = self._read_body()
        if body is None:
            return
        try:
            obj = json.loads(body.decode("utf-8", "replace") or "{}")
            resume_dir = obj["dir"]
        except (ValueError, KeyError, TypeError):
            self._json(400, {"error": "expected a JSON body "
                                      "{\"dir\": PATH}"})
            return
        try:
            # skip_known: the router's re-drive can race the manifest —
            # ids this engine already holds are skipped, not a conflict
            detail = resume_mod.resume_engine_detail(eng, resume_dir,
                                                     skip_known=True)
        except ValueError as e:
            # fingerprint mismatch: the manifest does not belong on
            # this backend — a structured conflict, not a 500
            self._json(409, {"error": str(e)})
            return
        self._json(200, detail)

    def _cancel(self) -> None:
        """``POST /v1/cancel`` body ``{"id": RID}``: deadline-preempt a
        queued or running request at its next chunk boundary (the fleet
        router's hedged-dispatch loser cancel; see Engine.cancel).
        ``{"cancelled": false}`` for unknown/terminal ids — cancelling
        finished work is a no-op, not an error."""
        body = self._read_body()
        if body is None:
            return
        try:
            rid = json.loads(body.decode("utf-8", "replace") or "{}")["id"]
        except (ValueError, KeyError, TypeError):
            self._json(400, {"error": "expected a JSON body "
                                      "{\"id\": REQUEST_ID}"})
            return
        self._json(200, {"id": rid,
                         "cancelled": self.gw.engine.cancel(str(rid))})

    # --- /v1/solve --------------------------------------------------------
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
        """One HTTP receive/parse/submit/stream span on the gateway
        handler thread's track — the front half of every request's flow
        (Engine.submit anchors the flow start on this same thread)."""
        tr = self.gw.engine.tracer
        if not tr.enabled:
            return self._solve_inner(parts)
        t0 = tr.now()
        try:
            self._solve_inner(parts)
        finally:
            tr.complete("POST /v1/solve", tr.thread_track("gateway"), t0,
                        cat="http")

    def _solve_inner(self, parts) -> None:
        gw, eng = self.gw, self.gw.engine
        if eng.draining:
            self._json(503, {"error": "draining: admission stopped "
                                      "(/drainz); retry against another "
                                      "replica"},
                       headers=[("Retry-After", int(gw.retry_after_s))])
            return
        # cross-host deadline propagation: the fleet edge mints the
        # budget and decrements it per hop/retry — if it arrives here
        # already spent, refuse to admit rather than start expired work
        # (the row would only be shed at the first chunk boundary after
        # burning device steps the tenant is never billed for).
        hdr = self.headers.get("X-Deadline-Ms")
        if hdr is not None:
            try:
                remaining_ms = float(hdr)
            except ValueError:
                self._json(400, {"error": f"bad X-Deadline-Ms {hdr!r}: "
                                          "expected milliseconds"})
                return
            if remaining_ms <= 0:
                self._json(504, {"error": "deadline: edge-minted budget "
                                          "exhausted before this hop; "
                                          "batch never admitted"})
                return
        body = self._read_body()
        if body is None:
            return
        wait = parse_qs(parts.query).get("wait", ["1"])[0] not in ("0",
                                                                   "false")
        # streaming responses need the listener registered BEFORE any
        # submit: a tiny request could otherwise finish in the gap
        results: queue_lib.Queue = queue_lib.Queue()
        listener = results.put
        if wait:
            eng.add_listener(listener)
        try:
            immediate, submitted = [], []
            for line in body.decode("utf-8", "replace").splitlines():
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                try:
                    row = parse_request_obj(json.loads(line))
                except Exception as e:  # noqa: BLE001 — per-line record
                    immediate.append({"id": None, "status": "rejected",
                                      "error": f"{type(e).__name__}: {e}"})
                    continue
                if row.error is not None:
                    immediate.append({"id": row.id, "status": "rejected",
                                      "error": row.error})
                    continue
                try:
                    submitted.append(submit_parsed(eng, row))
                except ValueError as e:   # duplicate id etc.
                    immediate.append({"id": row.id, "status": "rejected",
                                      "error": str(e)})
            if not immediate and not submitted:
                self._json(400, {"error": "empty body: expected one JSON "
                                          "request object per line"})
                return
            # backpressure: every submitted request shed at admission ->
            # 429 so well-behaved clients back off (Retry-After)
            snaps = {rid: eng.poll(rid) for rid in submitted}
            # every response names the request-scoped trace ids it minted
            # (one per submitted line, comma-joined) so a client log line
            # can be joined against /tracez and flight-recorder dumps
            tids = ",".join(str(r.get("trace_id"))
                            for r in snaps.values() if r.get("trace_id"))
            tid_hdr = [("X-Trace-Id", tids)] if tids else []
            overloaded = [rid for rid, r in snaps.items()
                          if r["status"] == "rejected"
                          and str(r.get("error", "")).startswith(
                              _OVERLOAD_PREFIX)]
            if submitted and len(overloaded) == len(submitted):
                eng_shed = [self._sanitize(snaps[rid]) for rid in submitted]
                body_out = {"error": "overloaded: admission queue full; "
                                     "retry after the indicated delay",
                            "records": immediate + eng_shed}
                self._json(429, body_out,
                           headers=[("Retry-After", int(gw.retry_after_s)),
                                    *tid_hdr])
                return
            if not wait:
                self._json(202, {"accepted": submitted,
                                 "records": immediate},
                           headers=tid_hdr)
                return
            self._stream(immediate, submitted, snaps, results,
                         headers=tid_hdr)
        finally:
            if wait:
                eng.remove_listener(listener)

    def _stream(self, immediate, submitted, snaps, results,
                headers=()) -> None:
        """Chunked NDJSON: parse-failure records first, then one record
        per submitted request in FINISH order, each written the moment
        its terminal record lands (listener-fed queue). Bounded by the
        gateway's stream timeout so a wedged engine cannot hold the
        socket forever."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        has_tid = False
        for k, v in headers:
            self.send_header(k, str(v))
            has_tid = has_tid or k == "X-Trace-Id"
        if not has_tid:
            self.send_header("X-Trace-Id", self.trace_id)
        self.end_headers()

        def chunk(obj) -> bool:
            data = (json.dumps(obj, sort_keys=True, default=str)
                    + "\n").encode()
            try:
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                return True
            except (BrokenPipeError, ConnectionResetError):
                return False   # client went away: stop relaying (the
                               # engine still finishes the requests)
        alive = True
        for rec in immediate:
            alive = alive and chunk(rec)
        pending = set(submitted)
        # records already terminal before the listener registered (the
        # submit itself rejected, or a racing tiny request)
        for rid in submitted:
            rec = snaps[rid]
            if rec["status"] in TERMINAL_STATUSES and rid in pending:
                pending.discard(rid)
                alive = alive and chunk(self._sanitize(rec))
        deadline = _monotonic() + self.gw.stream_timeout_s
        while pending and alive:
            try:
                rec = results.get(timeout=max(0.05,
                                              deadline - _monotonic()))
            except queue_lib.Empty:
                chunk({"error": f"stream timeout after "
                                f"{self.gw.stream_timeout_s:g}s; poll "
                                f"GET /v1/requests/<id> for the rest",
                       "pending": sorted(pending)})
                break
            rid = rec.get("id")
            if rid in pending:
                pending.discard(rid)
                alive = alive and chunk(self._sanitize(rec))
        try:
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass


def _monotonic() -> float:
    import time

    return time.monotonic()
