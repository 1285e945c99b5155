"""Command-line entry point: the ``program heat`` analog.

Keeps the reference's external contract: read ``input.dat`` from the
working directory, run the solve, write ``int.dat``/``soln.dat``, print the
familiar stdout lines ("simulation completed!!!!", timing) —
fortran/serial/heat.f90:11-13,50-55,73-83. The reference's build-time
variant choice becomes ``--backend`` / ``--variant``; ``SINGLE_PRECISION``
becomes ``--dtype``. Solves run on the card (``--device cuda``, the
default) unless ``--device cpu`` is given.

Usage: ``python -m heat_tpu_torch run [--backend cuda] [--json]``,
``python -m heat_tpu_torch serve --requests FILE.jsonl [--json]`` (the
serving engine: one ``<id>.npz`` per request with ``--out-dir``; with
``--listen HOST:PORT`` the online gateway, ``--resume DIR`` continues an
engine checkpoint), ``python -m heat_tpu_torch fleet --backends HOST:PORT,...`` (the fleet
router over ``serve --listen`` gateways), ``python -m heat_tpu_torch
trace FILE`` (a trace file's text summary), ``python -m heat_tpu_torch usage URL|FILE`` (the
per-tenant usage ledger), ``python -m heat_tpu_torch launch -n N -- run
--backend sharded ...`` (N worker processes in one ``torch.distributed``
world, the reference's ``mpirun -np N``), ``python -m heat_tpu_torch
perfcheck`` (the performance regression gate over the labs' committed
records), ``python -m heat_tpu_torch bench`` (the headline measurement)
and ``python -m heat_tpu_torch info``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

from .config import VARIANTS, HeatConfig, parse_input, variant_config
from .grid import coords, initial_condition
from .runtime import trace as trace_mod
from .runtime.logging import master_print


def _parse_mesh(s: str):
    try:
        dims = tuple(int(t) for t in s.lower().replace("x", " ").split())
    except ValueError:
        dims = ()
    if not dims or any(d < 1 for d in dims):
        raise argparse.ArgumentTypeError(
            f"mesh must be positive dims like '4x2', got {s!r}")
    return dims


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="heat-tpu-torch",
        description="heat-equation framework on PyTorch + CUDA "
        "(capability rebuild of CUDA-HIP-MPI-Heat-equation-test)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="solve the heat equation (input.dat contract)")
    run.add_argument("--input", default="input.dat",
                     help="input.dat path: 'n sigma nu dom_len ntime [soln]'")
    run.add_argument("--variant", choices=sorted(VARIANTS),
                     help="reference-variant preset (sets ic/bc/backend/dtype)")
    run.add_argument("--backend", choices=["serial", "torch", "cuda", "sharded"])
    run.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                     help="where device backends run (default cuda; the "
                          "serial oracle always runs on the host)")
    run.add_argument("--dtype", choices=["float64", "float32", "bfloat16"])
    run.add_argument("--ic", choices=["hat", "hat_half", "hat_small", "uniform", "zero"])
    run.add_argument("--bc", choices=["edges", "ghost", "periodic"])
    run.add_argument("--bc-value", type=float)
    run.add_argument("--ndim", type=int, choices=[2, 3])
    run.add_argument("--comm", choices=["direct", "staged"],
                     help="sharded halo exchange: device slabs sent "
                          "directly (CUDA-aware analog) or through host "
                          "memory (NO_AWARE analog)")
    run.add_argument("--exchange", choices=["seq", "indep", "overlap"],
                     help="halo exchange formulation: indep (seq, the "
                          "reference's other form with the same bytes, "
                          "runs it too), or overlap (the interior steps "
                          "while the halo flies, then the rim regions; "
                          "needs the stencil kernel)")
    run.add_argument("--mesh", type=_parse_mesh,
                     help="mesh of shards, e.g. 2x2 (sharded backend)")
    run.add_argument("--virtual-devices", type=int, metavar="N",
                     help="run N shards in this process on --device "
                          "(shard i on cuda:(i %% device_count)); the "
                          "single-process form of 'mpirun -np N'")
    run.add_argument("--local-kernel", choices=["auto", "torch", "cuda"],
                     help="sharded per-shard stepping: the stencil kernel "
                          "(cuda), the plain PyTorch step (torch), or auto "
                          "(the kernel on the card where one applies)")
    run.add_argument("--parity-order", action="store_true",
                     help="literal update-then-swap step ordering "
                          "(reference parity, mpi+cuda/heat.F90:206-219)")
    run.add_argument("--fuse-steps", type=int,
                     help="temporal blocking depth: steps per kernel call, "
                          "or per halo exchange when sharded (0=auto, 1=off)")
    run.add_argument("--heartbeat-every", type=int,
                     help="print 'time_it: i' every k steps (reference prints every step)")
    run.add_argument("--report-sum", action="store_true",
                     help="global temperature sum (the reference's "
                          "commented-out MPI_Reduce, made real)")
    run.add_argument("--checkpoint-every", type=int)
    run.add_argument("--checkpoint-dir")
    run.add_argument("--async-io", dest="async_io",
                     choices=["on", "off", "auto"],
                     help="checkpoint/numerics I/O pipeline: on = "
                          "snapshot-and-continue, off = sync fallback, "
                          "auto (default) = on")
    run.add_argument("--profile", dest="profile_dir", metavar="DIR",
                     help="write a torch.profiler trace of the solve to DIR")
    run.add_argument("--trace", metavar="FILE",
                     help="export the run's event timeline (warm-up, chunk "
                          "launch groups, checkpoint snapshots, background-"
                          "writer D2H+publish spans) as Chrome trace-event "
                          "JSON viewable in Perfetto / chrome://tracing "
                          "(HEAT_TPU_TRACE=FILE is the env spelling; "
                          "HEAT_TPU_TRACE=off disables recording)")
    run.add_argument("--trace-buffer", dest="trace_buffer", type=int,
                     metavar="N",
                     help="event-ring capacity (default "
                          f"{trace_mod.DEFAULT_BUFFER}; 0 disables "
                          "recording)")
    run.add_argument("--check-numerics", action="store_true",
                     help="detect NaN/Inf per chunk (debug)")
    run.add_argument("--on-nan", dest="on_nan", choices=["abort", "rollback"],
                     help="non-finite response under --check-numerics")
    run.add_argument("--inject", metavar="SPEC",
                     help="deterministic fault injection: comma-separated "
                          "'kind[@step][:key=val]...' — crash@N[:proc=P], "
                          "nan@N, ckpt-corrupt@N, ckpt-truncate@N, "
                          "sink-error@N[:times=K], sink-slow:ms=M")
    run.add_argument("--write-int", action=argparse.BooleanOptionalAction,
                     default=None,
                     help="dump the initial field to int.dat before solving")
    run.add_argument("--out", default="soln.dat", help="solution file path")
    run.add_argument("--soln", action="store_true",
                     help="force solution dump even if input.dat flag is 0")
    run.add_argument("--json", action="store_true",
                     help="also print a machine-readable result line")

    serve = sub.add_parser(
        "serve",
        help="serving engine: drain a JSONL file of solve requests as "
             "continuously-batched stacked lanes on the card")
    serve.add_argument("--requests", metavar="FILE.jsonl",
                       help="JSON Lines: one request object per line, keys "
                            "= HeatConfig physics fields (n, ntime, sigma, "
                            "nu, dom_len, ndim, dtype, ic, bc, bc_value, "
                            "inject) + optional id, deadline_ms, tenant, "
                            "class, until (steps|steady), tol; '#' lines "
                            "are comments. Optional with --listen (then "
                            "it pre-loads the file before serving) or "
                            "--resume")
    serve.add_argument("--listen", metavar="HOST:PORT",
                       help="run as a long-running online gateway instead "
                            "of a one-shot drain: POST /v1/solve admits "
                            "request lines into the running engine "
                            "(streamed records back), GET /metrics, "
                            "/healthz, /tracez, /statusz, /v1/usage, POST "
                            "/drainz for graceful drain (?handoff=1: "
                            "checkpoint and exit). Port 0 picks an "
                            "ephemeral port (printed). The process runs "
                            "until /drainz completes (or Ctrl-C, which "
                            "drains)")
    serve.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="where the lanes live (default cuda)")
    serve.add_argument("--lanes", type=int, default=4,
                       help="max concurrent requests per bucket group "
                            "(default 4)")
    serve.add_argument("--chunk", type=int, default=16,
                       help="steps per chunk — the swap granularity of "
                            "continuous batching (default 16)")
    serve.add_argument("--buckets", default="256,512,1024",
                       help="comma-separated grid-side buckets; a request "
                            "is padded up to the smallest side that fits "
                            "(default 256,512,1024)")
    serve.add_argument("--mega-lanes", dest="mega_lanes", default="auto",
                       metavar="auto|N",
                       help="second placement tier: requests whose side "
                            "overflows every bucket run as mega-lanes — ONE "
                            "request over every shard of the device mesh "
                            "(the sharded padded-carry advance, one shard "
                            "per card) co-scheduled with the packed lanes "
                            "— instead of being rejected. N = concurrent "
                            "mega-lane slots; 'auto' (default) = 1 on a "
                            "host with several cards, 0 on one card or the "
                            "CPU; 0 keeps the bucket-overflow rejection")
    serve.add_argument("--dispatch-depth", default="on", metavar="on|off|N",
                       help="chunks kept in flight per bucket group: 'on' "
                            "(default) = 2; N >= 1 explicitly; 'off' = "
                            "fully synchronous fallback (fence every "
                            "boundary)")
    serve.add_argument("--out-dir", metavar="DIR",
                       help="write each result as DIR/<id>.npz (atomic "
                            "publish); default: results stay in memory")
    serve.add_argument("--serve-lane-kernel", dest="serve_lane_kernel",
                       choices=["auto", "cuda", "torch"], default="auto",
                       help="chunk body per bucket: 'auto' (default) = the "
                            "hand-written lane kernels on the card wherever "
                            "the bucket has one (f32/bf16), the plain "
                            "PyTorch lane step elsewhere; 'cuda'/'torch' "
                            "force it (same bytes). An f64 bucket under "
                            "'cuda' degrades to torch as a structured "
                            "lane_kernel_fallback record, never an error")
    serve.add_argument("--serve-on-nan", dest="serve_on_nan",
                       choices=["fail", "rollback"], default="fail",
                       help="per-lane non-finite response (every chunk "
                            "boundary carries a device-computed isfinite "
                            "bit per lane): 'fail' (default) quarantines "
                            "the request — structured 'nonfinite' record, "
                            "lane freed, co-scheduled lanes untouched; "
                            "'rollback' restores that lane's last "
                            "verified-finite boundary snapshot and "
                            "re-steps it alone (transient poison recovers "
                            "bit-identically; deterministic blow-ups "
                            "quarantine after 2 retries)")
    serve.add_argument("--serve-deadline", dest="serve_deadline",
                       type=float, metavar="MS",
                       help="engine-default per-request wall budget in ms "
                            "from submission (a request's own deadline_ms "
                            "overrides): over-deadline lanes are preempted "
                            "at their next chunk boundary, queued requests "
                            "past it are shed (default: no deadline)")
    serve.add_argument("--max-queue", dest="max_queue", type=int,
                       metavar="N",
                       help="admission bound: submits beyond N queued "
                            "requests are shed with a structured "
                            "'overloaded' rejection (default: unbounded)")
    serve.add_argument("--fetch-watchdog", dest="fetch_watchdog",
                       type=float, metavar="SECONDS", default=600.0,
                       help="boundary-fetch watchdog: a chunk-boundary wait "
                            "exceeding this fails that bucket group's "
                            "requests cleanly (default 600; 0 = off)")
    serve.add_argument("--inject", metavar="SPEC",
                       help="engine-scoped deterministic fault injection "
                            "(runtime/faults.py grammar) incl. the "
                            "serve kinds: lane-nan@N[:req=ID] poisons a "
                            "lane's field once its request has run N "
                            "steps (no req= poisons every request); "
                            "perturb@N[:req=ID][:eps=E] adds a finite bump "
                            "instead; fetch-hang[@N]:ms=M hangs the Nth "
                            "boundary fetch M ms (watchdog exercise); "
                            "engine-kill@N kills the process at the Nth "
                            "boundary. Per-request specs ride each "
                            "request's own 'inject' key")
    serve.add_argument("--policy", choices=["fifo", "edf", "fair"],
                       default="fifo",
                       help="admission ordering: fifo (default, submit "
                            "order), edf (SLO class, then earliest "
                            "deadline), fair (weighted fair share across "
                            "tenants)")
    serve.add_argument("--tenant-weights", dest="tenant_weights",
                       metavar="NAME=W,...",
                       help="fair-share weights per tenant (policy=fair); "
                            "unlisted tenants weigh 1.0")
    serve.add_argument("--tenant-quota", dest="tenant_quota", type=int,
                       metavar="N",
                       help="per-tenant admission sub-quota: one tenant may "
                            "hold at most N queued requests")
    serve.add_argument("--numerics", default="on", metavar="on|off",
                       help="numerics observatory (runtime/numerics.py): "
                            "per-lane residual EWMAs, discrete-maximum-"
                            "principle + heat-jump detectors, steady-"
                            "state records — fed from the four per-lane "
                            "stats the lane kernels fuse into the boundary "
                            "vector (no extra device pass or transfer). "
                            "'off' = A/B baseline (stats still ride the "
                            "boundary; host ingestion off) (default on)")
    serve.add_argument("--steady-tol", dest="steady_tol", type=float,
                       default=1e-12, metavar="TOL",
                       help="residual-EWMA threshold below which a lane "
                            "with steps remaining emits one steady_state "
                            "record (interior max|dT| per mini-step), and "
                            "— for until=steady requests without their "
                            "own tol — the default tolerance at which the "
                            "lane RETIRES early with exit=steady "
                            "(default 1e-12)")
    serve.add_argument("--numerics-guard", dest="numerics_guard",
                       choices=["warn", "quarantine"], default="warn",
                       help="what a numerics_violation does: 'warn' = "
                            "structured record only; 'quarantine' = also "
                            "fail the request and free its lane (the "
                            "nonfinite quarantine path — co-scheduled "
                            "lanes untouched) (default warn)")
    serve.add_argument("--trace", metavar="FILE",
                       help="export the engine's event ring as Chrome "
                            "trace-event JSON at drain: per-lane occupancy "
                            "timelines, chunk pipelining, queue waits, "
                            "boundary fetches, writer publishes, with flow "
                            "arrows stitching each request's hops across "
                            "threads. HEAT_TPU_TRACE=FILE is the env "
                            "spelling; HEAT_TPU_TRACE=off disables "
                            "recording (the flight recorder included)")
    serve.add_argument("--trace-buffer", dest="trace_buffer", type=int,
                       metavar="N",
                       help="event-ring capacity (default "
                            f"{trace_mod.DEFAULT_BUFFER}). The ring is the "
                            "always-on flight recorder: even without "
                            "--trace, the last N events are dumped to "
                            "<out-dir>/flightrec-<ts>.trace.json when a "
                            "watchdog fires, a lane quarantines after its "
                            "rollback budget, a numerics violation fires "
                            "or the scheduler loop crashes; 0 disables "
                            "recording entirely")
    serve.add_argument("--prof", default="on", metavar="on|off",
                       help="cost observatory (runtime/prof.py): online "
                            "per-bucket chunk-cost model, per-tenant usage "
                            "ledger, memory watermarks + leak sentinel, "
                            "SLO burn-rate monitor — fed from timestamps "
                            "the scheduler already takes. 'off' = A/B "
                            "baseline (records keep their usage stamps; "
                            "aggregation off) (default on)")
    serve.add_argument("--slo-targets", dest="slo_targets",
                       metavar="CLASS=FRAC,...",
                       help="per-class SLO targets for the burn-rate "
                            "monitor, e.g. 'interactive=0.999,batch=0.8' "
                            "(deadline-hit fraction; error budget = "
                            "1 - target; defaults interactive=0.99, "
                            "standard=0.95, batch=0.9)")
    serve.add_argument("--mem-poll", dest="mem_poll", type=int,
                       metavar="N",
                       help="chunk boundaries between device-memory "
                            "watermark samples (leak sentinel; default "
                            "32, 0 = never sample)")
    serve.add_argument("--probe-interval", dest="probe_interval",
                       type=float, default=0.0, metavar="S",
                       help="with --listen: submit a known-answer canary "
                            "probe (sine-eigenmode request under the "
                            "reserved '_probe' tenant, verified against "
                            "its closed-form decay) through the real "
                            "gateway every S seconds (serve/probe.py; "
                            "0 = prober off, the default)")
    serve.add_argument("--engine-ckpt-interval", dest="engine_ckpt_interval",
                       type=int, default=0, metavar="N",
                       help="engine-state checkpoint cadence: every N "
                            "processed chunk boundaries the scheduler "
                            "pauses dispatch at the next empty-pipeline "
                            "cut and snapshots the whole engine — one "
                            "on-card copy per occupied lane (D2H on the "
                            "writer thread) plus a JSON manifest of lane "
                            "occupancy, queued requests and usage "
                            "partials, with a generation counter; a final "
                            "checkpoint always lands at drain. 0 = off "
                            "(default)")
    serve.add_argument("--engine-ckpt-dir", dest="engine_ckpt_dir",
                       metavar="DIR",
                       help="where engine-state generations live "
                            "(default: <--out-dir>/engine-ckpt, else "
                            "./engine-ckpt)")
    serve.add_argument("--cache", default="off", choices=["on", "off"],
                       help="solve cache (serve/solvecache.py): a request "
                            "whose physics fingerprint matches a finished "
                            "result is served from disk byte for byte "
                            "without a lane (billed cached, zero lane-"
                            "seconds/steps); a match at a smaller step "
                            "count seeds the lane and steps only the "
                            "delta (steps_saved). Default off")
    serve.add_argument("--cache-dir", dest="cache_dir", metavar="DIR",
                       help="where cache entries live (default: "
                            "<--out-dir>/solve-cache, else ./solve-cache)")
    serve.add_argument("--cache-max-bytes", dest="cache_max_bytes",
                       type=int, default=0, metavar="B",
                       help="LRU budget for the cache dir: after each "
                            "store, least-recently-hit entries are evicted "
                            "until total bytes <= B (0 = unbounded, the "
                            "default)")
    serve.add_argument("--resume", metavar="DIR",
                       help="crash-safe resume: before serving, rebuild "
                            "the engine from the newest valid engine "
                            "manifest in DIR — in-flight requests continue "
                            "at their last checkpointed boundary (byte-"
                            "equal to an uninterrupted run), queued "
                            "requests re-queue in policy order, usage "
                            "billing resumes from stamped partials; a "
                            "corrupt manifest is quarantined loudly and "
                            "discovery falls back one generation. "
                            "--requests rows whose ids the manifest "
                            "accounts for are skipped")
    serve.add_argument("--json", action="store_true",
                       help="also print the summary as one JSON line")

    fleet = sub.add_parser(
        "fleet",
        help="fleet router: one stdlib-HTTP front end over N "
             "independent `serve --listen` gateways — edge "
             "admission, burn-aware least-loaded placement fed from "
             "each backend's GET /v1/status, fleet-wide /metrics + "
             "/statusz + /v1/usage, health probes with retry-on-"
             "alternate, and checkpoint-handoff work stealing "
             "(drain a loaded backend to its engine manifest, resume "
             "it on an idle one — bit-identical bytes across the "
             "migration)")
    fleet.add_argument("--backends", metavar="[NAME=]HOST:PORT,...",
                       help="comma-separated backend gateways (each a "
                            "`serve --listen` process); unnamed "
                            "entries get positional names b0,b1,...")
    fleet.add_argument("--backends-file", dest="backends_file",
                       metavar="FILE",
                       help="backend registry file: one [name=]host:port "
                            "per line, '#' comments; re-read when its "
                            "mtime changes, so new backends join the "
                            "fleet live (removing a line never evicts a "
                            "live backend)")
    fleet.add_argument("--listen", default="127.0.0.1:0",
                       metavar="HOST:PORT",
                       help="router bind address (default 127.0.0.1:0 = "
                            "ephemeral port, printed)")
    fleet.add_argument("--fleet-policy", dest="fleet_policy",
                       choices=["least-loaded", "round-robin"],
                       default="least-loaded",
                       help="placement policy: 'least-loaded' (default) "
                            "ranks by predicted backlog seconds (cost "
                            "model x queue work) with burn-aware "
                            "demotion and mega-capability routing; "
                            "'round-robin' is the A/B baseline")
    fleet.add_argument("--health-interval", dest="health_interval",
                       type=float, default=2.0, metavar="S",
                       help="health-probe cadence: GET /healthz + "
                            "/v1/status per backend every S seconds "
                            "(default 2)")
    fleet.add_argument("--steal-threshold", dest="steal_threshold",
                       type=float, default=0.0, metavar="S",
                       help="work-stealing imbalance threshold in "
                            "predicted-backlog seconds: when "
                            "max-min exceeds S and the victim has "
                            "queued work, the router drains the victim "
                            "to a checkpoint (/drainz?handoff=1) and "
                            "resumes its manifest on the idlest backend "
                            "(default 0 = automatic stealing off)")
    fleet.add_argument("--steal-cooldown", dest="steal_cooldown",
                       type=float, default=10.0, metavar="S",
                       help="minimum seconds between automatic steals "
                            "(thrash guard; default 10)")
    fleet.add_argument("--cache-dir", dest="fleet_cache_dir",
                       metavar="DIR",
                       help="shared solve-cache dir (point it at the "
                            "same --cache-dir the backends publish "
                            "into): the router consults it read-only "
                            "before placement — a fleet-wide full hit "
                            "is served at the edge without touching any "
                            "backend, a prefix hit steers placement to "
                            "a cache-enabled backend")
    fleet.add_argument("--ckpt-root", dest="ckpt_root", metavar="DIR",
                       help="fallback checkpoint root: backend NAME's "
                            "engine manifests under DIR/NAME when its "
                            "status payload names no checkpoint dir "
                            "(default: trust each backend's "
                            "--engine-ckpt-dir as reported)")
    fleet.add_argument("--inject", metavar="SPEC",
                       help="fleet-scoped deterministic fault injection "
                            "(runtime/faults.py grammar): "
                            "backend-down@N[:backend=K] drops the TCP "
                            "target at the Nth forwarded request "
                            "(K names a backend; default = whichever "
                            "was chosen); backend-slow:ms=M sleeps "
                            "every forward M ms; "
                            "backend-flap:period=MS[:backend=K] square-"
                            "waves the target down/up per half-period; "
                            "stream-cut@N[:backend=K] breaks the relay "
                            "stream after N records while the backend "
                            "stays alive; "
                            "backend-partition[:ms=M][:backend=K] makes "
                            "every connect hang M ms then time out")
    fleet.add_argument("--breaker-trip", dest="breaker_trip", type=int,
                       default=3, metavar="N",
                       help="consecutive relay/probe errors that open a "
                            "backend's circuit breaker (default 3); an "
                            "open breaker excludes the backend from "
                            "placement and stealing until the sine "
                            "canary passes through the router path")
    fleet.add_argument("--breaker-cooldown", dest="breaker_cooldown",
                       type=float, default=5.0, metavar="S",
                       help="seconds an open breaker waits before its "
                            "half-open canary (default 5; doubles on "
                            "every failed canary, capped at 120)")
    fleet.add_argument("--retry-budget", dest="retry_budget",
                       type=float, default=20.0, metavar="TOKENS",
                       help="fleet-wide retry token bucket size "
                            "(default 20): each batch re-placement "
                            "spends one token, each delivered success "
                            "refills 0.2 — a dry bucket sheds instead "
                            "of amplifying overload")
    fleet.add_argument("--hedge-factor", dest="hedge_factor",
                       type=float, default=0.0, metavar="F",
                       help="tail-latency hedging for the interactive "
                            "class: duplicate a row onto a second "
                            "breaker-closed backend once it has waited "
                            "F x its predicted service time (+0.75s "
                            "floor); first terminal record wins, the "
                            "loser is cancelled at its next chunk "
                            "boundary (default 0 = off)")
    fleet.add_argument("--trace", metavar="FILE",
                       help="export the ROUTER's event ring at drain: "
                            "forward spans + synthesized backend solve "
                            "spans per backend track — one fleet "
                            "timeline (also GET /tracez live)")
    fleet.add_argument("--trace-buffer", dest="trace_buffer", type=int,
                       metavar="N",
                       help="router event-ring capacity (default "
                            f"{trace_mod.DEFAULT_BUFFER}); the ring is "
                            "flight-dumped on backend loss; 0 disables")
    fleet.add_argument("--json", action="store_true",
                       help="also print a machine-readable summary line")

    usage = sub.add_parser(
        "usage",
        help="per-tenant usage ledger: render lane-seconds / steps / "
             "chunks / bytes-written per tenant and SLO class, from a "
             "running gateway (GET /v1/usage) or from a saved stream of "
             "serve_request JSON records")
    usage.add_argument("source",
                       help="gateway base URL (http://HOST:PORT — "
                            "/v1/usage is fetched) or a file of "
                            "serve_request JSON lines (the offline "
                            "drain's stdout records)")
    usage.add_argument("--json", action="store_true",
                       help="print the raw ledger JSON instead of the "
                            "table")

    trc = sub.add_parser(
        "trace",
        help="render a text timeline summary from a trace file (a "
             "--trace export, a flightrec-*.trace.json dump, or a saved "
             "GET /tracez response): per-lane utilization, top "
             "queue-wait requests, boundary-fetch/device-idle totals")
    trc.add_argument("tracefile", help="Chrome trace-event JSON file")
    trc.add_argument("--top", type=int, default=5,
                     help="how many top queue-wait requests to list "
                          "(default 5)")

    launch = sub.add_parser(
        "launch",
        help="run N worker processes joined into one torch.distributed "
             "world on this machine (the reference's 'mpirun -np N', "
             "fortran/mpi+cuda/makefile:1-2)")
    launch.add_argument("-n", "--processes", type=int, default=2)
    launch.add_argument("--max-restarts", type=int, default=1, metavar="K",
                        help="after a worker dies, stop the world, validate "
                             "and quarantine the checkpoints, and relaunch "
                             "it to resume, up to K times with exponential "
                             "backoff (default 1; 0 disables). A failure "
                             "within 30 s with no checkpoint gets one more "
                             "try outside this budget")
    launch.add_argument("--deadline", type=float, metavar="S", default=3600.0,
                        help="wall-clock limit of each attempt in seconds; "
                             "at the deadline every worker is stopped and "
                             "launch exits 124, never restarted")
    launch.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="worker arguments, e.g.: -- run --backend "
                             "sharded --comm staged")

    chk = sub.add_parser(
        "check",
        help="invariant guard: run the project-native static-analysis "
             "suite (heat_tpu_torch/analysis) over the package source — "
             "hot-path purity, lock discipline, kernel-path determinism, "
             "CUDA kernel safety, record-schema drift, races. Exit 0 = "
             "clean; pure AST, no device, runs in seconds")
    chk.add_argument("--rules", metavar="LIST",
                     help="comma-separated rule families to run "
                          "(default: all; see --list-rules)")
    chk.add_argument("--list-rules", action="store_true",
                     help="print the rule-family table and exit")
    chk.add_argument("--update-schemas", action="store_true",
                     help="regenerate analysis/schemas/records.json and "
                          "guards.json from the current source instead of "
                          "gating against them — the intentional-drift "
                          "workflow: commit the registry diff with the "
                          "code change so the schema change is reviewed")
    chk.add_argument("--root", metavar="DIR",
                     help="package root to analyze (default: the "
                          "installed heat_tpu_torch package directory)")
    chk.add_argument("--json", action="store_true",
                     help="machine-readable results (one JSON object: "
                          "stats + violations)")
    chk.add_argument("--strict-allows", action="store_true",
                     help="fail on stale allow markers (markers whose "
                          "rule no longer fires at that site, or whose "
                          "rule id is unknown). Default: warn only — a "
                          "stale marker silently pre-authorizes a future "
                          "regression, but fixing it is a separate diff")
    chk.add_argument("--dead-code", action="store_true",
                     help="informational: list public package functions "
                          "unreachable from any entry point (tests, "
                          "benchmarks, module-level code, decorated "
                          "defs) and exit 0 — the closure is "
                          "conservative, so every listed function "
                          "really is unreferenced")

    pc = sub.add_parser(
        "perfcheck",
        help="performance regression gate: re-validate every committed "
             "lab record's gates (heat_tpu_torch/labs/artifacts), run a "
             "fresh observatory-overhead lab and the armed lockcheck and "
             "racecheck waves, compare the lab against the committed "
             "baseline within a tolerance band, and cross-check the "
             "online cost model against the static roofline prior")
    pc.add_argument("--fresh", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run a fresh prof_overhead_lab and the armed "
                         "waves and compare them to the committed baseline "
                         "(--no-fresh = only re-validate the committed "
                         "records; fast)")
    pc.add_argument("--tolerance", type=float, default=0.5,
                    help="relative band for fresh-vs-baseline throughput "
                         "(default 0.5 = within 50%% either way; the hard "
                         "gates are the labs' own)")
    pc.add_argument("--baseline",
                    help="baseline prof_overhead_lab JSON (default: the "
                         "committed one in --artifacts)")
    pc.add_argument("--artifacts", metavar="DIR",
                    help="directory of the lab records (default: the "
                         "committed heat_tpu_torch/labs/artifacts)")
    pc.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where --fresh runs the lab and the waves "
                         "(default cuda: raises without a card)")
    pc.add_argument("--requests", type=int,
                    help="--fresh: the lab's population (default its 64)")
    pc.add_argument("--repeats", type=int,
                    help="--fresh: the lab's runs per mode (default its 3)")

    aud = sub.add_parser(
        "audit",
        help="program auditor: dispatch every registered program family "
             "(solo advance, packed lane chunk/tail/rollback/loader, "
             "sharded mega-lane) at a small shape — on the card its hand "
             "kernels, with --device cpu their plain versions — and "
             "machine-check host syncs, buffer aliasing, dtype "
             "discipline and the lane-kernel launch budget. Exit 0 = all "
             "contracts hold")
    aud.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                     help="where the families run (default cuda: raises "
                          "without a card; cpu runs the plain versions)")
    aud.add_argument("--update-digests", action="store_true",
                     help="regenerate analysis/digests/launches.json "
                          "from the current source instead of gating "
                          "against it — the intentional-growth workflow: "
                          "commit the registry diff with the code change "
                          "so the budget change is reviewed")
    aud.add_argument("--contracts", metavar="LIST",
                     help="comma-separated contract families to check "
                          "(default: all; see --list-contracts)")
    aud.add_argument("--fast", action="store_true",
                     help="run only the cheap contracts (sync, aliasing, "
                          "launch budget), not the dtype sweep")
    aud.add_argument("--list-contracts", action="store_true",
                     help="print the contract-family table and exit")
    aud.add_argument("--registry", metavar="FILE",
                     help="launch-budget registry path (default: the "
                          "committed heat_tpu_torch/analysis/digests/"
                          "launches.json)")
    aud.add_argument("--json", action="store_true",
                     help="machine-readable report (one JSON object: "
                          "families, launches, budget, violations)")

    viz = sub.add_parser("viz", help="render a .dat file as a 3D surface "
                                     "(needs matplotlib)")
    viz.add_argument("datfile")
    viz.add_argument("--save", default="sol.png")
    viz.add_argument("--ndim", type=int, choices=[2, 3], default=2,
                     help="3: render the mid-plane slice of an x-y-z-T file")

    sub.add_parser("info", help="show devices / kernel toolchain / "
                                "native-lib / process-group status")

    plan = sub.add_parser(
        "plan", help="explain what the framework would run for a config: "
                     "kernel, the shape it sees, its passes and launches, "
                     "mesh, halo traffic (touches no device)")
    plan.add_argument("--input", default="input.dat")
    plan.add_argument("--variant", choices=sorted(VARIANTS))
    plan.add_argument("--backend", choices=["serial", "torch", "cuda",
                                            "sharded"])
    plan.add_argument("--dtype", choices=["float64", "float32", "bfloat16"])
    plan.add_argument("--ndim", type=int, choices=[2, 3])
    plan.add_argument("--mesh", type=_parse_mesh)
    plan.add_argument("--fuse-steps", type=int)
    plan.add_argument("--local-kernel", choices=["auto", "torch", "cuda"])
    plan.add_argument("--ic", choices=["hat", "hat_half", "hat_small",
                                       "uniform", "zero"])
    plan.add_argument("--bc", choices=["edges", "ghost", "periodic"])
    plan.add_argument("--comm", choices=["direct", "staged"])

    bench = sub.add_parser(
        "bench",
        help="headline throughput benchmark (grid points/s/card, f32 "
             "ftcs2d kernel): prints a human summary, then the JSON "
             "record that python -m heat_tpu_torch.bench prints")
    bench.add_argument("--n", type=int, default=0,
                       help="grid side (default 4096 on the card, 512 on "
                            "the CPU)")
    bench.add_argument("--steps", type=int, default=0,
                       help="timesteps per timed call (default 8192 on the "
                            "card, 256 on the CPU)")
    bench.add_argument("--repeats", type=int, default=3)
    bench.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="where the advance runs (default cuda; cpu "
                            "times the kernel's plain version)")

    cal = sub.add_parser(
        "calibrate",
        help="fit the pass planner's chip model on the card (a memory "
             "stream and the 2D/3D stencil sweeps, seconds on an H100) and "
             "write a record that HEAT_CHIP_CALIBRATION=<path> hands to "
             "the planner")
    cal.add_argument("--out", default="calibration.json")
    cal.add_argument("--quick", action="store_true",
                     help="tiny shapes (harness check; rates not "
                          "representative even on the card)")
    cal.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                     help="where the sweeps run (default cuda; a cpu record "
                          "is labelled untrustworthy)")
    return p


def _apply_overrides(cfg: HeatConfig, args) -> HeatConfig:
    """Fold CLI flags into the config."""
    over = {}
    for field in ("backend", "dtype", "ic", "bc", "ndim", "fuse_steps",
                  "heartbeat_every", "checkpoint_every", "checkpoint_dir",
                  "async_io", "profile_dir", "write_int", "on_nan", "inject",
                  "comm", "exchange", "local_kernel"):
        v = getattr(args, field, None)
        if v is not None:
            over[field] = v
    if getattr(args, "bc_value", None) is not None:
        over["bc_value"] = args.bc_value
    if getattr(args, "mesh", None):
        over["mesh_shape"] = tuple(args.mesh)
    for flag in ("report_sum", "check_numerics", "soln", "parity_order"):
        if getattr(args, flag, False):
            over[flag] = True
    return cfg.with_(**over)


def _warn_if_unstable(cfg: HeatConfig) -> None:
    """Warn when sigma exceeds the explicit FTCS stability bound 1/(2*ndim)
    (fortran/serial/heat.f90:15-17) — a warning, not an error, as in the
    reference."""
    from .models import get_model

    model = get_model(cfg)
    if not model.is_stable(cfg):
        lim = model.stability_limit()
        master_print(
            f"WARNING: sigma={cfg.sigma:g} exceeds the explicit FTCS "
            f"stability bound 1/(2*ndim)={lim:g} for ndim={cfg.ndim} — "
            f"the update can diverge to NaN/Inf; lower sigma (or run with "
            f"--check-numerics to catch the blow-up at its first step)")


def cmd_run(args) -> int:
    path = Path(args.input)
    if not path.exists():
        print(f"error: {path} not found (expected 'n sigma nu dom_len ntime [soln]')",
              file=sys.stderr)
        return 2
    cfg = parse_input(path)
    if args.variant:
        cfg = variant_config(args.variant, cfg)
    cfg = _apply_overrides(cfg, args)
    _warn_if_unstable(cfg)
    try:
        trace_path, trace_cap = trace_mod.resolve_trace(args.trace,
                                                        args.trace_buffer)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    tracer = trace_mod.configure(capacity=trace_cap)

    from .backends import resolve_device, solve
    from .ops import cuda_stencil

    try:  # no card where one was asked for
        device = None if cfg.backend == "serial" else resolve_device(args.device)
        if cfg.backend == "sharded":
            # join the world before any device work: the first act of the
            # reference's distributed variants (mpi_init + rank -> GPU
            # binding, fortran/mpi+cuda/heat.F90:60-70); a process started
            # alone joins nothing
            from .parallel.dist import init_distributed

            device = init_distributed(device, cfg.comm) or device
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    axes = coords(cfg)
    if cfg.write_int:
        from .io import write_int_dat

        write_int_dat("int.dat", axes, initial_condition(cfg))

    try:
        res = solve(cfg, device=device, virtual_devices=args.virtual_devices)
    except (NotImplementedError, ValueError) as e:  # a path later slices
        # bring, or a configuration the backend refuses
        print(f"error: {e}", file=sys.stderr)
        return 2
    for line in res.timing.report_lines():
        master_print(line)
    if trace_path:
        tracer.export(trace_path)
        master_print(f"wrote trace {trace_path} (open in Perfetto / "
                     f"chrome://tracing; summary: python -m heat_tpu_torch "
                     f"trace {trace_path})")
        from .backends import pinned

        master_print("field transfers: " + ", ".join(
            f"{k} {v}" for k, v in pinned.TALLY.items()))
    if res.gsum is not None:
        master_print(f"Sum of Temperature: {res.gsum:.10g}")

    if cfg.soln:
        _write_solution(args.out, axes, res)

    if args.json:
        rec = {
            "n": cfg.n, "ndim": cfg.ndim, "ntime": cfg.ntime,
            "backend": cfg.backend, "dtype": cfg.dtype, "device": res.device,
            "kernel": res.timing.kernel,
            "launches": dict(cuda_stencil.launches),
            "compile_s": res.timing.compile_s,
            "solve_s": res.timing.solve_s,
            "per_step_s": res.timing.per_step_s,
            "points_per_s": res.timing.points_per_s,
            "gsum": res.gsum,
            "gsum_dtype": res.gsum_dtype,
        }
        if res.timing.overlap_s is not None:
            rec["overlap_s"] = res.timing.overlap_s
            rec["io_wait_s"] = res.timing.io_wait_s
        if res.mesh_shape is not None:
            rec.update(mesh=list(res.mesh_shape), comm=cfg.comm,
                       exchange=cfg.exchange, **res.exchange)
        master_print(json.dumps(rec))
    return 0


def _write_solution(out: str, axes, res) -> None:
    """soln.dat, and for a decomposed run the per-shard ``soln#####.dat``
    files (shard number = linear mesh index, the reference's per-rank
    contract, mpi+cuda/heat.F90:277-288): from the gathered field in a
    single process, each rank its own shard in a world of several."""
    from .io import write_soln, write_soln_blocks, write_soln_sharded

    outdir = Path(out).parent
    if res.mesh_shape and any(s > 1 for s in res.mesh_shape):
        field = res.T_dev
        if len(field.comm.ranks) < field.comm.mesh.size:
            from .backends.common import host_fetch

            files = write_soln_sharded(
                outdir, axes, [(rank, host_fetch(o)) for rank, o in
                               zip(field.comm.ranks, field.owned())],
                res.mesh_shape)
            print(f"[rank {field.comm.rank}] wrote {len(files)} shard "
                  f"file(s) ({files[0].name} .. {files[-1].name})",
                  file=sys.stderr)
        else:
            files = write_soln_blocks(outdir, axes, res.T, res.mesh_shape)
            master_print(f"wrote {len(files)} per-shard files "
                         f"({files[0].name} .. {files[-1].name})")
    if res.T is not None:
        write_soln(out, axes, res.T)
        master_print(f"wrote {out}")


def _serve_report(summary: dict, ok: int, args) -> None:
    """The end-of-serve report: the reference's lines for what the port
    serves, and the summary as JSON with --json."""
    failed = summary["requests"] - ok - summary.get("rejected", 0)
    master_print(f"served {summary['requests']} request(s): {ok} ok, "
                 f"{summary.get('rejected', 0)} rejected, {failed} failed "
                 f"(device {summary['device']}, {summary['compile_s']:.3f}s "
                 f"loading kernels)")
    pl = summary.get("placement") or {}
    if pl.get("mega") or summary.get("mega_compiles"):
        master_print(f"placement: {pl.get('packed', 0)} packed, "
                     f"{pl.get('mega', 0)} mega (mesh-spanning sharded "
                     f"lanes; {summary.get('mega_lanes', 0)} slot(s), "
                     f"{summary.get('mega_compiles', 0)} mega machinery "
                     f"build(s), {summary.get('mega_chunks', 0)} mega "
                     f"chunk(s))")
    passes = summary.get("lane_passes") or {}
    master_print(f"dispatch: depth {summary['dispatch_depth']}, "
                 f"policy {summary['policy']}, "
                 f"lane kernel {summary['lane_kernel']}"
                 + (f" ({summary['lane_kernel_fallbacks']} bucket tier(s) "
                    f"fell back to the torch lane step)"
                    if summary["lane_kernel_fallbacks"] else "")
                 + f", {summary['chunks_dispatched']} chunk(s) "
                 f"({summary['tail_chunks']} tail)"
                 + "".join(f", {v} {k} launch(es)" for k, v in
                           sorted(passes.items()))
                 + f", {summary['boundary_waits']} boundary wait(s) totaling "
                 f"{summary['boundary_wait_s']:.3f}s, est. device idle "
                 f"{summary['device_idle_s']:.3f}s")
    if any(summary[k] for k in ("lanes_quarantined", "rollbacks",
                                "deadline_misses", "shed", "watchdog_fired")):
        master_print(f"fault domains: "
                     f"{summary['lanes_quarantined']} quarantined, "
                     f"{summary['rollbacks']} rollback(s), "
                     f"{summary['deadline_misses']} deadline miss(es), "
                     f"{summary['shed']} shed, "
                     f"{summary['watchdog_fired']} watchdog timeout(s)")
    if summary.get("numerics"):
        probes = ("" if "probe_pass" not in summary else
                  f"; probes {summary['probe_pass']} pass / "
                  f"{summary['probe_fail']} fail")
        master_print(f"numerics: {summary.get('steady_lanes', 0)} steady "
                     f"lane(s), {summary.get('numerics_violations', 0)} "
                     f"violation(s) (guard "
                     f"{summary.get('numerics_guard', 'warn')})" + probes)
    if summary.get("steady_exits"):
        master_print(f"semantic scheduling: {summary['steady_exits']} "
                     f"steady exit(s), {summary.get('steps_saved', 0)} "
                     f"step(s) saved")
    cache = summary.get("cache")
    if cache:
        master_print(f"solve cache: {cache['hits_full']} full hit(s), "
                     f"{cache['hits_prefix']} prefix hit(s), "
                     f"{cache['misses']} miss(es), "
                     f"{cache['entries']} entr(ies) / "
                     f"{cache['bytes'] / 2**20:.2f} MiB on disk, "
                     f"{cache['evictions']} evicted, "
                     f"{cache['quarantined']} quarantined "
                     f"({cache['dir']})")
    cm = summary.get("cost_model") or []
    if cm:
        tops = sorted(cm, key=lambda e: -e["wall_s"])[:3]
        more = f" (+{len(cm) - 3} more)" if len(cm) > 3 else ""
        master_print("cost model: " + "; ".join(
            f"{e['bucket']} xL{e['lanes']} d{e['depth']} "
            f"[{e['kernel']}/{e['placement']}]: "
            f"{e['ewma_s_per_lane_step'] or 0:.3e} s/lane-step "
            f"({e['chunks']} chunks)" for e in tops) + more)
    mem = summary.get("mem") or {}
    if mem.get("samples"):
        master_print(f"observatory: mem peak "
                     f"{(mem.get('peak_bytes') or 0) / 2**20:.1f} MiB "
                     f"({mem['source']}, {mem['samples']} sample(s), "
                     f"{mem['warnings']} leak warning(s)); "
                     f"{summary.get('flightrec_dumps', 0)} flight dump(s)")
    from .runtime.debug import guard_report

    guard = guard_report()
    if guard is not None:
        summary["invariant_guard"] = guard
        master_print(f"invariant guard (armed): "
                     f"{guard['lock_order_violations']} lock-order "
                     f"violation(s) over {guard['lock_order_edges']} "
                     f"observed edge(s), {guard['races_detected']} race(s) "
                     f"on {guard['race_instrumented']} instrumented "
                     f"object(s)")
    if args.json:
        master_print(json.dumps(summary, sort_keys=True))


def cmd_serve(args) -> int:
    """Drain a JSONL request file through the batched serving engine — or,
    with ``--listen``, run the long-lived online gateway over it.

    Offline: per-request structured records stream as JSON lines while
    lanes finish; the exit code is 0 only when every request served
    cleanly (a rejected or failed request is that request's record AND a
    nonzero exit). Online: the process serves HTTP until ``POST /drainz``
    completes (or Ctrl-C, which drains), then prints the same summary
    over everything it served. ``--resume DIR`` first rebuilds the engine
    from its newest valid checkpoint, before any file row or HTTP
    request."""
    from .backends import resolve_device
    from .config import (parse_dispatch_depth, parse_listen,
                         parse_mega_lanes, parse_on_off, parse_slo_targets,
                         parse_tenant_weights)
    from .serve import Engine, ServeConfig, serve_requests

    path = None
    if args.requests is not None:
        path = Path(args.requests)
        if not path.exists():
            print(f"error: {path} not found", file=sys.stderr)
            return 2
    elif args.listen is None and args.resume is None:
        print("error: need --requests FILE.jsonl, --listen HOST:PORT, "
              "--resume DIR, or a combination", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:  # no card where one was asked for
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        buckets = tuple(int(b) for b in str(args.buckets).split(",") if b)
        listen = parse_listen(args.listen) if args.listen else None
        trace_path, trace_cap = trace_mod.resolve_trace(args.trace,
                                                        args.trace_buffer)
        scfg = ServeConfig(lanes=args.lanes, chunk=args.chunk,
                           buckets=buckets, out_dir=args.out_dir,
                           mega_lanes=parse_mega_lanes(args.mega_lanes),
                           dispatch_depth=parse_dispatch_depth(
                               args.dispatch_depth),
                           on_nan=args.serve_on_nan,
                           lane_kernel=args.serve_lane_kernel,
                           deadline_ms=args.serve_deadline,
                           max_queue=args.max_queue,
                           fetch_timeout_s=(args.fetch_watchdog
                                            if args.fetch_watchdog else None),
                           inject=args.inject or "",
                           policy=args.policy,
                           tenant_weights=parse_tenant_weights(
                               args.tenant_weights or ""),
                           tenant_quota=args.tenant_quota,
                           trace=trace_path, trace_buffer=trace_cap,
                           prof=parse_on_off(args.prof, "--prof"),
                           slo_targets=parse_slo_targets(
                               args.slo_targets or ""),
                           numerics=parse_on_off(args.numerics, "--numerics"),
                           steady_tol=args.steady_tol,
                           numerics_guard=args.numerics_guard,
                           engine_ckpt_interval=args.engine_ckpt_interval,
                           engine_ckpt_dir=args.engine_ckpt_dir,
                           cache=parse_on_off(args.cache, "--cache"),
                           cache_dir=args.cache_dir,
                           cache_max_bytes=args.cache_max_bytes,
                           **({"mem_poll_every": args.mem_poll}
                              if args.mem_poll is not None else {}))
        if args.probe_interval < 0:
            raise ValueError(f"--probe-interval must be >= 0, got "
                             f"{args.probe_interval}")
        if args.probe_interval and args.listen is None:
            raise ValueError("--probe-interval needs --listen (the "
                             "prober probes the HTTP gateway)")
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    eng = None
    skip_ids = set()
    if args.resume is not None:
        # resume BEFORE any file rows or HTTP traffic: the manifest is the
        # authority on every request it accounts for (mid-solve progress
        # included); later submits only add new work
        from .serve.resume import resume_engine

        eng = Engine(scfg, device=device)
        try:
            skip_ids = resume_engine(eng, args.resume)
        except (ValueError, OSError) as e:
            print(f"error: --resume {args.resume} failed: {e}",
                  file=sys.stderr)
            return 2

    trace_note = (f"wrote trace {scfg.trace} (open in Perfetto / "
                  f"chrome://tracing; summary: python -m heat_tpu_torch "
                  f"trace {scfg.trace})")
    if listen is None:
        if path is not None:
            records, summary = serve_requests(path, scfg, engine=eng,
                                              device=device,
                                              skip_ids=skip_ids)
        else:
            records = eng.results()
            summary = eng.summary()
        ok = sum(1 for r in records if r["status"] == "ok")
        _serve_report(summary, ok, args)
        if scfg.trace:
            master_print(trace_note)
        return 0 if ok == summary["requests"] else 1

    # --- online gateway mode ---------------------------------------------
    from .serve import Gateway, load_requests, submit_parsed

    eng = eng if eng is not None else Engine(scfg, device=device)
    parse_failures = 0
    if path is not None:
        for row in load_requests(path):
            if row.id is not None and row.id in skip_ids:
                continue   # recovered (or finished) by --resume
            if row.cfg is None:
                parse_failures += 1
                master_print(f"serve: rejected request line: {row.error}")
            else:
                submit_parsed(eng, row)
    gw = Gateway(eng, listen[0], listen[1]).start()
    master_print(f"gateway listening on http://{gw.address} — "
                 f"POST /v1/solve (NDJSON), GET /v1/requests/<id>, "
                 f"/healthz, /metrics, /tracez, /statusz, /v1/usage; "
                 f"POST /drainz to drain (policy {scfg.policy}, device "
                 f"{eng.device})")
    prober = None
    if args.probe_interval:
        from .serve.probe import Prober

        prober = Prober(f"http://{gw.address}",
                        interval_s=args.probe_interval).start()
        eng.prober = prober   # /metrics + /statusz read stats() here
        master_print(f"prober armed: sine-eigenmode canary every "
                     f"{args.probe_interval:g}s through the real gateway "
                     f"path (tenant '_probe' — probe_result records; "
                     f"/metrics heat_tpu_probe_*)")
    try:
        gw.wait_drained()
    except KeyboardInterrupt:
        master_print("gateway: interrupt — draining (in-flight lanes "
                     "finish; Ctrl-C again to abandon)")
        gw.request_drain()
        gw.wait_drained()
    if prober is not None:
        prober.stop()
        ps = prober.stats()
        # the probe verdicts ride the end-of-serve summary
        probe_counts = {"probe_pass": ps["passes"],
                        "probe_fail": ps["fails"]}
    else:
        probe_counts = {}
    summary = eng.summary()
    summary.update(probe_counts)
    summary["requests"] += parse_failures
    if parse_failures:
        summary["rejected"] = summary.get("rejected", 0) + parse_failures
    ok = summary.get("ok", 0)
    _serve_report(summary, ok, args)
    if scfg.trace:
        master_print(trace_note)
    gw.close()
    if eng.loop_error is not None:
        print(f"error: scheduler loop failed: {eng.loop_error}",
              file=sys.stderr)
        return 1
    return 0 if ok == summary["requests"] else 1


def cmd_fleet(args) -> int:
    """Run the fleet router (``fleet/router.py``) until drained: the
    front end over N ``serve --listen`` backends. The router itself never
    touches a device — stdlib HTTP and placement arithmetic — while each
    backend serves on the card unless it was started with ``--device
    cpu``."""
    import time

    from .config import parse_listen
    from .fleet.registry import BackendRegistry, parse_backends
    from .fleet.router import FleetConfig, Router

    if not args.backends and not args.backends_file:
        print("error: need --backends HOST:PORT,... and/or "
              "--backends-file FILE", file=sys.stderr)
        return 2
    try:
        listen = parse_listen(args.listen)
        backends = parse_backends(args.backends) if args.backends else []
        trace_path, trace_cap = trace_mod.resolve_trace(args.trace,
                                                        args.trace_buffer)
        fcfg = FleetConfig(policy=args.fleet_policy,
                           health_interval_s=args.health_interval,
                           steal_threshold_s=args.steal_threshold,
                           steal_cooldown_s=args.steal_cooldown,
                           ckpt_root=args.ckpt_root,
                           cache_dir=args.fleet_cache_dir,
                           inject=args.inject or "",
                           breaker_trip=args.breaker_trip,
                           breaker_cooldown_s=args.breaker_cooldown,
                           retry_budget_cap=args.retry_budget,
                           hedge_factor=args.hedge_factor,
                           trace_buffer=trace_cap)
        registry = BackendRegistry(backends,
                                   backends_file=args.backends_file)
        if not registry.snapshot():
            raise ValueError("no backends: the --backends flag and the "
                             "--backends-file are both empty")
        rt = Router(registry, listen[0], listen[1], fcfg).start()
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    names = ", ".join(f"{b.name}={b.address}" for b in registry.snapshot())
    master_print(f"fleet router listening on http://{rt.address} — "
                 f"POST /v1/solve routes across [{names}] "
                 f"(policy {fcfg.policy}, steal threshold "
                 f"{fcfg.steal_threshold_s or 'off'}); GET /metrics "
                 f"/statusz /v1/status /v1/usage /tracez; POST /drainz "
                 f"stops admission")
    try:
        while not rt.draining:
            time.sleep(0.25)
        # admission stopped: let in-flight streams finish
        deadline = time.monotonic() + fcfg.stream_timeout_s
        while rt.pending_count() and time.monotonic() < deadline:
            time.sleep(0.25)
    except KeyboardInterrupt:
        master_print("fleet: interrupt — admission stopped (backends "
                     "keep their in-flight work; drain them "
                     "individually)")
        rt.request_drain()
    snap = rt.snapshot()
    if trace_path:
        rt.tracer.export(trace_path)
        master_print(f"wrote trace {trace_path} (open in Perfetto; "
                     f"summary: python -m heat_tpu_torch trace "
                     f"{trace_path})")
    r = snap["router"]
    master_print(f"fleet: drained — {r['requests']} routed, "
                 f"{r['edge_rejected']} rejected at the edge, "
                 f"{r['retries']} batch retries, {len(r['steals'])} "
                 f"steal(s), {r['lost']} backend(s) lost")
    if snap.get("cache") is not None:
        master_print(f"fleet: solve cache — {r['cache_edge_hits']} edge "
                     f"hit(s), {r['cache_prefix_hints']} prefix "
                     f"placement hint(s)")
    hd = r["hedges"]
    if (r["deadline_shed"] or r["brownout_shed"] or r["stream_cuts"]
            or hd["fired"] or r["retry_budget"]["denied"]):
        master_print(f"fleet: resilience — {r['deadline_shed']} "
                     f"deadline-shed, {r['brownout_shed']} brownout-"
                     f"shed, {r['stream_cuts']} stream cut(s) "
                     f"re-driven, {hd['fired']} hedge(s) fired "
                     f"({hd['won']} won, {hd['cancelled']} cancelled), "
                     f"{r['retry_budget']['denied']} retr(ies) denied "
                     f"by the budget")
    if args.json:
        print(json.dumps({"event": "fleet_summary", **r}, sort_keys=True))
    rt.close()
    return 0


def cmd_usage(args) -> int:
    """Render the per-tenant usage ledger as a table (or raw JSON) from a
    running gateway's ``GET /v1/usage`` or a saved stream of
    ``serve_request`` JSON records — the offline form re-aggregates the
    per-record usage stamps, so both sources reconcile by construction."""
    src = str(args.source)
    if src.startswith(("http://", "https://")):
        import urllib.request

        url = src.rstrip("/")
        if not url.endswith("/v1/usage"):
            url += "/v1/usage"
        try:
            with urllib.request.urlopen(url, timeout=30) as resp:
                payload = json.loads(resp.read().decode())
        except Exception as e:  # noqa: BLE001 — CLI boundary
            print(f"error: GET {url} failed ({type(e).__name__}: {e})",
                  file=sys.stderr)
            return 2
    else:
        path = Path(src)
        if not path.exists():
            print(f"error: {src} is neither an http(s) URL nor a file",
                  file=sys.stderr)
            return 2
        from .runtime.prof import UsageLedger, empty_usage

        ledger = UsageLedger()
        found = 0
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue   # records interleave with human report lines
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if d.get("event") != "serve_request":
                continue
            found += 1
            ledger.add(d.get("tenant") or "default",
                       d.get("class") or "standard",
                       d.get("status") or "?",
                       d.get("usage") or empty_usage(),
                       placement=d.get("placement"))
        if not found:
            print(f"error: no serve_request JSON records found in {src}",
                  file=sys.stderr)
            return 2
        payload = ledger.snapshot()
    if args.json:
        print(json.dumps(payload, sort_keys=True))
        return 0
    hdr = (f"{'tenant':<20} {'class':<12} {'requests':>8} {'lane_s':>10} "
           f"{'steps':>10} {'saved':>8} {'cached':>7} {'chunks':>8} "
           f"{'MiB':>8}")
    print(hdr)
    print("-" * len(hdr))

    def row(name, cls, c):
        print(f"{name:<20} {cls:<12} {c['requests']:>8} "
              f"{c['lane_s']:>10.3f} {c['steps']:>10} "
              f"{c.get('steps_saved', 0):>8} {c.get('cached', 0):>7} "
              f"{c['chunks']:>8} {c['bytes_written'] / 2**20:>8.2f}")

    for tenant, t in sorted(payload["tenants"].items()):
        for cls, c in sorted(t["classes"].items()):
            row(tenant, cls, c)
    print("-" * len(hdr))
    row("TOTAL", "", payload["totals"])
    return 0


def cmd_trace(args) -> int:
    """Text timeline summary of any trace file the port writes (``--trace``
    exports, flight-recorder dumps, ``/tracez`` responses): per-lane
    utilization, top queue-wait requests, boundary-fetch/device-idle wall,
    notable fault instants."""
    path = Path(args.tracefile)
    if not path.exists():
        print(f"error: {path} not found", file=sys.stderr)
        return 2
    try:
        lines = trace_mod.summarize_file(path, top=args.top)
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        print(f"error: {path} is not a Chrome trace-event JSON file "
              f"({type(e).__name__}: {e})", file=sys.stderr)
        return 2
    for line in lines:
        print(line)
    if "flightrec" in path.name:
        # a flight dump exists because something fired: name the likely
        # trigger from the notable instants (a numerics violation explains
        # any quarantine that followed it)
        ev_line = next((ln for ln in lines if ln.startswith("events: ")),
                       "")
        for marker, label in (
                ("numerics-violation", "numerics violation — the field "
                 "is finite but un-physical (numerics_violation records "
                 "carry the witnesses; TROUBLESHOOTING.md)"),
                ("watchdog-fired", "boundary-fetch watchdog timeout"),
                ("quarantine", "lane quarantine (nonfinite / rollback "
                 "budget exhausted)"),
                ("rollback", "NaN rollback")):
            if marker in ev_line:
                print(f"flight-dump triage: {marker} instant(s) present "
                      f"— likely trigger: {label}")
                break
    return 0


def _launch_ckpt_dir(cmd) -> Optional[str]:
    """The workers' checkpoint directory as the supervisor sees it, or
    None when they write no checkpoints."""
    if "--checkpoint-every" not in cmd and "--checkpoint-dir" not in cmd:
        return None
    if "--checkpoint-dir" in cmd:
        i = cmd.index("--checkpoint-dir")
        if i + 1 < len(cmd):
            return cmd[i + 1]
    return HeatConfig.checkpoint_dir


def cmd_launch(args) -> int:
    """Spawn N local workers joined into one ``torch.distributed`` world:
    torchrun (``torch.distributed.run --standalone``) run in this process,
    with a deadline per attempt, under a restart supervisor.

    Each worker runs the same command (SPMD) with the torchrun variables
    (the rendezvous of MPI_Init, fortran/mpi+cuda/heat.F90:60-62); rank 0
    alone prints results. When a worker dies torchrun stops the others (a
    peer blocked in a collective never returns). The supervisor then
    validates the checkpoint directory (``checkpoint.scan_resume_step``,
    which quarantines corrupt files) and relaunches the world to resume,
    up to ``--max-restarts`` times with exponential backoff, printing a
    ``launch: restart {json}`` record per attempt; the workers get
    ``HEAT_TPU_RESTART=<attempt>``, so restart-gated injected faults do not
    fire again. Each attempt is one torchrun with ``--max-restarts=0``:
    torchrun's own restarts would skip the quarantine and the records. A
    deadline (rc 124) is a budget, never restarted; otherwise the last
    attempt's failed worker's exit code is launch's.
    """
    import os
    import signal
    import time

    from torch.distributed.elastic.multiprocessing.errors import \
        ChildFailedError
    from torch.distributed.run import parse_args, run

    from .runtime import checkpoint
    from .runtime.faults import RESTART_ENV_VAR

    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("launch: missing worker arguments (e.g. "
              "`heat_tpu_torch launch -n 2 -- run --backend sharded`)",
              file=sys.stderr)
        return 2
    if args.processes < 1:
        print("launch: -n must be >= 1", file=sys.stderr)
        return 2
    ckpt_dir = _launch_ckpt_dir(cmd)

    class Deadline(Exception):
        pass

    def expire(*_):
        raise Deadline

    def attempt(restart: int):
        """One torchrun world: (rc, elapsed_s, reason)."""
        os.environ[RESTART_ENV_VAR] = str(restart)
        t0 = time.monotonic()
        # the exception unwinds torchrun's agent, whose shutdown stops the
        # workers
        old = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, args.deadline)
        try:
            run(parse_args(["--standalone",
                            f"--nproc-per-node={args.processes}",
                            "--max-restarts=0", "--monitor-interval=0.1",
                            "-m", "heat_tpu_torch", *cmd]))
            return 0, time.monotonic() - t0, None
        except Deadline:
            print(f"launch: deadline {args.deadline:g}s exceeded, the "
                  f"workers were stopped", file=sys.stderr)
            return 124, time.monotonic() - t0, "deadline"
        except ChildFailedError as e:
            rank, failure = e.get_first_failure()
            reason = f"worker {rank} exited rc={failure.exitcode}"
            print(f"launch: {reason}", file=sys.stderr)
            return (failure.exitcode if failure.exitcode > 0 else 1,
                    time.monotonic() - t0, reason)
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)

    # the workers' environment, set once: they import this package even
    # where it is only on the launcher's path; restored on return
    saved = dict(os.environ)
    root = str(Path(__file__).resolve().parent.parent)
    os.environ["PYTHONPATH"] = root + os.pathsep + saved.get("PYTHONPATH", "")
    backoff_base = float(os.environ.get("HEAT_TPU_RESTART_BACKOFF_S", "0.5"))
    restarts = 0
    startup_retry_used = False
    try:
        while True:
            rc, elapsed, reason = attempt(restarts)
            if rc == 0 or reason == "deadline":
                return rc
            resume_step = (checkpoint.scan_resume_step(
                ckpt_dir, nprocs=args.processes) if ckpt_dir else None)
            if resume_step is None and elapsed < 30 and not startup_retry_used:
                # a start-up failure (a port race, the environment): one
                # clean retry on a fresh port, outside the budget
                startup_retry_used = True
                print("launch: startup failure, retrying once on a fresh "
                      "port", file=sys.stderr)
                continue
            if restarts >= args.max_restarts:
                if args.max_restarts > 0:
                    print(f"launch: giving up after {restarts} restart(s) "
                          f"(--max-restarts {args.max_restarts})",
                          file=sys.stderr)
                return rc
            restarts += 1
            backoff = min(backoff_base * 2 ** (restarts - 1), 30.0)
            rec = {"event": "launch_restart", "attempt": restarts,
                   "max_restarts": args.max_restarts, "reason": reason,
                   "rc": rc, "elapsed_s": round(elapsed, 3),
                   "resume_step": resume_step, "backoff_s": backoff}
            print("launch: restart " + json.dumps(rec), file=sys.stderr,
                  flush=True)
            time.sleep(backoff)
    finally:
        os.environ.clear()
        os.environ.update(saved)


# the committed lab records perfcheck re-validates, with each record's
# gates: (field, predicate on the recorded value)
PERFCHECK_GATES = (
    ("serve_lab.json",
     (("bit_identical_sample", lambda v: v is True),
      ("one_compile_per_bucket_lane_tier", lambda v: v is True),
      ("aggregate_speedup", lambda v: (v or 0) >= 3.0))),
    ("trace_overhead_lab.json",
     (("full_within_2pct_of_off", lambda v: v is True),
      ("trace_export_nonempty", lambda v: v is True))),
    ("serve_chaos_lab.json",
     (("bit_identical_healthy_sample", lambda v: v is True),
      ("healthy_within_10pct", lambda v: v is True),
      ("all_poisoned_quarantined", lambda v: v is True))),
    ("serve_frontend_lab.json",
     (("edf_vs_fifo_hit_rate_delta", lambda v: (v or -1) >= 0),)),
    ("serve_lane_kernel_lab.json",
     (("bit_identical", lambda v: v is True),
      ("solo_sample_identical", lambda v: v is True),
      ("zero_fallbacks", lambda v: v is True))),
    ("lane_kernel_build_check.json",
     (("all_compile", lambda v: v is True),)),
    ("serve_mega_lab.json",
     (("mega_bit_identical", lambda v: v is True),
      ("zero_overflow_rejections", lambda v: v is True),
      ("packed_within_10pct", lambda v: v is True),
      ("packed_within_10pct_of_serve_lab", lambda v: v is True))),
    ("numerics_overhead_lab.json",
     (("on_within_2pct_of_off", lambda v: v is True),
      ("bit_identical_depth0", lambda v: v is True),
      ("bit_identical_depth2", lambda v: v is True),
      ("probe_verification_ok", lambda v: v is True))),
    ("serve_steady_lab.json",
     (("throughput_multiplier", lambda v: (v or 0) >= 1.5),
      ("steady_bit_identical", lambda v: v is True),
      ("colane_bit_identical", lambda v: v is True),
      ("zero_added_transfers", lambda v: v is True))),
    ("serve_resume_lab.json",
     (("resumed_bit_identical", lambda v: v is True),
      ("zero_resteps", lambda v: v is True),
      ("resumed_requests_recovered", lambda v: v is True))),
    ("serve_cache_lab.json",
     (("warm_speedup", lambda v: (v or 0) >= 5.0),
      ("full_hit_bit_identical", lambda v: v is True),
      ("prefix_delta_exact", lambda v: v is True),
      ("prefix_bit_identical", lambda v: v is True),
      ("cache_off_bit_identical", lambda v: v is True))),
    ("fleet_lab.json",
     (("speedup_2_backends", lambda v: (v or 0) >= 1.7),
      ("monotone_at_4", lambda v: v is True),
      ("fleet_bit_identical", lambda v: v is True),
      ("kill_zero_lost", lambda v: v is True),
      ("kill_zero_duplicates", lambda v: v is True),
      ("steal_recovered_requests", lambda v: (v or 0) >= 1),
      ("steal_recovery_s", lambda v: v is not None))),
    ("fleet_resilience_lab.json",
     (("flap_availability", lambda v: (v or 0) >= 0.99),
      ("flap_p99_ratio", lambda v: v is not None and v <= 1.5),
      ("flap_bit_identical", lambda v: v is True),
      ("cut_zero_lost", lambda v: v is True),
      ("cut_zero_duplicates", lambda v: v is True),
      ("hedges_won", lambda v: (v or 0) >= 1),
      ("hedge_bit_identical", lambda v: v is True),
      ("deadline_shed_exact", lambda v: v is True),
      ("breaker_steals_suppressed", lambda v: v is True))),
)


def _band_ok(ratio: float, tolerance: float) -> bool:
    """Symmetric relative band: ratio within [1-t, 1/(1-t)]."""
    lo = 1.0 - tolerance
    return lo <= ratio <= 1.0 / lo


def _armed_waves(env_var: str, armed_value: str, device) -> dict:
    """Best-of-2 walls of one serve wave (12 f32 requests at 48^2, lanes 4,
    chunk 8) unarmed and armed (``env_var=armed_value``), interleaved
    off/on/off/on in this process: the flag is read when a lock or an
    instrumented object is created, so each wave's engine takes its own
    mode."""
    import os
    import time

    from .serve import Engine, ServeConfig

    def wave() -> float:
        eng = Engine(ServeConfig(lanes=4, chunk=8, buckets=(64,),
                                 emit_records=False), device=device)
        for _ in range(12):
            eng.submit(HeatConfig(n=48, ntime=96, dtype="float32",
                                  ic="hat", bc="edges"))
        t0 = time.perf_counter()
        eng.run()
        return time.perf_counter() - t0

    walls = {"off": [], "on": []}
    prev = os.environ.pop(env_var, None)
    try:
        for mode in ("off", "on", "off", "on"):
            if mode == "on":
                os.environ[env_var] = armed_value
            else:
                os.environ.pop(env_var, None)
            walls[mode].append(wave())
    finally:
        if prev is None:
            os.environ.pop(env_var, None)
        else:
            os.environ[env_var] = prev
    return walls


def cmd_perfcheck(args) -> int:
    """The performance regression gate, in three layers, strict to
    informational:

    1. re-validate every committed lab record's own gates
       (``PERFCHECK_GATES``: a hand-edited or stale record fails loudly);
    2. with ``--fresh``, run ``python -m heat_tpu_torch.labs.
       prof_overhead_lab`` on ``--device``, require its gates and its rate
       within ``--tolerance`` of the committed baseline, and run the
       lock-order watchdog's and race sanitizer's overhead waves (zero
       inversions and zero findings are hard);
    3. cross-check the lane-kernel A/B's cost rows against its walls, and
       the learned cost model against a calibration (where the port has
       one) and against the auditor's static roofline prior. A speed
       check on the kernels, the calibration and the prior are hard on a
       ``cuda`` record, informational on the CPU.

    Prints one ``OK``/``FAIL`` line a check and the tally; exits 0 when
    every check passes, 1 otherwise, 2 without a baseline."""
    import os
    import re
    import subprocess
    import tempfile

    from .labs._util import ARTIFACTS, REPO

    adir = Path(args.artifacts) if args.artifacts else ARTIFACTS
    baseline_path = (Path(args.baseline) if args.baseline
                     else adir / "prof_overhead_lab.json")
    results: list = []

    def check(ok: bool, name: str, detail: str) -> None:
        results.append((ok, f"{name}: {detail}"))

    if not baseline_path.exists():
        print(f"error: baseline {baseline_path} not found (run python -m "
              f"heat_tpu_torch.labs.prof_overhead_lab first, or pass "
              f"--baseline)", file=sys.stderr)
        return 2
    base = json.loads(baseline_path.read_text())
    check(base.get("on_within_2pct_of_off") is True,
          "baseline overhead gate",
          f"observatory-on within 2% of off "
          f"(recorded {100 * base.get('on_overhead_frac', 0):+.2f}%)")
    check(bool(base.get("bit_identical_depth0"))
          and bool(base.get("bit_identical_depth2")),
          "baseline bit-identity",
          "npz outputs identical with observatory on vs off at depths "
          "0 and 2")
    check(base.get("usage_reconciles") is True, "baseline usage ledger",
          "ledger totals == sum of per-record usage stamps")

    for fname, gates in PERFCHECK_GATES:
        p = adir / fname
        if not p.exists():
            check(False, fname, "committed artifact missing")
            continue
        d = json.loads(p.read_text())
        for field, pred in gates:
            check(bool(pred(d.get(field))), fname, f"{field}={d.get(field)}")

    fresh = None
    if args.fresh:
        from .backends import resolve_device
        from .runtime import debug as _debug

        device = resolve_device(args.device)
        with tempfile.TemporaryDirectory(prefix="perfcheck_") as tmp:
            out = Path(tmp) / "fresh.json"
            cmd = [sys.executable, "-m", "heat_tpu_torch.labs.prof_overhead_lab",
                   "--out", str(out), "--device", device.type]
            for flag, v in (("--requests", args.requests),
                            ("--repeats", args.repeats)):
                if v is not None:
                    cmd += [flag, str(v)]
            env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep
                   + os.environ.get("PYTHONPATH", "")}
            rc = subprocess.call(cmd, env=env, cwd=str(REPO),
                                 stdout=subprocess.DEVNULL)
            check(rc == 0 and out.exists(), "fresh lab run",
                  f"prof_overhead_lab exited rc={rc}")
            if out.exists():
                fresh = json.loads(out.read_text())
        if fresh is not None:
            check(fresh.get("on_within_2pct_of_off") is True,
                  "fresh overhead gate",
                  f"{100 * fresh.get('on_overhead_frac', 0):+.2f}% "
                  f"(gate <= +2%)")
            check(bool(fresh.get("bit_identical_depth0"))
                  and bool(fresh.get("bit_identical_depth2")),
                  "fresh bit-identity", "npz on-vs-off at depths 0 and 2")
            b_pts = (base.get("on") or {}).get("points_per_s") or 0
            f_pts = (fresh.get("on") or {}).get("points_per_s") or 0
            if b_pts and f_pts:
                ratio = f_pts / b_pts
                check(_band_ok(ratio, args.tolerance),
                      "fresh-vs-baseline band",
                      f"throughput ratio {ratio:.3f} (tolerance "
                      f"±{100 * args.tolerance:.0f}%)")
            else:
                check(False, "fresh-vs-baseline band",
                      "points_per_s missing from lab output")

        # the lock-order watchdog's cost on a serve wave must stay at
        # noise level, and the armed waves must record no inversion
        _debug.reset_lock_order_stats()
        walls = _armed_waves("HEAT_TPU_LOCKCHECK", "1", device)
        ratio = min(walls["on"]) / min(walls["off"])
        check(_band_ok(ratio, max(args.tolerance, 0.5)),
              "lockcheck overhead",
              f"serve wave with the lock-order watchdog armed runs at "
              f"{ratio:.3f}x the unarmed wall (noise-level band)")
        stats = _debug.lock_order_stats()
        check(not stats["violations"], "lockcheck inversions",
              f"zero lock-order inversions under the armed waves "
              f"(saw {len(stats['violations'])}; edges observed: "
              f"{len(stats['edges'])})")

        # the race sanitizer likewise ("record" logs a finding instead of
        # raising, so a regression fails the check rather than the wave)
        _debug.reset_race_stats()
        walls = _armed_waves("HEAT_TPU_RACECHECK", "record", device)
        ratio = min(walls["on"]) / min(walls["off"])
        check(_band_ok(ratio, max(args.tolerance, 0.5)),
              "racecheck overhead",
              f"serve wave with the race sanitizer armed runs at "
              f"{ratio:.3f}x the unarmed wall (noise-level band)")
        rstats = _debug.race_stats()
        check(not rstats["findings"], "racecheck findings",
              f"zero race findings under the armed waves "
              f"(saw {len(rstats['findings'])}; objects instrumented: "
              f"{rstats['instrumented']})")
        _debug.reset_race_stats()

    # the lane-kernel A/B's cost rows: each side keyed by its own kernel,
    # their cuda/torch cost ratio consistent with the walls', and on a
    # card record the kernels must have won outright
    lane_path = adir / "serve_lane_kernel_lab.json"
    if lane_path.exists():
        lane = json.loads(lane_path.read_text())

        def agg_s_per_lane_step(side: dict):
            # work-weighted mean over the side's kernel-keyed cost rows
            wall = steps = 0.0
            for e in side.get("cost_model") or []:
                m = e.get("mean_s_per_lane_step")
                if m and e.get("wall_s"):
                    wall += e["wall_s"]
                    steps += e["wall_s"] / m
            return wall / steps if steps else None

        keyed_ok = all(
            {e.get("kernel") for e in
             (lane.get(side) or {}).get("cost_model") or []} <= {side}
            for side in ("cuda", "torch"))
        check(keyed_ok, "lane-kernel cost rows",
              "each A/B side's cost-model rows carry its own kernel key")
        sides = {k: lane.get(k) or {} for k in ("cuda", "torch")}
        agg_c = agg_s_per_lane_step(sides["cuda"])
        agg_t = agg_s_per_lane_step(sides["torch"])
        wall_c = sides["cuda"].get("wall_s", 0) - sides["cuda"].get(
            "compile_s", 0)
        wall_t = sides["torch"].get("wall_s", 0) - sides["torch"].get(
            "compile_s", 0)
        if agg_c and agg_t and wall_c > 0 and wall_t > 0:
            # the cost rows (chunk service) and the walls (end to end with
            # host bookkeeping) see the same A/B through different lenses:
            # a dilution factor is fine, an order of magnitude is a lie
            ratio = (agg_c / agg_t) / (wall_c / wall_t)
            check(0.25 <= ratio <= 4.0, "lane-kernel cost band",
                  f"cost-model cuda/torch ratio vs set-up-excluded wall "
                  f"ratio within 4x (consistency {ratio:.3f})")
        else:
            check(False, "lane-kernel cost band",
                  "cost-model rows or walls missing from the artifact")
        if str(lane.get("platform")) == "cuda":
            check(lane.get("cuda_beats_torch") is True,
                  "lane-kernel card gate",
                  f"cuda_vs_torch={lane.get('cuda_vs_torch')} (the lane "
                  f"kernels must beat the plain lane body on the card)")
        else:
            check(True, "lane-kernel perf (informational, platform="
                  f"{lane.get('platform')})",
                  f"cuda_vs_torch={lane.get('cuda_vs_torch')}, "
                  f"cuda_vs_solo={lane.get('cuda_vs_solo')}")

    rec = fresh or base
    cm = rec.get("cost_model") or []
    on_card = str(rec.get("platform", "")) == "cuda"
    # the learned model against a calibration of the card, where the port
    # has one (no calibration is committed yet: the check is skipped)
    cal_path = adir / "calibration_h100.json"
    if cal_path.exists() and cm:
        cal = json.loads(cal_path.read_text())
        cal_pts = (cal.get("sweep_2d") or {}).get("points_per_s")
        for e in cm:
            m = re.match(r"(\d)d/n(\d+)/", e["bucket"])
            per = e.get("ewma_s_per_lane_step")
            if not m or not per or not cal_pts:
                continue
            ndim, side = int(m.group(1)), int(m.group(2))
            implied = side**ndim / per
            ratio = implied / cal_pts
            line = (f"bucket {e['bucket']}: cost model implies "
                    f"{implied:.3e} pts/s = {100 * ratio:.2f}% of the "
                    f"calibrated stencil rate")
            if on_card:
                check(0.25 <= ratio <= 4.0, "calibration cross-check", line)
            else:
                check(True, "calibration cross-check (informational, "
                      f"platform={rec.get('platform')})", line)

    # the learned model against the auditor's static roofline prior (a
    # bytes-over-bandwidth floor, no measurement): agreement within an
    # order of magnitude catches a units bug in either
    if cm:
        from .runtime.prof import static_prior_s_per_lane_step

        for e in cm:
            per = e.get("ewma_s_per_lane_step")
            prior = static_prior_s_per_lane_step(
                e.get("bucket", ""), e.get("kernel", "torch"))
            if not per or not prior:
                continue
            ratio = per / prior
            line = (f"bucket {e['bucket']}: learned "
                    f"{per:.3e}s/lane-step = {ratio:.2f}x the static "
                    f"roofline prior {prior:.3e}s")
            if on_card:
                check(0.1 <= ratio <= 10.0, "static-prior band", line)
            else:
                check(True, "static-prior band (informational, "
                      f"platform={rec.get('platform')})", line)

    failed = [line for ok, line in results if not ok]
    for ok, line in results:
        print(("OK   " if ok else "FAIL ") + line)
    print(f"perfcheck: {'OK' if not failed else 'FAILED'} — "
          f"{len(results) - len(failed)}/{len(results)} checks passed")
    return 0 if not failed else 1


def cmd_check(args) -> int:
    """The invariant guard: run the AST-based checker suite over the
    package source. Exit codes: 0 clean, 1 violations, 2 usage error."""
    import dataclasses

    from .analysis import RULE_DOCS, RULE_FAMILIES, run_checks

    if args.list_rules:
        for rid in sorted(RULE_FAMILIES):
            print(f"{rid:<22} {RULE_DOCS[rid]}")
        return 0
    root = Path(args.root) if args.root else Path(__file__).resolve().parent
    if not root.is_dir():
        print(f"error: {root} is not a directory", file=sys.stderr)
        return 2
    if args.dead_code:
        from .analysis.deadcode import dead_code_report
        rows = dead_code_report(root)
        if args.json:
            print(json.dumps({"dead_code": rows}, sort_keys=True))
            return 0
        for row in rows:
            print(f"{row['path']}:{row['line']}: {row['qualname']} — "
                  "public function unreachable from any entry point")
        print(f"heat-tpu-torch check --dead-code: {len(rows)} candidate(s) "
              "(informational — the reachability closure is "
              "conservative, so these really are unreferenced)")
        return 0
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    try:
        violations, stats = run_checks(root, rules=rules,
                                       update_schemas=args.update_schemas,
                                       strict_allows=args.strict_allows)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({"stats": stats,
                          "violations": [dataclasses.asdict(v)
                                         for v in violations]},
                         sort_keys=True))
        return 0 if not violations else 1
    if not args.strict_allows:
        for s in stats.get("stale_allows", ()):
            print(f"warning: {s['path']}:{s['line']}: stale "
                  f"allow[{s['rule']}] marker — {s['why']} "
                  "(--strict-allows makes this fail)")
    for v in violations:
        print(v.format())
    per = ", ".join(f"{r}={n}" for r, n in sorted(stats["per_rule"].items())
                    if n) or "none"
    verdict = "OK" if not violations else "FAILED"
    print(f"heat-tpu-torch check: {verdict} — {stats['files']} file(s) and "
          f"{stats['cuda_files']} CUDA source(s), "
          f"{len(stats['rules'])} rule famil"
          f"{'y' if len(stats['rules']) == 1 else 'ies'}, "
          f"{stats['allow_markers']} allow marker(s), "
          f"{stats['violations']} violation(s)"
          + (f" ({per})" if violations else "")
          + ("; schema registries rewritten — review & commit the diff"
             if args.update_schemas else ""))
    if violations:
        print("each line is path:line: [rule] message; sanctioned "
              "exceptions take a `# heat-tpu: allow[rule] reason` marker "
              "(`// heat-tpu: ...` in a CUDA source)")
    return 0 if not violations else 1


def cmd_audit(args) -> int:
    """The program auditor: dispatch every registered program family at a
    small shape and machine-check the contracts the AST tier cannot see
    (host syncs, buffer aliasing, dtype discipline, the launch budget).
    Exit codes mirror ``check``: 0 clean, 1 violations, 2 usage error."""
    import dataclasses

    from .analysis.programs import CONTRACTS, FAST_CONTRACTS, audit

    if args.list_contracts:
        for cid, doc in sorted(CONTRACTS.items()):
            print(f"{cid:<18} {doc}")
        return 0
    contracts = ([c.strip() for c in args.contracts.split(",") if c.strip()]
                 if args.contracts else None)
    if args.fast:
        if contracts:
            print("error: --fast and --contracts are mutually exclusive",
                  file=sys.stderr)
            return 2
        contracts = list(FAST_CONTRACTS)
    try:
        violations, report = audit(device=args.device,
                                   registry_path=args.registry,
                                   update_digests=args.update_digests,
                                   contracts=contracts)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        report["violation_list"] = [dataclasses.asdict(v)
                                    for v in violations]
        print(json.dumps(report, sort_keys=True))
        return 0 if not violations else 1
    for v in violations:
        print(v.format())
    enum = report["budget"]["enumerated"]
    launched = sum(n for f in report["programs"].values()
                   for n in f["launches"].values())
    verdict = "OK" if not violations else "FAILED"
    print(f"heat-tpu-torch audit: {verdict} — "
          f"{report['dispatched']}/{report['families']} families "
          f"dispatched on {report['device']} ({launched} kernel "
          f"launch(es)), {len(report['contracts'])} contract"
          f"{'' if len(report['contracts']) == 1 else 's'}, launch budget "
          f"declared={report['budget']['declared']} "
          f"enumerated={enum['total'] if enum else 'n/a'}, "
          f"{report['violations']} violation(s)"
          + ("; launch registry rewritten — review & commit the diff"
             if args.update_digests else ""))
    return 0 if not violations else 1


def cmd_plan(args) -> int:
    """What the port would run for a config, without touching a device:
    the reference's ``config:``, stability, ``topology:``, ``mesh:`` and
    ``halo:`` lines (the same arithmetic and refusals), and a ``kernel:``
    line: the stencil kernel, the shape it sees (ghost or wrap padded, or
    the padded shard), its passes (``ops/pass_schedule``), launches per
    solve and its tile and segments as ``csrc/`` launches them."""
    import numpy as np

    path = Path(args.input)
    if not path.exists():
        print(f"error: {path} not found", file=sys.stderr)
        return 2
    cfg = parse_input(path)
    if args.variant:
        cfg = variant_config(args.variant, cfg)
    cfg = _apply_overrides(cfg, args)

    print(f"config: n={cfg.n}^{cfg.ndim} dtype={cfg.dtype} "
          f"ntime={cfg.ntime} backend={cfg.backend}")
    _warn_if_unstable(cfg)
    if cfg.bc == "periodic":
        # the pbc=.true. topology (mpi_cart_create periods,
        # mpi+cuda/heat.F90:76,97): closed ring, nothing pinned
        print("topology: periodic (torus) — bc_value unused, "
              "total heat conserved exactly")
    item = {"float64": 8, "float32": 4, "bfloat16": 2}[cfg.dtype]

    mesh_shape = w = None
    if cfg.backend == "sharded":
        from .backends.sharded import fuse_depth_sharded
        from .parallel.mesh import auto_mesh_shape

        mesh_shape = cfg.mesh_shape
        assumed = ""
        if mesh_shape is None:
            mesh_shape = auto_mesh_shape(8, cfg.ndim)
            assumed = " (auto; assuming 8 devices)"
        if len(mesh_shape) != cfg.ndim:
            print(f"error: mesh {mesh_shape} must have {cfg.ndim} dims",
                  file=sys.stderr)
            return 2
        for s in mesh_shape:
            if cfg.n % s != 0:
                print(f"error: grid {cfg.n} does not divide evenly over "
                      f"mesh axis of size {s} (run would reject this too)",
                      file=sys.stderr)
                return 2
        w = fuse_depth_sharded(cfg, mesh_shape)
        local = tuple(cfg.n // s for s in mesh_shape)
        print(f"mesh: {mesh_shape}{assumed}, "
              f"local block {'x'.join(map(str, local))}")

    if cfg.backend in ("cuda", "sharded"):
        from .ops.cuda_stencil import kernel_available, periodic_pad_width
        from .utils import torch_dtype

        dt = torch_dtype(cfg.dtype)
        if cfg.backend == "sharded":
            # the run path's gate (sharded.resolve_local_kernel): the
            # kernel at the padded shard shape
            shape = tuple(l + 2 * w for l in local)
            gate_ok = kernel_available(shape, dt)
            if cfg.local_kernel == "cuda" and not gate_ok:
                print(f"error: local_kernel='cuda' does not support "
                      f"dtype={cfg.dtype!r} at this size (run would reject "
                      f"this too)", file=sys.stderr)
                return 2
            if cfg.local_kernel == "torch" or not gate_ok or cfg.parity_order:
                print(f"kernel: torch mini-step path (local_kernel="
                      f"{cfg.local_kernel}, cuda gate "
                      f"{'ok' if gate_ok else 'unavailable'})")
            else:
                from .backends.sharded import launches_per_solve

                print("kernel (on the card; auto takes the torch step on "
                      "the CPU): " + _kernel_summary(
                          shape, cfg.dtype, w,
                          launches_per_solve(cfg, mesh_shape),
                          f"block on each of {int(np.prod(mesh_shape))} "
                          f"shards"))
        else:
            from .backends.cuda import fuse_depth, launches_per_solve

            kf = fuse_depth(cfg)
            shape = cfg.shape
            gate_ok = kernel_available(shape, dt)
            if cfg.bc == "ghost" and gate_ok:
                shape = tuple(s + 2 for s in shape)  # frozen ghost ring
            elif cfg.bc == "periodic" and gate_ok:
                # the wrap ring of the fused call's width, as
                # ftcs_multistep_periodic_cuda pads it
                ring = periodic_pad_width(shape, kf)
                shape = tuple(s + 2 * ring for s in shape)
            if not kernel_available(shape, dt):
                why = ("f64" if cfg.dtype == "float64"
                       else "no 3D kernel plan")
                print(f"kernel: torch-step ({why}) — the stencil kernels "
                      f"have no path here; the plain PyTorch step runs, as "
                      f"the reference takes its XLA step")
            else:
                print("kernel: " + _kernel_summary(
                    shape, cfg.dtype, kf, launches_per_solve(cfg),
                    "call"))

    if cfg.backend == "sharded":
        slab_cells = 2 * w * sum(
            int(np.prod(local)) // l for l in local)
        print(f"halo: width {w} every {w} steps -> "
              f"{slab_cells * item / 2**10:.1f} KiB sent/shard/exchange "
              f"({slab_cells * item / w / 2**10:.2f} KiB/step amortized)")
    return 0


def _kernel_summary(shape, dtype: str, ksteps: int, launches: int,
                    unit: str) -> str:
    """The kernel of a fused call of ``ksteps`` steps on ``shape``: its
    passes (``pass_schedule``; the first is the reference's ``plan_summary``
    per-pass chunk), launches per solve, and its tile and segments as the
    launch code defines them (``cuda_lab.STREAM_2D`` / ``STREAM_3D``: the
    segment length is picked per field on the card, from its resident
    blocks)."""
    from .ops import pass_schedule
    from .ops.cuda_lab import STREAM_2D, STREAM_3D

    passes = pass_schedule.passes(shape, dtype, ksteps)
    if len(shape) == 2:
        lz, rw = STREAM_2D
        name = "ftcs2d"
        tile = (f"tile: {rw}-wide column regions, 4 cells a thread "
                f"(256-wide over four warps at depth > 16)")
    else:
        lz, ty, tx = STREAM_3D
        name = "ftcs3d"
        tile = f"tile: {ty}x{tx} (mid, col) output tiles"
    return (f"{name} on {'x'.join(map(str, shape))} {dtype}; passes "
            f"{passes} per {ksteps}-step {unit} (per-pass chunk "
            f"{passes[0]}); {launches} launches per solve; {tile}, "
            f"segments of up to {lz} rows, sized on the card to fill whole "
            f"waves")


def cmd_viz(args) -> int:
    from .viz import MissingDependency, render_dat

    try:
        out = render_dat(args.datfile, args.save, ndim=args.ndim)
    except MissingDependency as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"wrote {out}")
    return 0


def cmd_bench(args) -> int:
    """The headline measurement inline (``benchmark.py``, shared with the
    supervised ``python -m heat_tpu_torch.bench``). The defaults shrink on
    the CPU so the command stays interactive there."""
    from .backends import resolve_device
    from .benchmark import N, STEPS, headline_measure

    if args.repeats < 1:
        print("bench: --repeats must be >= 1", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:  # no card where one was asked for
        print(f"bench: {e}", file=sys.stderr)
        return 2
    on_card = device.type == "cuda"
    n = args.n or (N if on_card else 512)
    steps = args.steps or (STEPS if on_card else 256)
    rec = headline_measure(n=n, steps=steps, repeats=args.repeats,
                           device=device)
    if rec["vs_baseline"] is not None:
        print(f"{rec['value']:.4g} points/s "
              f"({100 * rec['vs_baseline']:.0f}% of the one-pass-per-step "
              f"bound of {rec['device']}; raw single-call "
              f"{rec['raw_single_call']:.4g}) on {rec['platform']}, "
              f"{rec['launches_per_call']} {rec['kernel']} launches a call")
    else:
        print(f"{rec['value']:.4g} points/s on {rec['platform']} "
              f"(raw single-call {rec['raw_single_call']:.4g}; "
              f"{rec['baseline_chip']})")
    print(json.dumps(rec))
    return 0


def cmd_calibrate(args) -> int:
    from .calibrate import run as calibrate_run

    try:
        rec = calibrate_run(args.out, quick=args.quick, device=args.device)
    except RuntimeError as e:  # no card where one was asked for
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0 if rec.get("fit_complete") else 1


def cmd_info(_args) -> int:
    import torch

    from .io.native import native_available
    from .ops import _build
    from .parallel.dist import describe

    print(f"torch {torch.__version__}, CUDA runtime {torch.version.cuda}, "
          f"cuda available: {torch.cuda.is_available()}")
    if torch.cuda.is_available():
        from .machine import device_model

        for i in range(torch.cuda.device_count()):
            dm = device_model(i)
            peak = ("" if dm.peaks is None else
                    f", published HBM {dm.peaks.hbm_bytes_per_s / 1e12:.2f} TB/s "
                    f"({dm.peaks.source})")
            print(f"device {i}: {dm.name}, {dm.sm_count} SMs, "
                  f"{dm.mem_bytes / 2**30:.1f} GiB, L2 {dm.l2_bytes} B, "
                  f"opt-in shared memory/block {dm.smem_per_block_optin} B{peak}")
    nvcc = Path(_build.nvcc())
    print(f"nvcc: {nvcc if nvcc.exists() else 'not found'} "
          f"(kernels {', '.join(_build.KERNELS)} build on first CUDA launch "
          f"into {_build.build_dir()})")
    print(f"native fastio: "
          f"{'available' if native_available() else 'unavailable (numpy fallback)'}")
    import os

    from . import machine

    chip = machine.current()
    cal = os.environ.get("HEAT_CHIP_CALIBRATION")
    print(f"planner model: {chip.label} — "
          + (f"calibration {cal}" if cal else
             "machine.DEFAULT, the reference's off-TPU table "
             "(HEAT_CHIP_CALIBRATION unset)")
          + f"; HBM {chip.hbm_bytes_per_s / 1e9:.0f} GB/s, 2D "
          f"{chip.vpu_ops_per_s:.3g} ops/s, 3D {chip.ops_rate_3d:.3g} "
          f"ops/s (pass depths only; bounds use the data sheet)")
    print(describe())
    # two-tier placement: where a bucket-overflow request goes on THIS
    # host — the mesh a mega-lane would span and the auto default
    from .parallel.mesh import auto_mesh_shape
    from .serve import ServeConfig
    from .serve.scheduler import mega_device_count

    sd = ServeConfig()
    ndev = mega_device_count(torch.device(
        "cuda" if torch.cuda.is_available() else "cpu"))
    mshape = "x".join(map(str, auto_mesh_shape(ndev, 2)))
    print(f"serve placement: two-tier — packed lanes up to bucket "
          f"{max(sd.buckets)}, then sharded mega-lanes spanning the "
          f"{ndev}-device mesh ({mshape} for 2D); mega-lanes default "
          f"{1 if ndev > 1 else 0} on this host (--mega-lanes auto|N; 0 = "
          f"overflow stays a rejection"
          + (", the single-device behavior); " if ndev <= 1 else "); ")
          + "mega side must divide the mesh axes")
    # the fleet: one router process over N serve --listen gateways; the
    # dynamic story (placements, steals, lost backends) lives on the
    # router's /metrics and /statusz
    from .fleet.placement import BURN_THRESHOLD, POLICIES
    from .fleet.resilience import Breaker
    from .fleet.router import FleetConfig

    fc = FleetConfig()
    print(f"fleet serving: python -m heat_tpu_torch fleet --backends "
          f"host:port,... — edge admission + placement over per-backend "
          f"GET /v1/status (policies {'|'.join(POLICIES)}; burn demotion "
          f"at fast&slow > {BURN_THRESHOLD:g}, mega-capability routing), "
          f"health probes with retry-on-alternate, fleet-wide /metrics "
          f"/statusz /v1/usage, checkpoint-handoff work stealing "
          f"(--steal-threshold S; /drainz?handoff=1 -> POST /v1/resume on "
          f"the idlest backend, the same bytes)")
    print(f"fleet resilience: per-backend circuit breakers (trip after "
          f"{fc.breaker_trip} errors or {fc.breaker_burn_ticks} burn "
          f"ticks, cooldown {fc.breaker_cooldown_s:g}s doubling to "
          f"{Breaker.COOLDOWN_MAX_S:g}s; half-open re-admission via the "
          f"sine canary through the router path), retry budget "
          f"{fc.retry_budget_cap:g} tokens +{fc.retry_budget_ratio:g}"
          f"/success with jittered backoff (base "
          f"{fc.retry_backoff_s:g}s), X-Deadline-Ms propagation "
          f"(edge-minted, decremented per hop; expired rows shed with "
          f"zero device steps), --hedge-factor F interactive hedging "
          f"(floor {fc.hedge_floor_s:g}s, loser cancelled via POST "
          f"/v1/cancel), brownout sheds batch then standard when every "
          f"backend burns")
    # the invariant guard: the static-analysis suite, the committed
    # registries, and whether THIS process's locks and shared objects are
    # built with the dynamic watchdog / race sanitizer armed
    from .analysis import RULE_FAMILIES
    from .analysis.programs import (CONTRACTS, default_registry_path,
                                    enumerate_launch_keys,
                                    iter_program_specs)
    from .analysis.programs import load_registry as _load_budget
    from .analysis.races import load_guard_map
    from .analysis.schema import load_registry
    from .runtime import debug as _debug

    _adir = Path(__file__).resolve().parent / "analysis"
    _reg = load_registry(_adir / "schemas" / "records.json")
    print(f"static analysis: {len(RULE_FAMILIES)} rule families "
          f"(python -m heat_tpu_torch check: "
          f"{', '.join(sorted(RULE_FAMILIES))}), schema registry "
          f"{len((_reg or {}).get('events', {}))} event(s)"
          + ("" if _reg else " — MISSING, run heat-tpu-torch check "
             "--update-schemas") +
          f"; lock-order watchdog "
          f"{'ARMED' if _debug.lockcheck_enabled() else 'available'} "
          f"(HEAT_TPU_LOCKCHECK=1; order "
          + " < ".join(sorted(_debug.LOCK_RANKS,
                              key=_debug.LOCK_RANKS.get)) + ")")
    _gmap = load_guard_map(_adir / "schemas" / "guards.json")
    print(f"race guard: guard map "
          f"{len((_gmap or {}).get('fields', {}))} field(s)"
          + ("" if _gmap else " — MISSING, run heat-tpu-torch check "
             "--update-schemas") +
          f"; race sanitizer "
          f"{'ARMED' if _debug.racecheck_enabled() else 'available'} "
          f"(HEAT_TPU_RACECHECK=1 raises, =record logs + flight-dumps)")
    _budget = ((_load_budget(default_registry_path()) or {})
               .get("launch_budget") or {})
    print(f"program audit: {len(iter_program_specs())} program families "
          f"(python -m heat_tpu_torch audit [--device cpu]: "
          f"{', '.join(sorted(CONTRACTS))}), lane-kernel launch budget "
          f"declared={_budget.get('max_launch_keys')} "
          f"enumerated={enumerate_launch_keys()['total']}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"run": cmd_run, "serve": cmd_serve, "launch": cmd_launch,
            "fleet": cmd_fleet, "usage": cmd_usage, "trace": cmd_trace,
            "check": cmd_check, "audit": cmd_audit,
            "perfcheck": cmd_perfcheck, "info": cmd_info, "plan": cmd_plan,
            "viz": cmd_viz, "calibrate": cmd_calibrate,
            "bench": cmd_bench}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
