"""Black-box known-answer canary prober.

The port of ``heat_tpu.serve.probe``. The numerics observatory
(``runtime/numerics.py``) is white-box: it watches real traffic from
inside the scheduler. This is the black-box complement: a background
thread that periodically submits a tiny synthetic solve through the REAL
front door — HTTP ``POST /v1/solve`` on the gateway, the same
parse/admission/lane/writer path every client takes, the lane kernels
included — and verifies the returned field against a closed-form answer.

The canary is the ``sine`` IC preset (grid.py): the product of per-axis
``sin(pi * i/(n-1))`` samples is the fundamental discrete eigenmode of
the FTCS operator under frozen-edge BCs, so every step multiplies the
whole field by ``lambda = 1 - 4*ndim*r*sin^2(pi/(2*(n-1)))`` and step
``s`` equals ``lambda**s * T0`` (in exact arithmetic — the tolerance
covers float rounding over ``ntime`` steps with a wide margin). A
wrong-physics regression anywhere in the stack — stencil, chunking, lane
packing, a lane kernel, crop/publish — lands as a probe failure with a
concrete max-norm error.

Probes run under the reserved ``_probe`` tenant (their lane-seconds are
attributable in the usage ledger) and at class ``batch``. Each probe
emits a structured ``probe_result`` record; ``fail_after`` consecutive
misses emit one ``probe_failed`` record. ``/metrics`` exports pass/fail
totals, the consecutive-failure gauge, and the last error norm/latency;
``/statusz`` has a one-line summary.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import List, Optional

import numpy as np

from ..config import config_from_request
from ..grid import initial_condition, sine_decay_factor
from ..runtime.logging import json_record, master_print

# Reserved tenant for canary traffic: the usage ledger and queue-depth
# gauges key on it, so probe cost is always attributable and excludable.
PROBE_TENANT = "_probe"

# Max-norm verification tolerance per dtype: well above ntime steps of
# accumulated storage rounding on an O(1) field (f32 eps ~1e-7 * a few
# hundred steps), far below any real corruption — a single bit-flip in
# an exponent or a wrong-stencil regression misses by orders of
# magnitude.
PROBE_TOL = {"float64": 1e-9, "float32": 1e-3, "bfloat16": 5e-2}

# The canary request: tiny (one lane of the smallest default bucket for
# a handful of chunks), batch class (never preempts interactive
# traffic), frozen-edge BCs (the eigenmode argument needs them).
DEFAULT_PROBE_REQUEST = {
    "n": 64, "ndim": 2, "ntime": 200, "dtype": "float32",
    "ic": "sine", "bc": "edges",
}


class Prober:
    """Background canary thread against one gateway base URL.

    ``Prober(f"http://{gw.address}", interval_s=30).start()`` — or call
    :meth:`run_once` directly (tests, one-shot checks). The thread is a
    daemon named ``heat-tpu-prober`` and stops via :meth:`stop`.
    """

    def __init__(self, base_url: str, interval_s: float,
                 request: Optional[dict] = None, fail_after: int = 3,
                 timeout_s: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.interval_s = float(interval_s)
        self.request = dict(DEFAULT_PROBE_REQUEST, **(request or {}))
        self.fail_after = int(fail_after)
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()   # rank: observatory
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self.passes = 0
        self.fails = 0
        self.consecutive_failures = 0
        self.last_error_norm: Optional[float] = None
        self.last_latency_s: Optional[float] = None
        self.last_error: Optional[str] = None

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "Prober":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="heat-tpu-prober")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)

    def _loop(self) -> None:
        # first probe after one full interval: the engine is still
        # compiling its first real traffic at startup, and a probe racing
        # that compile would report its cost as probe latency
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception as e:  # noqa: BLE001 — the prober must
                # outlive any single probe's failure; the miss IS the data
                self._record(ok=False, error_norm=None, latency_s=None,
                             status="probe-error", trace_id=None,
                             error=f"{type(e).__name__}: {e}")

    # --- one probe --------------------------------------------------------
    def run_once(self) -> dict:
        """Submit one canary request and verify it; returns the verdict
        dict (also emitted as a ``probe_result`` record)."""
        with self._lock:
            self._seq += 1
            rid = f"_probe-{self._seq:04d}"
        payload = dict(self.request, id=rid, tenant=PROBE_TENANT,
                       **{"class": "batch"})
        cfg = config_from_request(payload)
        t0 = time.perf_counter()
        rec = self._submit(payload)
        status = rec.get("status")
        trace_id = rec.get("trace_id")
        if status != "ok":
            return self._record(
                ok=False, error_norm=None,
                latency_s=time.perf_counter() - t0, status=status,
                trace_id=trace_id,
                error=str(rec.get("error") or f"status {status}"))
        T = self._fetch_field(rid)
        latency = time.perf_counter() - t0
        if T is None:
            return self._record(ok=False, error_norm=None,
                                latency_s=latency, status=status,
                                trace_id=trace_id,
                                error="record has no field payload")
        # the closed-form answer, in f64: lambda**s * T0 (grid.py)
        lam = sine_decay_factor(cfg)
        expected = (lam ** cfg.ntime
                    * initial_condition(cfg).astype(np.float64))
        err = float(np.max(np.abs(np.asarray(T, dtype=np.float64)
                                  - expected)))
        tol = PROBE_TOL.get(cfg.dtype, PROBE_TOL["float32"])
        return self._record(
            ok=err <= tol, error_norm=err, latency_s=latency,
            status=status, trace_id=trace_id,
            error=(None if err <= tol
                   else f"error norm {err:.3e} exceeds tol {tol:g}"))

    def _submit(self, payload: dict) -> dict:
        """POST the probe line and return its terminal record (the
        streaming NDJSON response's line for our id)."""
        req = urllib.request.Request(
            f"{self.base_url}/v1/solve",
            data=(json.dumps(payload) + "\n").encode(),
            headers={"Content-Type": "application/x-ndjson"},
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            for line in resp.read().decode().splitlines():
                if not line.strip():
                    continue
                rec = json.loads(line)
                if rec.get("id") == payload["id"]:
                    return rec
        return {"status": "missing",
                "error": "no record for the probe id in the stream"}

    def _fetch_field(self, rid: str):
        url = f"{self.base_url}/v1/requests/{rid}?field=1"
        with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
            rec = json.loads(resp.read().decode())
        T = rec.get("T")
        return None if T is None else np.asarray(T, dtype=np.float64)

    # --- accounting -------------------------------------------------------
    def _record(self, ok: bool, error_norm, latency_s, status, trace_id,
                error=None) -> dict:
        with self._lock:
            if ok:
                self.passes += 1
                self.consecutive_failures = 0
            else:
                self.fails += 1
                self.consecutive_failures += 1
            self.last_error_norm = error_norm
            self.last_latency_s = latency_s
            self.last_error = error
            consecutive = self.consecutive_failures
        json_record("probe_result", ok=ok, error_norm=error_norm,
                    latency_s=latency_s, status=status,
                    trace_id=trace_id, error=error,
                    consecutive_failures=consecutive)
        if not ok and consecutive == self.fail_after:
            # the page-worthy signal, emitted ONCE per failure run: the
            # gateway answers but what it serves is wrong (or probes
            # cannot get through at all)
            master_print(f"prober: {consecutive} consecutive probe "
                         f"failures — last: {error}")
            json_record("probe_failed", consecutive=consecutive,
                        threshold=self.fail_after, last_error=error,
                        last_error_norm=error_norm)
        return {"ok": ok, "error_norm": error_norm, "latency_s": latency_s,
                "status": status, "trace_id": trace_id, "error": error}

    def stats(self) -> dict:
        """Point-in-time counters for /metrics and /statusz."""
        with self._lock:
            return {"interval_s": self.interval_s,
                    "passes": self.passes, "fails": self.fails,
                    "consecutive_failures": self.consecutive_failures,
                    "last_error_norm": self.last_error_norm,
                    "last_latency_s": self.last_latency_s,
                    "last_error": self.last_error}


def expected_probe_field(request: dict) -> "np.ndarray":
    """The analytic answer a probe request must return (f64): exposed so
    tests and the overhead lab certify verification without a prober."""
    cfg = config_from_request(request)
    lam = sine_decay_factor(cfg)
    return lam ** cfg.ntime * initial_condition(cfg).astype(np.float64)


def probe_urls(base_url: str) -> List[str]:
    """The endpoints one probe touches, for documentation/tests."""
    base = base_url.rstrip("/")
    return [f"{base}/v1/solve", f"{base}/v1/requests/<id>?field=1"]
