"""Asynchronous checkpoint pipeline: D2H + disk off the hot loop.

At a checkpoint boundary the drive loop (``backends.common.drive``) takes ONE
on-device clone of the field and resumes stepping immediately; a background
thread performs the device-to-host copy and the atomic-rename disk write.
This is ``heat_tpu.runtime.async_io``'s contract, unchanged:

- **Bounded queue** (default depth 2): a slow sink applies BACKPRESSURE —
  ``submit`` blocks the drive loop when the queue is full — rather than
  accumulating unbounded device snapshots (each is a full field buffer).
- **No snapshot is ever silently dropped**: ``drain`` flushes every queued
  snapshot before returning, and the drive loop calls it on BOTH the normal and
  the exception exit path.
- **Writer failures surface, promptly**: the first sink exception is
  re-raised on the next ``submit`` and again at ``drain``.
- **Transient sink errors are retried, bounded**: an ``OSError`` in the
  EIO/ENOSPC class gets up to ``retries`` re-attempts under exponential
  backoff before it becomes a surfaced failure.
- **Drain is bounded**: ``drain(timeout_s=...)`` raises ``TimeoutError``
  instead of blocking the exit path forever on a hung sink.
- **Accounting**: ``busy_s`` (writer wall time in fetch+write), ``wait_s``
  (drive-loop wall time blocked on the pipeline), and
  ``hidden_s = max(0, busy_s - wait_s)``, reported as ``Timing.overlap_s``.

The serving engine's half (``serve/``): ``d2h_async`` / ``lane_snapshot``
start a device-to-host copy into pinned memory behind the work already
queued and record an event, so a later wait blocks on that copy alone (a
plain ``tensor.cpu()`` would wait for every chunk queued on the stream);
``bounded_call`` puts a watchdog on such a wait.
"""

from __future__ import annotations

import errno
import queue
import threading
import time
from typing import Callable, Optional

from . import debug
from .logging import master_print

# Default queue depth: each entry pins one full-field device buffer, so the
# depth is a device-memory bound, not a tuning knob.
DEFAULT_DEPTH = 2

# Transient-sink retry policy: 3 re-attempts at 50/100/200 ms.
DEFAULT_RETRIES = 3
DEFAULT_RETRY_BACKOFF_S = 0.05

# drain() must never block an exit path forever (hung NFS mount).
DEFAULT_DRAIN_TIMEOUT_S = 600.0

_TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.ENOSPC, errno.EAGAIN, errno.EBUSY, errno.ETIMEDOUT,
    errno.EINTR,
})


class BoundedFetchTimeout(TimeoutError):
    """A watchdog-bounded device fetch did not complete in time (wedged
    device). The abandoned daemon thread may still be blocked on the
    transfer; the caller must treat the fetched-from state as lost."""


def bounded_call(fn: Callable[[], object], timeout_s: float,
                 what: str = "device fetch"):
    """Run ``fn`` in a daemon thread and wait at most ``timeout_s``.

    The boundary-fetch watchdog of the serving engine: a wait on a wedged
    device blocks uninterruptibly, so the only way to bound it is to move
    the blocking call off the waiting thread and abandon it on timeout.
    Exceptions raised by ``fn`` re-raise here; a timeout raises
    ``BoundedFetchTimeout``."""
    result: list = [None, None]     # [value, exception]
    done = threading.Event()

    def runner():
        try:
            result[0] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            result[1] = e
        finally:
            done.set()

    t = threading.Thread(target=runner, daemon=True,
                         name="heat-bounded-fetch")
    t.start()
    if not done.wait(timeout_s):
        raise BoundedFetchTimeout(
            f"{what} did not complete within {timeout_s:g}s (wedged "
            f"device fetch?) — abandoning the fetch thread")
    if result[1] is not None:
        raise result[1]
    return result[0]


def is_transient(e: BaseException) -> bool:
    """The retry-worthy class: OS-level errors that routinely clear on
    their own. Anything else fails fast on the first attempt."""
    return isinstance(e, OSError) and e.errno in _TRANSIENT_ERRNOS


class SnapshotWriter:
    """Background writer for device snapshots with a bounded queue.

    ``submit(job)`` enqueues a zero-arg callable (closing over the device
    snapshot) and returns as soon as there is queue room; the worker thread
    runs jobs in FIFO order. Start is lazy (a solve with no checkpoint
    boundary never spawns a thread); the thread is a daemon so a crashed
    drive loop that never drains cannot hang interpreter exit.
    """

    def __init__(self, depth: int = DEFAULT_DEPTH,
                 retries: int = DEFAULT_RETRIES,
                 retry_backoff_s: float = DEFAULT_RETRY_BACKOFF_S,
                 tracer=None):
        # ``tracer`` (runtime/trace.py, optional): each job becomes one
        # span on the writer thread's track. Callers label jobs by setting
        # a ``job._trace = (name, trace_id)`` attribute; unlabeled jobs
        # trace as "io-job". No tracer (the default) costs nothing.
        self._tracer = tracer
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue(
            maxsize=max(1, depth))
        self._thread: Optional[threading.Thread] = None
        # the one genuinely cross-thread cell: the worker publishes the
        # first sink error, submit/drain consume it. A ranked lock (not a
        # bare flag) so the hand-off is visible to the race sanitizer.
        self._exc_lock = debug.make_lock("writer:exc")
        self._exc: Optional[BaseException] = None
        self.retries = max(0, retries)
        self.retry_backoff_s = retry_backoff_s
        self.busy_s = 0.0     # writer wall time spent in D2H + disk write
        self.wait_s = 0.0     # drive-loop wall time blocked on the pipeline
        self.submitted = 0
        self.completed = 0    # jobs RUN (successfully or not) — drained
        self.attempts = 0     # job executions incl. transient retries
        # race sanitizer (no-op unless HEAT_TPU_RACECHECK): the exempt
        # fields carry allow[races] markers below — instance-confined
        # driver-side accounting the static client+driver union merges
        debug.instrument_races(
            self, label="SnapshotWriter",
            exempt=frozenset({"wait_s", "submitted", "_thread"}))

    @property
    def hidden_s(self) -> float:
        """I/O wall time hidden behind compute (``Timing.overlap_s``)."""
        return max(0.0, self.busy_s - self.wait_s)

    def _run_job(self, job: Callable[[], None]) -> None:
        """One job with bounded transient retry. Retry sleeps count toward
        ``busy_s`` (the caller times around this call): a retrying writer IS
        occupying the pipeline, so the accounting stays honest about what
        compute could and couldn't hide."""
        for attempt in range(self.retries + 1):
            self.attempts += 1
            try:
                job()
                return
            except BaseException as e:  # noqa: BLE001 — surfaced at the
                # next submit/drain; later snapshots still attempted
                if not (is_transient(e) and attempt < self.retries):
                    with self._exc_lock:
                        if self._exc is None:
                            self._exc = e
                    return
                delay = self.retry_backoff_s * (2 ** attempt)
                master_print(f"async checkpoint writer: transient sink error "
                             f"({e}); retry {attempt + 1}/{self.retries} "
                             f"in {delay:.2g}s")
                time.sleep(delay)

    def _worker(self) -> None:
        while True:
            job = self._q.get()
            try:
                if job is None:  # drain sentinel
                    return
                t0 = time.perf_counter()
                try:
                    self._run_job(job)
                finally:
                    self.busy_s += time.perf_counter() - t0
                    self.completed += 1
                    tr = self._tracer
                    if tr is not None and tr.enabled:
                        name, xid = getattr(job, "_trace",
                                            ("io-job", None))
                        tr.complete(name, tr.thread_track("writer"), t0,
                                    cat="io", trace_id=xid)
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        with self._exc_lock:
            exc, self._exc = self._exc, None
        if exc is not None:
            raise exc

    def submit(self, job: Callable[[], None]) -> None:
        """Enqueue a snapshot job; blocks when the queue is full
        (backpressure — bounded memory beats a snapshot pileup). Re-raises
        the first pending writer error instead of queueing behind it."""
        self._raise_pending()
        if self._thread is None:  # heat-tpu: allow[races] instance-confined — each writer's submit/drain side runs on the one thread that constructed it; the static client+driver union merges distinct instances
            self._thread = threading.Thread(
                target=self._worker, daemon=True, name="heat-snapshot-writer")
            self._thread.start()
        t0 = time.perf_counter()
        self._q.put(job)
        # heat-tpu: allow[races] instance-confined — same single-driver accounting as _thread above; the worker thread never touches these fields
        self.wait_s += time.perf_counter() - t0
        self.submitted += 1

    def drain(self, raise_errors: bool = True,
              timeout_s: Optional[float] = DEFAULT_DRAIN_TIMEOUT_S) -> None:
        """Flush every queued snapshot and stop the worker, within
        ``timeout_s`` (None = wait forever).

        ``raise_errors=False`` is the exception-exit form: snapshots still
        flush (nothing dropped) but a writer error is only logged — it must
        not mask the solve error already propagating. A drain that cannot
        finish inside the timeout (sink hung on a dead mount) raises
        ``TimeoutError`` (or logs, in the suppressed form) and abandons the
        daemon worker thread — bounded exit beats a wedged process."""
        t0 = time.perf_counter()
        hung = False
        if self._thread is not None:
            deadline = None if timeout_s is None else t0 + timeout_s
            try:
                # after all queued jobs: FIFO drain. The put itself can
                # block on a full queue behind a hung job — bound it too.
                self._q.put(None, timeout=None if deadline is None else
                            max(0.001, deadline - time.perf_counter()))
            except queue.Full:
                hung = True
            if not hung:
                self._thread.join(None if deadline is None else
                                  max(0.001, deadline - time.perf_counter()))
                hung = self._thread.is_alive()
            # heat-tpu: allow[races] instance-confined — drain runs on the writer's one driving thread; see submit
            self._thread = None  # abandoned if hung: daemon, dies with us
        self.wait_s += time.perf_counter() - t0
        if hung:
            msg = (f"async checkpoint writer failed to drain within "
                   f"{timeout_s:.0f}s (sink hung?) — abandoning the writer "
                   f"thread; queued snapshots may be lost")
            if raise_errors:
                raise TimeoutError(msg)
            master_print(msg)
            return
        if raise_errors:
            self._raise_pending()
        else:
            with self._exc_lock:
                exc = self._exc
            if exc is not None:
                master_print(f"async checkpoint writer error (suppressed "
                             f"while another error propagates): "
                             f"{type(exc).__name__}: {exc}")


def device_snapshot(T):
    """One on-device copy of the live field: the whole on-loop cost of an
    async checkpoint. The drive loop steps on with its two ping-pong buffers
    while the writer thread holds the copy until its D2H fetch."""
    import numpy as np

    if isinstance(T, np.ndarray):
        return np.array(T)
    return T.clone()   # a tensor, or the sharded backend's shards


class PendingCopy:
    """A device-to-host copy in flight: a pinned host tensor, filled by a
    non-blocking copy enqueued on the device's stream, and the event
    recorded right after it. ``wait()`` blocks on that event only — never
    on the chunks queued behind the copy — and returns the host tensor."""

    def __init__(self, src):
        import torch

        self.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        self.host.copy_(src, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(src.device))
        self._src = src   # alive until the copy is done (stream order)

    def wait(self):
        self.event.synchronize()
        self._src = None
        return self.host


def d2h_async(x):
    """Start the device-to-host copy of ``x``: a ``PendingCopy`` for a CUDA
    tensor; a CPU tensor is returned as it is (its bytes are already on
    the host, and nobody writes it afterwards)."""
    if x.device.type == "cuda":
        return PendingCopy(x)
    return x


def lane_snapshot(stacked, lane: int):
    """One-LANE copy out of a stacked ``(L, ...)`` lane array (or a view of
    one): a device clone enqueued behind the chunks already in flight, then
    its pinned non-blocking D2H copy and an event — so the scheduler resumes
    dispatching at once and only the writer thread (``host_fetch``) ever
    waits, on that event alone. One lane, not the stack: a finished lane
    must not drag the other L-1 lanes' bytes across the link."""
    return d2h_async(stacked[lane].clone())
