"""Headline benchmark, supervised: grid points/s/card on the 4096^2 f32
``ftcs2d`` kernel, printed as exactly one JSON line.

    python -m heat_tpu_torch.bench            # supervisor (run from the repo root)
    python -m heat_tpu_torch.bench --worker   # the measurement inline

The port of the repository root's ``bench.py`` capture contract. The
measurement (``heat_tpu_torch/benchmark.py``, shared with ``python -m
heat_tpu_torch bench``) runs in a worker subprocess under a hard timeout,
so a hung device or driver becomes a failed attempt. The supervisor
retries a timed-out attempt (and a worker that could not be spawned) with
backoff; a worker that exits without its line is a deterministic failure
(no card, an import error, a bug) and ends the ladder. Every attempt and
every backoff is scheduled against one total wall budget
(``HEAT_BENCH_TOTAL_BUDGET_S``, default 540 s). On SIGTERM, SIGINT or
SIGHUP the supervisor reaps the worker and prints the error line before it
dies. Whatever happens, the last line of
stdout is one JSON object carrying ``metric``: the worker's record (rc 0),
or an error line with ``value`` 0.0 and ``error`` (rc 1).

The supervisor imports neither torch nor any module of the package that
does: a broken install still yields a parseable line. So ``N``, ``STEPS``,
``REPEATS`` and ``METRIC`` are literals here, and the worker asserts that
they equal ``heat_tpu_torch.benchmark``'s.

The kernels build once per checkout into ``heat_tpu_torch/_build/``
(``ops/_build.py``), inside the first attempt's time. Every successful
worker caches its record in ``heat_tpu_torch/labs/artifacts/last_bench.json``
(``HEAT_BENCH_LAST_GOOD`` names another file); an error line carries it
under ``last_good`` when its metric is this one.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

N = 4096
STEPS = 8192
REPEATS = 3
# the supervisor must know the metric string without importing the
# package; the worker asserts it equals benchmark.metric_name(N)
METRIC = f"grid_points_per_sec_per_chip_{N}x{N}_f32_cuda"

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


# per-attempt wall: interpreter and torch start-up, the card's context, the
# first build of the kernel library (about a minute), then about a second
# of measurement; a hang detector, not a tight budget
ATTEMPT_TIMEOUT_S = _env_int("HEAT_BENCH_TIMEOUT_S", 420)
ATTEMPTS = _env_int("HEAT_BENCH_ATTEMPTS", 4)
# attempts AND backoff are scheduled against this one deadline; it must sit
# inside any external capturer's kill window
TOTAL_BUDGET_S = _env_int("HEAT_BENCH_TOTAL_BUDGET_S", 540)
# an attempt with less runway than this cannot finish even with the kernels
# built
_MIN_ATTEMPT_S = 45
BACKOFF_S = (15, 30, 60)

_LAST_GOOD = os.environ.get("HEAT_BENCH_LAST_GOOD") or os.path.join(
    _REPO, "heat_tpu_torch", "labs", "artifacts", "last_bench.json")


def measure() -> None:
    """The measurement itself (the supervised subprocess): one record from
    ``benchmark.headline_measure`` on the card, cached, printed and
    flushed."""
    from heat_tpu_torch import benchmark

    # the literals above stand for the measurement; the metric string
    # catches only N drift, so pin STEPS/REPEATS too
    assert (N, STEPS, REPEATS) == (benchmark.N, benchmark.STEPS,
                                   benchmark.REPEATS), (
        (N, STEPS, REPEATS), (benchmark.N, benchmark.STEPS,
                              benchmark.REPEATS))
    record = benchmark.headline_measure(n=N, steps=STEPS, repeats=REPEATS)
    assert record["metric"] == METRIC, (record["metric"], METRIC)
    try:  # best-effort cache; the measurement already succeeded
        tmp = _LAST_GOOD + ".tmp"
        os.makedirs(os.path.dirname(_LAST_GOOD), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(dict(record, measured_ts=time.time()), f, indent=2)
        os.replace(tmp, _LAST_GOOD)
    except OSError:
        pass
    # flush: the supervisor's salvage path needs the line in the pipe the
    # moment it exists, whatever teardown does afterwards
    print(json.dumps(record), flush=True)


def _parse_result_line(stdout: str):
    """The worker's result: the last stdout line that parses as a JSON
    object with this metric (stray output on stdout is tolerated)."""
    for line in reversed(stdout.strip().splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and obj.get("metric") == METRIC:
            return obj
    return None


def _error_line(err: str) -> str:
    rec = {"metric": METRIC, "value": 0.0, "unit": "points/s",
           "vs_baseline": 0.0, "error": err}
    try:  # the last real measurement, timestamped, never the headline
        with open(_LAST_GOOD) as f:
            cached = json.load(f)
        # a cache of another N/STEPS must not ride along on this metric
        if isinstance(cached, dict) and cached.get("metric") == METRIC:
            rec["last_good"] = cached
    except (OSError, json.JSONDecodeError):
        pass
    return json.dumps(rec)


def _worker_argv() -> list:
    return [sys.executable, "-m", "heat_tpu_torch.bench", "--worker"]


def _run_worker(holder, timeout: float) -> subprocess.CompletedProcess:
    """``subprocess.run`` that parks the live Popen in ``holder[0]`` so the
    signal backstop can reap it: an orphaned worker would hold the card for
    up to ATTEMPT_TIMEOUT_S after the supervisor died."""
    p = subprocess.Popen(_worker_argv(), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, cwd=_REPO)
    holder[0] = p
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
        raise subprocess.TimeoutExpired(p.args, timeout, output=out,
                                        stderr=err)
    finally:
        holder[0] = None
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


def supervise() -> int:
    """Run ``measure`` in a subprocess under the total wall budget; always
    print one parseable JSON line, also when killed from outside."""
    t0 = time.monotonic()
    deadline = t0 + TOTAL_BUDGET_S
    last_err = "no attempt ran"
    worker = [None]  # the in-flight Popen, visible to the signal handler

    def _die(signum, frame):  # noqa: ARG001 - a signal handler's signature
        # an external deadline beat the budget: reap the worker, print the
        # verdict, exit without interpreter teardown
        if worker[0] is not None:
            try:
                worker[0].kill()
            except OSError:
                pass
        print(_error_line(
            f"killed by signal {signum} at "
            f"{time.monotonic() - t0:.0f}s; last: {last_err}"), flush=True)
        os._exit(1)

    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        signal.signal(sig, _die)

    for attempt in range(1, ATTEMPTS + 1):
        remaining = deadline - time.monotonic()
        eff_timeout = min(ATTEMPT_TIMEOUT_S,
                          remaining - min(5.0, 0.1 * remaining))
        if eff_timeout < _MIN_ATTEMPT_S:
            last_err += (f" | budget exhausted before attempt {attempt} "
                         f"({TOTAL_BUDGET_S}s total)")
            break
        try:
            proc = _run_worker(worker, timeout=eff_timeout)
        except subprocess.TimeoutExpired as e:
            # the worker may have printed its result and then hung in
            # teardown: salvage the line before calling the attempt dead
            out = e.stdout or ""
            if isinstance(out, bytes):
                out = out.decode(errors="replace")
            result = _parse_result_line(out)
            if result is not None:
                print(json.dumps(result))
                return 0
            last_err = (f"attempt {attempt}: no result within "
                        f"{e.timeout:.0f}s (hung device or build?)")
        except OSError as e:  # spawn failure (ENOMEM etc.)
            last_err = f"attempt {attempt}: failed to spawn worker: {e}"
        else:
            result = _parse_result_line(proc.stdout)
            if result is not None:
                # a parsed result is a finished measurement even if
                # teardown failed afterwards
                print(json.dumps(result))
                return 0
            tail = ((proc.stderr or "") + (proc.stdout or "")).strip()
            last_err = (f"attempt {attempt}: rc={proc.returncode}: "
                        + " | ".join(tail.splitlines()[-3:]))
            # no transient failure of the card's has been seen that exits
            # the worker, so this one is deterministic (no card, an import
            # error, a bug): retrying reruns it, so give the verdict now
            print(f"bench attempt {attempt}/{ATTEMPTS} failed "
                  f"(non-retryable): {last_err}", file=sys.stderr)
            break
        print(f"bench attempt {attempt}/{ATTEMPTS} failed: {last_err}",
              file=sys.stderr)
        if attempt < ATTEMPTS:
            backoff = BACKOFF_S[min(attempt - 1, len(BACKOFF_S) - 1)]
            # never sleep past the point where another attempt fits
            runway = deadline - time.monotonic() - _MIN_ATTEMPT_S
            if runway <= 0:
                continue  # the loop header records the exhausted budget
            time.sleep(min(backoff, runway))
    print(_error_line(last_err), flush=True)
    return 1


def main() -> int:
    if "--worker" in sys.argv:
        measure()
        return 0
    try:
        return supervise()
    except Exception as e:  # noqa: BLE001 - the one-line contract holds
        print(_error_line(f"supervisor crashed: {e!r}"), flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
