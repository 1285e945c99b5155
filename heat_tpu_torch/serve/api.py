"""Request contract (JSONL file + HTTP body lines) and the offline
``serve`` entry point.

A requests file is JSON Lines: one JSON object per line, blank lines and
``#`` comment lines ignored. Each object is a solve request; keys map to
the same-named ``HeatConfig`` fields (``config.config_from_request``):

    {"id": "a", "n": 128, "ntime": 500}
    {"id": "b", "n": 300, "ntime": 200, "nu": 0.1, "dtype": "float32",
     "bc": "ghost", "bc_value": 1.0, "ic": "uniform", "deadline_ms": 5000,
     "tenant": "acme", "class": "interactive"}

``id`` is optional (auto-assigned ``req-NNNN``); ``deadline_ms`` is an
optional per-request wall budget from submission (overrides the engine
default ``--serve-deadline``); ``tenant`` and ``class``
(``config.SLO_CLASSES``: interactive | standard | batch) are the fields the
fair-share/EDF policies and the per-tenant quota key on; ``until``
(``steps`` | ``steady``) and ``tol`` pick the completion semantics
(``until=steady`` retires once the lane's residual EWMA passes ``tol``,
default ``--steady-tol``, with ``ntime`` as the hard cap); ``inject`` is a
per-request fault spec (``runtime/faults.py``). Everything else
defaults to the ``HeatConfig`` defaults. Unknown keys are a per-request
rejection (typos must not silently serve different physics). The engine
pads each request up to the smallest configured bucket side and serves
same-bucket requests as stacked lanes under dispatch-ahead continuous
batching (scheduler.py / engine.py); execution knobs — ``--lanes``,
``--chunk``, ``--buckets``, ``--dispatch-depth``, ``--max-queue``,
``--fetch-watchdog``, ``--policy``, ``--tenant-weights``,
``--tenant-quota``, ``--serve-on-nan``, ``--numerics``, ``--steady-tol``,
``--numerics-guard``, ``--inject`` — are engine policy, never request
payload.

The copy of ``heat_tpu.serve.api``. The HTTP gateway (serve/gateway.py)
POSTs the exact same line format to ``/v1/solve``; both front doors parse
through ``parse_request_obj`` so a request means one thing no matter how
it arrives.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Tuple

from ..config import (HeatConfig, config_from_request, validate_slo_fields,
                      validate_until_fields)
from .scheduler import Engine, ServeConfig


@dataclasses.dataclass
class ParsedRequest:
    """One parsed request line: either a submittable (cfg + scheduler
    fields) or a per-line parse failure (``error`` set, cfg None)."""

    id: Optional[str] = None
    cfg: Optional[HeatConfig] = None
    deadline_ms: Optional[float] = None
    tenant: Optional[str] = None
    slo_class: Optional[str] = None
    until: str = "steps"
    tol: Optional[float] = None
    error: Optional[str] = None


def parse_request_obj(d) -> ParsedRequest:
    """Validate one request object (already JSON-decoded) into a
    ``ParsedRequest``. Never raises: a malformed request is that request's
    rejection, not its neighbors'."""
    rid = None
    try:
        if not isinstance(d, dict):
            raise ValueError(f"request must be a JSON object, got "
                             f"{type(d).__name__}")
        rid = d.get("id")
        if rid is not None:
            rid = str(rid)
        deadline_ms = d.get("deadline_ms")
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
            if deadline_ms <= 0:
                raise ValueError(
                    f"deadline_ms must be > 0, got {deadline_ms}")
        tenant, slo_class = validate_slo_fields(d.get("tenant"),
                                                d.get("class"))
        until, tol = validate_until_fields(d.get("until"), d.get("tol"))
        return ParsedRequest(id=rid, cfg=config_from_request(d),
                             deadline_ms=deadline_ms, tenant=tenant,
                             slo_class=slo_class, until=until, tol=tol)
    except Exception as e:  # noqa: BLE001 — recorded per request
        return ParsedRequest(id=rid, error=f"{type(e).__name__}: {e}")


def load_requests(path) -> List[ParsedRequest]:
    """Parse a requests JSONL file into ``ParsedRequest`` rows. A malformed
    line yields a row with ``error`` set instead of raising: one bad
    request must not take down the whole file."""
    out = []
    for lineno, raw in enumerate(Path(path).read_text().splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        try:
            d = json.loads(line)
        except Exception as e:  # noqa: BLE001 — recorded per request
            out.append(ParsedRequest(
                error=f"line {lineno}: {type(e).__name__}: {e}"))
            continue
        row = parse_request_obj(d)
        if row.error is not None:
            row.error = f"line {lineno}: {row.error}"
        out.append(row)
    return out


def submit_parsed(eng: Engine, row: ParsedRequest) -> str:
    """Submit one successfully parsed row. ``row.cfg`` must be set."""
    return eng.submit(row.cfg, request_id=row.id,
                      deadline_ms=row.deadline_ms, tenant=row.tenant,
                      slo_class=row.slo_class, until=row.until, tol=row.tol)


def serve_requests(path, scfg: Optional[ServeConfig] = None,
                   engine: Optional[Engine] = None,
                   device=None, skip_ids=()) -> Tuple[List[dict], dict]:
    """Serve every request in a JSONL file; returns (records, summary).

    Parse failures become status='rejected' records alongside the engine's
    own admission rejections, so the records cover every input line. The
    engine runs on ``device`` (default: the card). ``skip_ids`` (``serve
    --resume``) names requests already recovered from — or finished
    before — an engine-state checkpoint; matching file rows are not
    re-submitted."""
    scfg = scfg if scfg is not None else ServeConfig()
    eng = engine or Engine(scfg, device=device)
    skip_ids = frozenset(skip_ids)
    parse_failures = []
    for i, row in enumerate(load_requests(path)):
        if row.id is not None and row.id in skip_ids:
            continue
        if row.cfg is None:
            rec = {"id": row.id or f"line-{i}", "status": "rejected",
                   "error": row.error}
            parse_failures.append(rec)
            if scfg.emit_records:
                from ..runtime.logging import json_record

                json_record("serve_request", **rec)
            continue
        submit_parsed(eng, row)
    records = eng.results() + parse_failures
    summary = eng.summary()
    summary["requests"] += len(parse_failures)
    if parse_failures:
        summary["rejected"] = summary.get("rejected", 0) + len(parse_failures)
    return records, summary
