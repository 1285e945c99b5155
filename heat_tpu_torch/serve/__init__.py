"""Multi-tenant serving engine: continuous batching over stacked lanes.

The port of ``heat_tpu.serve`` (packed lanes and mega-lanes, offline drain
and the online loop):

- ``engine.py``    — the device half: up to L same-bucket grids stacked into
  one ``(L, B+2, ...)`` tensor with per-lane scalars, stepped by the
  hand-written lane kernels (``ops/cuda_lanes``) or their plain version;
  and the mega-lane, one bucket-overflow request over every shard of the
  device mesh (``MegaLaneEngine``, the sharded padded-carry advance).
- ``scheduler.py`` — the host half: admission queue, shape bucketing, the
  two placement tiers and dispatch-ahead continuous batching with per-lane
  fault domains (quarantine, rollback), the numerics observatory's
  verdicts, steady exits, and the online loop with lane-tier growth.
- ``api.py``       — the request JSONL contract and the ``serve`` entry
  point.
- ``policy.py``    — admission ordering (fifo | edf | fair).
- ``gateway.py``   — the online HTTP front door (``serve --listen``):
  streaming NDJSON solves, drain and handoff, ``/metrics``, ``/tracez``,
  ``/statusz``, ``/v1/usage``.
- ``probe.py``     — the known-answer canary prober.
- ``resume.py``    — rebuild an engine from its checkpoint manifest.
- ``solvecache.py`` — the content-addressed solve cache.
"""

from .api import (ParsedRequest, load_requests,  # noqa: F401
                  parse_request_obj, serve_requests, submit_parsed)
from .engine import (BucketKey, LaneEngine, MegaLaneEngine,  # noqa: F401
                     lane_buffer, lane_tier, tail_size)
from .resume import resume_engine  # noqa: F401
from .scheduler import (TERMINAL_STATUSES, Engine,  # noqa: F401
                        Request, ServeConfig)
from .solvecache import SolveCache  # noqa: F401


def __getattr__(name):
    # the gateway imports lazily: the offline drain does not load the
    # HTTP stack it never uses
    if name in ("Gateway", "render_metrics", "render_statusz",
                "usage_payload"):
        from . import gateway

        return getattr(gateway, name)
    raise AttributeError(name)
