"""Multi-tenant serving engine: continuous batching over stacked lanes.

The port of ``heat_tpu.serve`` (packed lanes, offline drain and the online
loop):

- ``engine.py``    — the device half: up to L same-bucket grids stacked into
  one ``(L, B+2, ...)`` tensor with per-lane scalars, stepped by the
  hand-written lane kernels (``ops/cuda_lanes``) or their plain version.
- ``scheduler.py`` — the host half: admission queue, shape bucketing and
  dispatch-ahead continuous batching with per-lane fault domains
  (quarantine, rollback), the numerics observatory's verdicts, steady
  exits, and the online loop with lane-tier growth.
- ``api.py``       — the request JSONL contract and the ``serve`` entry
  point.
- ``policy.py``    — admission ordering (fifo | edf | fair).
"""

from .api import (ParsedRequest, load_requests,  # noqa: F401
                  parse_request_obj, serve_requests, submit_parsed)
from .engine import (BucketKey, LaneEngine, lane_buffer,  # noqa: F401
                     lane_tier, tail_size)
from .scheduler import (TERMINAL_STATUSES, Engine,  # noqa: F401
                        Request, ServeConfig)
