"""Process-0-gated printing.

The reference gates every print on ``masterproc`` (rank 0,
fortran/mpi+cuda/heat.F90:78-79). Here the rank comes from
``torch.distributed`` when a process group is initialised; a process
outside any group is rank 0 and always prints.
"""

from __future__ import annotations

import sys


def _is_master() -> bool:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def master_print(*args, **kw) -> None:
    if _is_master():
        print(*args, **kw)
        sys.stdout.flush()


def json_record(event: str, **fields) -> None:
    """One structured, machine-parseable JSON line (master-gated):
    ``{"event": "<event>", ...}`` with sorted keys, one record per line —
    the serving engine's per-request records and fallback notices."""
    import json

    master_print(json.dumps({"event": event, **fields}, sort_keys=True,
                            default=str))

