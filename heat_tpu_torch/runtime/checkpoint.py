"""Periodic checkpoint / resume, with validation + quarantine on discovery.

The reference has no mid-run persistence — its only dumps are the initial
``int.dat`` and final ``soln.dat`` (fortran/serial/heat.f90:50-55,77-83).
Snapshots are ``.npz`` files carrying the field, the step index and a config
fingerprint, in exactly ``heat_tpu.runtime.checkpoint``'s layout and
fingerprint, so each package resumes the other's checkpoints. A bf16 tensor
is stored as its raw 2-byte values under the ``.npy`` header an
``ml_dtypes.bfloat16`` array gets (``'descr': '<V2'``, written with numpy
alone: ``savez_compressed``), so the file is the reference's, byte for
byte; it is read back (numpy loads either header as ``|V2`` records)
widened to f32, which is exact.

Discovery (``latest``) trusts nothing: every candidate is verified loadable
and finite before it is offered for resume; a torn, truncated, or
bit-rotted file is renamed to ``*.corrupt`` and discovery falls back to the
next-older step. A fingerprint mismatch is NOT corruption — the file is
intact, it just belongs to different physics — so it raises instead of
quarantining.
"""

from __future__ import annotations

import hashlib
import io
import json
import zipfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..config import HeatConfig
from . import faults
from .logging import master_print

_FMT = "heat_step{step:08d}.npz"


def config_fingerprint(cfg: HeatConfig) -> str:
    """Hash of the physics-relevant fields; a resume must match these."""
    phys = dict(n=cfg.n, sigma=cfg.sigma, nu=cfg.nu, dom_len=cfg.dom_len,
                ndim=cfg.ndim, ic=cfg.ic, bc=cfg.bc, bc_value=cfg.bc_value,
                dtype=cfg.dtype)
    return hashlib.sha256(json.dumps(phys, sort_keys=True).encode()).hexdigest()[:16]


# numpy's header for raw 2-byte records, and the one an ml_dtypes.bfloat16
# array gets (its dtype.str); both are 14 bytes, so the padding is unchanged
_V2_DESCR = b"'descr': '|V2'"
_BF16_DESCR = b"'descr': '<V2'"
# bytes per write of an array's data, as numpy's write_array chunks it
_CHUNK = 16 * 1024 ** 2


def savez_compressed(f, **arrays) -> None:
    """``np.savez_compressed(f, **arrays)`` (the same zip members, settings
    and bytes), except that an array of raw 2-byte records (``V2``: bf16
    bits) gets the ``.npy`` header of an ``ml_dtypes.bfloat16`` array,
    ``'<V2'``, as the reference's files have it."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_DEFLATED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            val = np.asanyarray(val)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if not (val.dtype.kind == "V" and val.dtype.itemsize == 2
                        and val.dtype.names is None):
                    np.lib.format.write_array(fid, val, allow_pickle=False)
                    continue
                head = io.BytesIO()
                np.lib.format.write_array_header_1_0(
                    head, np.lib.format.header_data_from_array_1_0(val))
                fid.write(head.getvalue().replace(_V2_DESCR, _BF16_DESCR, 1))
                flat = np.ascontiguousarray(val).reshape(-1).view(np.uint8)
                for lo in range(0, flat.size, _CHUNK):
                    fid.write(flat[lo:lo + _CHUNK])


def _to_storage(T) -> np.ndarray:
    """The array as written: a host array as is, a tensor fetched to the
    host, a bf16 tensor as its raw 2-byte values."""
    import torch

    if not isinstance(T, torch.Tensor):
        return np.asarray(T)
    T = T.detach().cpu()
    if T.dtype == torch.bfloat16:
        return T.view(torch.int16).numpy().view("V2")
    return T.numpy()


def _from_storage(a: np.ndarray) -> np.ndarray:
    """Inverse of ``_to_storage``: 2-byte raw records are bf16 values."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a


def save(cfg: HeatConfig, T, step: int) -> Path:
    """Atomically publish ``T`` (host array or tensor) as step ``step``."""
    d = Path(cfg.checkpoint_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / _FMT.format(step=step)
    plan = faults.plan_for(cfg)
    if plan is not None:
        plan.sink_fault(step)  # injected transient sink error / slow sink
    # Temp name must NOT match latest()'s "heat_step*.npz" glob, or a crash
    # mid-save would leave a torn file that resume then trips over.
    tmp = d / (path.name + ".tmp")
    with open(tmp, "wb") as f:  # file handle: stops numpy appending ".npz"
        savez_compressed(f, T=_to_storage(T), step=step,
                         fingerprint=config_fingerprint(cfg))
    tmp.rename(path)  # atomic publish: no torn checkpoint on interrupt
    if plan is not None:
        plan.damage_checkpoint(path, step)  # injected post-publish bitrot
    return path


def _finite(a: np.ndarray) -> bool:
    return bool(np.isfinite(_from_storage(np.asarray(a))).all())


def validate(path: Path, cfg: Optional[HeatConfig] = None) -> Optional[str]:
    """None when the checkpoint is restorable; else a reason string
    (unreadable / non-finite — the quarantine classes). A fingerprint
    mismatch (checked only when ``cfg`` is given) raises ValueError."""
    try:
        with np.load(path, allow_pickle=False) as z:
            fp = str(z["fingerprint"])
            int(z["step"])
            if not _finite(z["T"]):
                return "non-finite field"
    except Exception as e:  # torn zip, bad CRC, missing keys, short read —
        # every decode failure is the same verdict: not restorable
        return f"unreadable ({type(e).__name__}: {e})"
    if cfg is not None and fp != config_fingerprint(cfg):
        raise ValueError(
            f"checkpoint {path} was written for a different physics config "
            f"(fingerprint {fp} != {config_fingerprint(cfg)})"
        )
    return None


def quarantine(path: Path, reason: str) -> Path:
    """Rename a bad checkpoint to ``*.corrupt``: it stops matching every
    discovery glob but stays on disk for autopsy."""
    q = path.with_name(path.name + ".corrupt")
    path.rename(q)
    master_print(f"checkpoint: quarantined {path.name} -> {q.name} ({reason})")
    return q


def latest(cfg: HeatConfig, max_step: Optional[int] = None) -> Optional[Path]:
    """Newest VALID checkpoint, optionally capped at ``max_step`` — resuming
    a run whose ntime is *smaller* than an old checkpoint must not
    time-travel. A corrupt newest candidate is quarantined and the
    next-older step offered instead; a fingerprint mismatch raises."""
    d = Path(cfg.checkpoint_dir)
    if not d.is_dir():
        return None
    cks = sorted(d.glob("heat_step*.npz"))
    if max_step is not None:
        cks = [c for c in cks if int(c.stem.replace("heat_step", "")) <= max_step]
    for c in reversed(cks):
        reason = validate(c, cfg)
        if reason is None:
            return c
        quarantine(c, reason)
    return None


def load(path: Path, cfg: HeatConfig) -> Tuple[np.ndarray, int]:
    with np.load(path, allow_pickle=False) as z:
        fp = str(z["fingerprint"])
        if fp != config_fingerprint(cfg):
            raise ValueError(
                f"checkpoint {path} was written for a different physics config "
                f"(fingerprint {fp} != {config_fingerprint(cfg)})"
            )
        return _from_storage(z["T"]), int(z["step"])
