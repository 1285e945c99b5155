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

A world of several ranks writes shard files instead
(``save_shards``): each rank its owned blocks with their global start
offsets, ``heat_shards_step%08d.proc%04d.npz``, the reference's
multi-host layout and bytes; a shared directory holds a full checkpoint
once every rank's file of a step is there.

Discovery (``latest``, ``latest_shards``, ``scan_resume_step``) trusts
nothing: every candidate is verified loadable and finite before it is
offered for resume; a torn, truncated, or bit-rotted file is renamed to
``*.corrupt`` and discovery falls back to the next-older step. A
fingerprint mismatch is NOT corruption — the file is intact, it just
belongs to different physics — so it raises instead of quarantining.

The serving engine's checkpoints (``save_engine_field`` ...
``next_engine_generation``) are the reference's engine manifests and lane
field files, byte for byte: one generation is a JSON manifest naming one
field file per lane in flight, published last; discovery quarantines a
bad manifest and falls back one generation.
"""

from __future__ import annotations

import hashlib
import io
import json
import re
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

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


_SHARD_FMT = "heat_shards_step{step:08d}.proc{proc:04d}.npz"
_SHARD_RE = re.compile(r"heat_shards_step(\d{8})\.proc(\d{4})\.npz$")


def save_shards(cfg: HeatConfig, blocks: Sequence[tuple], step: int) -> Path:
    """Atomically publish this rank's owned ``blocks``, each ``(global
    start offsets, host array or tensor)``, as its shard file of step
    ``step``: the reference's ``save_shards`` layout (``shard{i}_data``,
    ``shard{i}_start``) and bytes for the same blocks in the same order."""
    d = Path(cfg.checkpoint_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / _SHARD_FMT.format(step=step, proc=faults._process_index())
    plan = faults.plan_for(cfg)
    if plan is not None:
        plan.sink_fault(step)
    payload = {"step": np.asarray(step),
               "fingerprint": np.asarray(config_fingerprint(cfg))}
    for i, (start, data) in enumerate(blocks):
        payload[f"shard{i}_data"] = _to_storage(data)
        payload[f"shard{i}_start"] = np.asarray(list(start), np.int64)
    tmp = d / (path.name + ".tmp")
    with open(tmp, "wb") as f:
        savez_compressed(f, **payload)
    tmp.rename(path)
    if plan is not None:
        plan.damage_checkpoint(path, step)
    return path


def _finite(a: np.ndarray) -> bool:
    return bool(np.isfinite(_from_storage(np.asarray(a))).all())


def validate(path: Path, cfg: Optional[HeatConfig] = None) -> Optional[str]:
    """None when the checkpoint (a global or a shard file) is restorable;
    else a reason string (unreadable / non-finite — the quarantine
    classes). A fingerprint mismatch (checked only when ``cfg`` is given)
    raises ValueError."""
    try:
        with np.load(path, allow_pickle=False) as z:
            fp = str(z["fingerprint"])
            int(z["step"])
            if "T" in z:
                if not _finite(z["T"]):
                    return "non-finite field"
            else:
                i = 0
                while f"shard{i}_data" in z:
                    if not _finite(z[f"shard{i}_data"]):
                        return "non-finite shard"
                    tuple(z[f"shard{i}_start"])
                    i += 1
                if i == 0:
                    return "no shard blocks"
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


def latest_step(cfg: HeatConfig, max_step: Optional[int] = None) -> Optional[int]:
    """Step index of ``latest()``."""
    p = latest(cfg, max_step=max_step)
    return None if p is None else int(p.stem.replace("heat_step", ""))


def latest_shards(cfg: HeatConfig, max_step: Optional[int] = None) -> Optional[int]:
    """Newest step for which this rank has a VALID shard file; invalid
    candidates are quarantined and the next-older step is tried."""
    d = Path(cfg.checkpoint_dir)
    if not d.is_dir():
        return None
    proc = faults._process_index()
    steps = sorted(int(m.group(1)) for m in map(
        _SHARD_RE.match, (p.name for p in d.glob("heat_shards_step*.npz")))
        if m and int(m.group(2)) == proc)
    if max_step is not None:
        steps = [s for s in steps if s <= max_step]
    for step in reversed(steps):
        p = d / _SHARD_FMT.format(step=step, proc=proc)
        reason = validate(p, cfg)
        if reason is None:
            return step
        quarantine(p, reason)
    return None


def _check_fingerprint(path: Path, fp: str, cfg: HeatConfig) -> None:
    if fp != config_fingerprint(cfg):
        raise ValueError(
            f"checkpoint {path} was written for a different physics config "
            f"(fingerprint {fp} != {config_fingerprint(cfg)})"
        )


def load_shards(cfg: HeatConfig, step: int) -> Tuple[List[tuple], int]:
    """This rank's shard file of ``step``: ``(blocks, step)``, each block
    ``(global start offsets, host array)`` (bf16 widened to f32, exact)."""
    path = Path(cfg.checkpoint_dir) / _SHARD_FMT.format(
        step=step, proc=faults._process_index())
    blocks = []
    with np.load(path, allow_pickle=False) as z:
        _check_fingerprint(path, str(z["fingerprint"]), cfg)
        i = 0
        while f"shard{i}_data" in z:
            blocks.append((tuple(int(s) for s in z[f"shard{i}_start"]),
                           _from_storage(z[f"shard{i}_data"])))
            i += 1
        return blocks, int(z["step"])


def scan_resume_step(ckpt_dir, nprocs: int = 1,
                     max_step: Optional[int] = None) -> Optional[int]:
    """The newest step a relaunched world could resume from (``launch``'s
    supervisor), config-free: loadable and finite only (the workers'
    ``latest*``/``load*`` still check the fingerprint). A global file
    counts alone; a shard step counts only when all ``nprocs`` ranks'
    files are present and valid. Invalid candidates are quarantined here,
    so the relaunch never trips on them."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return None
    best: Optional[int] = None
    for p in sorted(d.glob("heat_step*.npz"), reverse=True):
        step = int(p.stem.replace("heat_step", ""))
        if max_step is not None and step > max_step:
            continue
        reason = validate(p)
        if reason is None:
            best = step
            break
        quarantine(p, reason)
    by_step: Dict[int, Dict[int, Path]] = {}
    for p in d.glob("heat_shards_step*.npz"):
        m = _SHARD_RE.match(p.name)
        if m:
            by_step.setdefault(int(m.group(1)), {})[int(m.group(2))] = p
    for step in sorted(by_step, reverse=True):
        if max_step is not None and step > max_step:
            continue
        files = by_step[step]
        if set(range(nprocs)) - set(files):
            continue  # a partial set: some rank never saved this step
        bad = False
        for p in files.values():
            reason = validate(p)
            if reason is not None:
                quarantine(p, reason)
                bad = True
        if not bad:
            best = step if best is None else max(best, step)
            break
    return best


def load(path: Path, cfg: HeatConfig) -> Tuple[np.ndarray, int]:
    with np.load(path, allow_pickle=False) as z:
        _check_fingerprint(path, str(z["fingerprint"]), cfg)
        return _from_storage(z["T"]), int(z["step"])


# --- engine-state manifests (serve/scheduler.py zero-downtime serving) -------
# A generation = one consistent cut of the whole serving engine at an
# empty-pipeline chunk boundary: one field .npz per in-flight lane plus ONE
# JSON manifest naming them all. The manifest is the commit record — it is
# submitted to the (FIFO) SnapshotWriter *after* every field job, so a
# manifest that exists on disk proves its fields (and every result
# writeback submitted before the cut) were durably published first. A kill
# mid-generation leaves fields without a manifest; discovery simply falls
# back to the previous generation.

ENGINE_MANIFEST_KIND = "heat-tpu-engine-manifest"
ENGINE_MANIFEST_VERSION = 1
ENGINE_MANIFEST_FMT = "engine_gen{gen:08d}.json"
ENGINE_FIELD_FMT = "engine_gen{gen:08d}__{rid}.npz"
_ENGINE_MANIFEST_RE = re.compile(r"engine_gen(\d{8})\.json$")


def save_engine_field(d, gen: int, rid: str, T: np.ndarray,
                      fingerprint: str, remaining: int) -> Path:
    """Persist one in-flight lane's field for generation ``gen`` (called
    from the snapshot-writer thread). Same atomic-publish discipline as
    ``save``: temp name outside every discovery glob, then rename. The
    file is the reference's, a bf16 field under its ``'<V2'`` header."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    path = d / ENGINE_FIELD_FMT.format(gen=gen, rid=rid)
    tmp = d / (path.name + ".tmp")
    with open(tmp, "wb") as f:
        savez_compressed(f, T=_to_storage(T), remaining=int(remaining),
                         fingerprint=fingerprint)
    tmp.rename(path)
    return path


def load_engine_field(d, gen: int, rid: str,
                      fingerprint: str) -> Tuple[np.ndarray, int]:
    """Read one lane field back, as stored (a bf16 field as its ``V2``
    bits, which the lane loader installs as they are); the fingerprint
    cross-check mirrors ``load`` — resuming a lane onto different physics
    must be loud."""
    path = Path(d) / ENGINE_FIELD_FMT.format(gen=gen, rid=rid)
    with np.load(path, allow_pickle=False) as z:
        fp = str(z["fingerprint"])
        if fp != fingerprint:
            raise ValueError(
                f"engine field {path} was written for a different physics "
                f"config (fingerprint {fp} != {fingerprint})")
        return z["T"], int(z["remaining"])


def save_engine_manifest(d, gen: int, manifest: dict, plan=None) -> Path:
    """Atomically publish generation ``gen``'s manifest (the commit
    record — write this LAST). ``plan`` is the active FaultPlan, so
    ``ckpt-manifest-corrupt@N`` bitrot lands post-publish exactly like
    ``damage_checkpoint`` does for solve checkpoints."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    path = d / ENGINE_MANIFEST_FMT.format(gen=gen)
    tmp = d / (path.name + ".tmp")
    tmp.write_text(json.dumps(manifest, sort_keys=True))
    tmp.rename(path)
    if plan is not None:
        plan.damage_manifest(path, gen)
    return path


def validate_engine_manifest(path: Path):
    """(manifest, None) when the generation is restorable, else
    (None, reason). Restorable means: the JSON parses, identifies itself,
    and every in-flight entry's field file exists, loads, is finite, and
    carries the fingerprint the manifest claims for it. Any failure is
    one verdict — quarantine the manifest and fall back a generation
    (unlike solve checkpoints there is no intact-file-wrong-config case
    here: the manifest itself stamped the fingerprints)."""
    try:
        man = json.loads(Path(path).read_text())
    except Exception as e:  # torn write, bitrot, not JSON
        return None, f"unreadable ({type(e).__name__}: {e})"
    if not isinstance(man, dict) or man.get("kind") != ENGINE_MANIFEST_KIND:
        return None, "not an engine manifest"
    if man.get("version") != ENGINE_MANIFEST_VERSION:
        return None, f"unsupported manifest version {man.get('version')!r}"
    try:
        gen = int(man["generation"])
        inflight = man["inflight"]
        man["queued"]
    except Exception as e:
        return None, f"missing keys ({type(e).__name__}: {e})"
    d = Path(path).parent
    for e in inflight:
        try:
            rid, fp = str(e["id"]), str(e["fingerprint"])
        except Exception as exc:
            return None, f"bad inflight entry ({type(exc).__name__}: {exc})"
        fpath = d / ENGINE_FIELD_FMT.format(gen=gen, rid=rid)
        try:
            with np.load(fpath, allow_pickle=False) as z:
                if str(z["fingerprint"]) != fp:
                    return None, (f"field {fpath.name} fingerprint "
                                  f"mismatch (manifest says {fp})")
                if not _finite(z["T"]):
                    return None, f"field {fpath.name} non-finite"
                int(z["remaining"])
        except Exception as exc:
            return None, (f"field {fpath.name} unreadable "
                          f"({type(exc).__name__}: {exc})")
    return man, None


def latest_engine_manifest(d):
    """Newest VALID engine manifest in ``d`` as ``(manifest, path)``, or
    ``(None, None)``. A bad candidate is quarantined (``*.corrupt``) with
    a loud master_print and discovery falls back one generation — the
    solve-checkpoint contract lifted to the whole engine."""
    d = Path(d)
    if not d.is_dir():
        return None, None
    cands = sorted(p for p in d.iterdir() if _ENGINE_MANIFEST_RE.match(p.name))
    for p in reversed(cands):
        man, reason = validate_engine_manifest(p)
        if man is not None:
            return man, p
        quarantine(p, reason)
        master_print(f"engine resume: manifest {p.name} rejected "
                     f"({reason}) — falling back one generation")
    return None, None


def next_engine_generation(d) -> int:
    """First unused generation number in ``d`` (1-based). Counts
    quarantined manifests too, so a resumed engine never re-publishes a
    generation number an autopsy file already claims."""
    d = Path(d)
    if not d.is_dir():
        return 1
    best = 0
    for p in d.iterdir():
        m = re.match(r"engine_gen(\d{8})\.json", p.name)
        if m:
            best = max(best, int(m.group(1)))
    return best + 1
