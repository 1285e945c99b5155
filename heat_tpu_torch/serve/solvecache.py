"""Content-addressed solve cache: result memoization + prefix snapshots.

The port of ``heat_tpu.serve.solvecache``, the store behind ``--cache on``:

- **Level 1 (full hit).** Every finished result is published here under
  the canonical *physics* fingerprint (``runtime.checkpoint.
  config_fingerprint`` — ``n/sigma/nu/dom_len/ndim/ic/bc/bc_value/
  dtype``; scheduler keys like id/tenant/class/deadline_ms never split
  entries) plus the step count the field carries. A later request whose
  fingerprint matches at exactly its ``ntime`` short-circuits at
  ``Engine.submit``: the stored npz replays byte for byte, no lane is
  occupied, no lane kernel launches.
- **Level 2 (prefix hit).** An entry at a *smaller* step count — a
  steady early exit's frontier, or a chunk-boundary lane snapshot the
  engine-checkpoint writer ingests — seeds the lane through the resume
  path and the lane kernels step only the delta. The lanes round to
  storage every step, so the seeded lane's bytes are those of an
  uninterrupted run.

Entry layout (one pair per ``(fingerprint, step)``)::

    <cache-dir>/<fp16hex>-<step:08d>.npz    # exact _write_result format:
                                            # T, step, n, ndim, dtype
    <cache-dir>/<fp16hex>-<step:08d>.json   # sidecar: fingerprint, step,
                                            # kind, nbytes, sha256(npz)

The npz is the payload ``serve --out-dir`` publishes (the reference's
bytes, a bf16 field under its ``'<V2'`` header) — a full hit with an out
dir is a literal byte copy. Publishes are atomic (temp name outside the
discovery glob, then rename; the sidecar lands first so a published npz
is never meta-less); identical ``(fingerprint, step)`` publishes are
first-write-wins, which is safe because the bytes are identical.

Every consult re-verifies the entry: sidecar fingerprint against the
request's (a stale or mis-filed entry), sha256 against the sidecar
(bitrot), then a real ``np.load`` with a finiteness check. Any failure
quarantines BOTH files to ``*.corrupt``, emits a structured
``cache_quarantined`` record, and the consult falls through to the
next-best entry or a recompute — a damaged entry is never served.

Eviction is LRU by file mtime under ``--cache-max-bytes`` (a hit touches
its entry; 0 = unbounded). The counters live under one lock of their own
(rank: after the engine and writer, before the observatories), so the
writer thread may publish while a gateway handler consults.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import HeatConfig
from ..runtime.checkpoint import (_from_storage, config_fingerprint,
                                  savez_compressed)
from ..runtime.logging import json_record, master_print

__all__ = ["SolveCache", "config_fingerprint", "entry_name"]


def entry_name(fingerprint: str, step: int) -> str:
    """Canonical npz name for one ``(fingerprint, step)`` entry."""
    return f"{fingerprint}-{int(step):08d}.npz"


def _meta_path(npz: Path) -> Path:
    return npz.with_suffix(".json")


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _parse_entry(path: Path) -> Optional[Tuple[str, int]]:
    """``<fp>-<step:08d>.npz`` -> (fp, step), else None (foreign file)."""
    stem = path.name[:-len(".npz")]
    fp, dash, step_s = stem.rpartition("-")
    if not dash or not fp or not step_s.isdigit():
        return None
    return fp, int(step_s)


def write_entry_bytes(tmp: Path, T, cfg: HeatConfig, step: int) -> None:
    """Serialize one entry EXACTLY like scheduler._write_result does —
    the byte-identity contract hangs on the two call sites staying
    field-for-field identical."""
    with open(tmp, "wb") as f:
        savez_compressed(f, T=np.asarray(T), step=int(step),
                         n=cfg.n, ndim=cfg.ndim, dtype=cfg.dtype)


class SolveCache:
    """One cache directory + its counters, under one ``cache``-rank lock.

    ``plan`` is the engine's fault plan (``runtime/faults.py``): the
    ``cache-corrupt``/``cache-stale`` chaos kinds damage the consulted
    entry right before validation, which must quarantine it.
    ``readonly=True`` (the fleet router) never publishes or evicts.
    """

    def __init__(self, cache_dir, max_bytes: int = 0, plan=None,
                 readonly: bool = False):
        self.dir = Path(cache_dir)
        if not readonly:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.max_bytes = int(max_bytes or 0)
        self.readonly = readonly
        self._plan = plan
        self._lock = threading.Lock()   # rank: cache (engine -> writer ->
                                        # cache -> observatory)
        self._consults = 0
        self.hits_full = 0
        self.hits_prefix = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.quarantined = 0

    # --- consult ----------------------------------------------------------
    def lookup(self, cfg: HeatConfig) -> Optional[dict]:
        """Best valid entry for ``cfg``: ``{"kind": "full"|"prefix",
        "fingerprint", "step", "path", "nbytes"}`` or None (miss).
        Full = an entry at exactly ``cfg.ntime``; prefix = the deepest
        entry strictly below it. Invalid candidates are quarantined and
        the next-best one is tried — a damaged entry is never served."""
        fp = config_fingerprint(cfg)
        want = int(cfg.ntime)
        with self._lock:
            self._consults += 1
            consult = self._consults
        if self._plan is not None:
            self._plan.damage_cache(self.dir, fp, consult)
        # best-first: the exact step, then prefixes by descending depth
        steps = sorted((s for cfp, s in self._entries()
                        if cfp == fp and s <= want), reverse=True)
        for step in steps:
            path = self.dir / entry_name(fp, step)
            reason = self._validate(path, fp, step)
            if reason is not None:
                self._quarantine(path, fp, step, reason)
                continue
            try:
                os.utime(path)            # LRU touch (best effort)
            except OSError:
                pass
            nbytes = path.stat().st_size
            kind = "full" if step == want else "prefix"
            with self._lock:
                if kind == "full":
                    self.hits_full += 1
                else:
                    self.hits_prefix += 1
            return {"kind": kind, "fingerprint": fp, "step": step,
                    "path": str(path), "nbytes": int(nbytes)}
        with self._lock:
            self.misses += 1
        return None

    def _entries(self) -> List[Tuple[str, int]]:
        if not self.dir.is_dir():
            return []
        out = []
        for p in self.dir.glob("*.npz"):
            parsed = _parse_entry(p)
            if parsed is not None:
                out.append(parsed)
        return out

    def _validate(self, path: Path, fp: str, step: int) -> Optional[str]:
        """None when the entry is servable, else the quarantine reason.
        Order matters: the sidecar fingerprint check catches a stale or
        mis-filed entry (``cache-stale``) before the content hash catches
        bitrot (``cache-corrupt``); a final real load catches everything
        a hash cannot (we hash what we wrote, not what np.load needs)."""
        meta_p = _meta_path(path)
        try:
            meta = json.loads(meta_p.read_text())
        except Exception as e:  # noqa: BLE001 — every decode failure is
            return f"sidecar unreadable ({type(e).__name__}: {e})"
        if meta.get("fingerprint") != fp:
            return (f"stale: sidecar fingerprint "
                    f"{meta.get('fingerprint')!r} != request {fp!r}")
        if int(meta.get("step", -1)) != step:
            return f"stale: sidecar step {meta.get('step')} != {step}"
        try:
            if _sha256_file(path) != meta.get("sha256"):
                return "content hash mismatch (bitrot or torn write)"
            with np.load(path, allow_pickle=False) as z:
                if int(z["step"]) != step:
                    return f"payload step {int(z['step'])} != {step}"
                T = _from_storage(np.asarray(z["T"]))   # bf16 bits widened
                if not np.isfinite(T).all():
                    return "non-finite field"
        except Exception as e:  # noqa: BLE001
            return f"unreadable ({type(e).__name__}: {e})"
        return None

    def _quarantine(self, path: Path, fp: str, step: int,
                    reason: str) -> None:
        """Rename entry + sidecar to ``*.corrupt`` (out of every glob,
        kept for autopsy) and emit the structured record operators
        alert on. A read-only (router) cache cannot rename on shared
        storage it does not own — it just refuses to serve the entry."""
        quarantined = []
        if not self.readonly:
            for p in (path, _meta_path(path)):
                try:
                    q = p.with_name(p.name + ".corrupt")
                    p.rename(q)
                    quarantined.append(str(q))
                except OSError:
                    pass
        with self._lock:
            self.quarantined += 1
        master_print(f"solve cache: quarantined {path.name} ({reason}) "
                     f"— recomputing")
        json_record("cache_quarantined", fingerprint=fp, step=int(step),
                    path=str(path), reason=reason,
                    quarantined=quarantined)

    @staticmethod
    def load(path) -> Tuple[np.ndarray, int]:
        """One validated entry's field + step (the prefix-seed read); a
        bf16 field comes back as its ``V2`` bits, which the lane loader
        installs as they are."""
        with np.load(path, allow_pickle=False) as z:
            return np.asarray(z["T"]), int(z["step"])

    def replay(self, entry_path, out_dir, req_id: str) -> Path:
        """Full-hit publish: byte-copy the cached npz to the out dir
        under the hitting request's id (atomic temp+rename — the same
        torn-file discipline as ``_write_result``, and byte-identical to
        the cold-miss artifact because it IS those bytes)."""
        d = Path(out_dir)
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"{req_id}.npz"
        tmp = d / (path.name + ".tmp")
        shutil.copyfile(entry_path, tmp)
        tmp.rename(path)
        return path

    # --- publish ----------------------------------------------------------
    def put(self, cfg: HeatConfig, step: int, T=None, src_path=None,
            kind: str = "result") -> Optional[Path]:
        """Publish one entry under ``(fingerprint(cfg), step)`` — from
        the published result file (``src_path``, a byte copy) or a host
        field (``T``, serialized identically). First-write-wins: an
        existing entry's bytes are identical by construction. Best
        effort by design — a full disk must fail the cache, never the
        request (runs on the writer thread's publish path)."""
        if self.readonly:
            return None
        try:
            fp = config_fingerprint(cfg)
            path = self.dir / entry_name(fp, step)
            if path.exists():
                return path
            self.dir.mkdir(parents=True, exist_ok=True)
            tmp = self.dir / (path.name + ".tmp")
            if src_path is not None:
                shutil.copyfile(src_path, tmp)
            else:
                write_entry_bytes(tmp, T, cfg, step)
            meta = {"fingerprint": fp, "step": int(step), "kind": kind,
                    "nbytes": tmp.stat().st_size,
                    "sha256": _sha256_file(tmp)}
            meta_tmp = self.dir / (_meta_path(path).name + ".tmp")
            meta_tmp.write_text(json.dumps(meta, sort_keys=True) + "\n")
            # sidecar first: a published npz is never sidecar-less
            meta_tmp.rename(_meta_path(path))
            tmp.rename(path)
        except Exception as e:  # noqa: BLE001 — cache misses are safe;
            # a failed publish must not poison the writer retry path
            master_print(f"solve cache: publish failed for step {step} "
                         f"({type(e).__name__}: {e}) — entry skipped")
            for t in (locals().get("tmp"), locals().get("meta_tmp")):
                if t is not None:
                    try:
                        Path(t).unlink(missing_ok=True)
                    except OSError:
                        pass
            return None
        with self._lock:
            self.puts += 1
        self._evict()
        return path

    # --- eviction ---------------------------------------------------------
    def _evict(self) -> None:
        """LRU by npz mtime until total entry bytes fit
        ``max_bytes`` (0 = unbounded). Sidecars ride along."""
        if self.max_bytes <= 0 or self.readonly:
            return
        entries = []
        total = 0
        for fp, step in self._entries():
            p = self.dir / entry_name(fp, step)
            try:
                st = p.stat()
                msize = _meta_path(p).stat().st_size
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size + msize, p))
            total += st.st_size + msize
        entries.sort()                       # oldest mtime first
        evicted = 0
        for _, size, p in entries:
            if total <= self.max_bytes:
                break
            for victim in (p, _meta_path(p)):
                try:
                    victim.unlink(missing_ok=True)
                except OSError:
                    pass
            total -= size
            evicted += 1
            master_print(f"solve cache: evicted {p.name} (LRU, "
                         f"{total} B retained <= --cache-max-bytes "
                         f"{self.max_bytes})")
        if evicted:
            with self._lock:
                self.evictions += evicted

    # --- reporting --------------------------------------------------------
    def bytes_total(self) -> int:
        total = 0
        for fp, step in self._entries():
            p = self.dir / entry_name(fp, step)
            try:
                total += p.stat().st_size + _meta_path(p).stat().st_size
            except OSError:
                pass
        return total

    def stats(self) -> Dict:
        """The /metrics / /statusz / summary() food."""
        with self._lock:
            counters = {"consults": self._consults,
                        "hits_full": self.hits_full,
                        "hits_prefix": self.hits_prefix,
                        "misses": self.misses,
                        "puts": self.puts,
                        "evictions": self.evictions,
                        "quarantined": self.quarantined}
        return {"dir": str(self.dir), "max_bytes": self.max_bytes,
                "readonly": self.readonly,
                "entries": len(self._entries()),
                "bytes": self.bytes_total(), **counters}
