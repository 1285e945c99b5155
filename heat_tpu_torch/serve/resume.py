"""Crash-safe engine resume: rebuild a serving engine from its manifest.

The port of ``heat_tpu.serve.resume``; the manifests and fields are the
reference's files, so each package resumes a generation the other wrote.

The write half lives in ``scheduler.Engine._engine_checkpoint`` (one
on-device copy per occupied lane + a JSON manifest submitted to the FIFO
writer last, so a manifest on disk proves everything it references is
durable) and ``runtime/checkpoint.py`` (atomic files, validation,
quarantine, generation discovery).  This module is the read half:
``resume_engine`` finds the newest restorable generation and replays
every recovered request back through ``Engine.submit`` — the one
admission door — in original submit order, so the policy queues
(fifo/edf/fair) reproduce the checkpointed dispatch order without the
manifest having to serialize policy internals.

Recovery contract:

- **In-flight** entries re-enter with a ``_restore`` payload carrying
  the checkpointed host field, remaining-step count, chunk count, usage
  partials, and numerics-observatory state; the admitting lane fill
  continues them at their last checkpointed boundary via the same
  ``load_lane`` path ``maybe_grow`` transplants ride, so the continued
  solve is bit-identical to an uninterrupted run.
- **Queued** entries re-enter with an empty payload — same config, same
  SLO fields, fresh initial condition, original relative order.
- **Done** ids are NOT replayed; they come back in the returned skip
  set so a file-driven front door does not re-submit finished work.
- Usage billing resumes from the stamped ``lane_s`` partial and the
  step count spans incarnations by construction — no double billing.
- A fingerprint mismatch between the manifest entry and its
  reconstructed config is a hard error: resuming a lane onto different
  physics must be loud, never silent.
"""

from __future__ import annotations

from typing import Dict, Set

from ..config import HeatConfig
from ..runtime import checkpoint as ckpt_mod
from ..runtime.logging import json_record, master_print


# A manifest the reference wrote names its own backends and shard kernels;
# neither is in the fingerprint, so each maps to its counterpart
_REFERENCE_BACKENDS = {"xla": "torch", "pallas": "cuda"}


def config_from_manifest(d: dict) -> HeatConfig:
    """Rebuild a ``HeatConfig`` from its ``dataclasses.asdict`` form
    (JSON turned the ``mesh_shape`` tuple into a list; a reference
    backend name becomes the port's counterpart)."""
    d = dict(d)
    if d.get("mesh_shape") is not None:
        d["mesh_shape"] = tuple(int(x) for x in d["mesh_shape"])
    for field in ("backend", "local_kernel"):
        if d.get(field) in _REFERENCE_BACKENDS:
            d[field] = _REFERENCE_BACKENDS[d[field]]
    return HeatConfig(**d)


def resume_engine(eng, resume_dir) -> Set[str]:
    """Re-admit every request recovered from the newest valid engine
    manifest in ``resume_dir`` into ``eng``. Returns the set of request
    ids the manifest accounts for (in-flight + queued + done) so callers
    can skip re-submitting them. See :func:`resume_engine_detail` for
    the structured form."""
    d = resume_engine_detail(eng, resume_dir)
    return set(d["recovered"]) | set(d["done"])


def resume_engine_detail(eng, resume_dir, skip_known: bool = False) -> Dict:
    """Re-admit every request recovered from the newest valid engine
    manifest in ``resume_dir`` into ``eng`` — a fresh not-yet-running
    Engine (``serve --resume``) or a LIVE one (the fleet router's
    checkpoint-handoff steal, POST /v1/resume): ``Engine.submit`` is the
    one admission door either way and it is thread-safe. Returns
    ``{"generation", "recovered", "done"}`` where ``recovered`` lists
    the in-flight + queued ids re-admitted (replay order) and ``done``
    the ids the manifest says already finished.

    No restorable generation (empty/missing dir, or every candidate
    quarantined) is a loud fresh start, not an error — the service must
    come up even when the checkpoint state is gone.

    ``skip_known=True`` (the live ``POST /v1/resume`` door) tolerates
    manifest entries whose ids this engine already knows: the router's
    retry/re-drive can race the manifest landing, and the raced rows
    must not poison the rest of the replay. The strict default stays for
    ``serve --resume`` — a fresh engine with colliding ids is a caller
    bug, not a race.
    """
    manifest, path = ckpt_mod.latest_engine_manifest(resume_dir)
    if manifest is None:
        master_print(f"engine resume: no restorable generation under "
                     f"{resume_dir} — starting fresh")
        return {"generation": 0, "recovered": [], "done": []}
    gen = int(manifest["generation"])
    with eng._lock:
        # never re-publish a generation number this lineage already used
        eng._engine_ckpt_next = max(eng._engine_ckpt_next, gen + 1)
        eng._engine_ckpt_gen = gen
    recovered = []
    skipped = 0
    rows = ([("inflight", e) for e in manifest["inflight"]]
            + [("queued", e) for e in manifest["queued"]])
    # original submit order: the policy queues' deterministic tiebreak
    # (req.seq, reassigned monotonically here) reproduces pop order
    rows.sort(key=lambda kv: int(kv[1].get("seq", 0)))
    for state, e in rows:
        cfg = config_from_manifest(e["cfg"])
        fp = ckpt_mod.config_fingerprint(cfg)
        if fp != e["fingerprint"]:
            raise ValueError(
                f"engine resume: request {e['id']!r} fingerprint mismatch "
                f"(manifest {e['fingerprint']}, rebuilt config {fp}) — "
                f"the manifest no longer matches this build's physics "
                f"fields; refusing to continue a different solve")
        restore = {}
        if state == "inflight":
            T, remaining = ckpt_mod.load_engine_field(
                resume_dir, gen, e["id"], fp)
            restore = {"T": T, "remaining": int(remaining),
                       "chunks": int(e.get("chunks", 0)),
                       "lane_s": float(e.get("lane_s", 0.0)),
                       "numerics": e.get("numerics")}
        try:
            rid = eng.submit(cfg, request_id=e["id"],
                             deadline_ms=e.get("deadline_ms"),
                             tenant=e.get("tenant"),
                             slo_class=e.get("class"),
                             until=e.get("until"), tol=e.get("tol"),
                             _restore=restore)
        except ValueError as ex:
            if skip_known and "duplicate request id" in str(ex):
                skipped += 1
                continue
            raise
        recovered.append(rid)
        json_record("serve_resumed", id=rid, generation=gen, state=state,
                    steps_done=int(e.get("steps_done", 0)),
                    remaining=int(e.get("remaining", cfg.ntime)),
                    placement=e.get("placement"))
    done = list(manifest.get("done", ()))
    master_print(f"engine resume: generation {gen} ({path.name}) — "
                 f"{len(manifest['inflight'])} in-flight re-admitted at "
                 f"their last boundary, {len(manifest['queued'])} queued "
                 f"re-queued in policy order, {len(done)} already done"
                 + (f", {skipped} already known here (skipped)"
                    if skipped else ""))
    return {"generation": gen, "recovered": recovered, "done": done,
            "skipped": skipped}
