"""Durable serving: a write-ahead request journal + crash-restart
recovery.

The recovery layer and the cluster make the serving stack self-healing
*within* a process: boundary checkpoints, quarantine/retry, swap-image
CRCs, replica failover.  All
of that state was process-ephemeral — kill -9 and every in-flight
request was gone.  This module closes the gap with the classic database
answer, shaped to the engine's boundary protocol:

**The journal.**  An append-only write-ahead log in one directory:
CRC-framed records (``<u32 payload_len><u32 crc32><json payload>``)
in segment files (``wal-00000001.seg``, rotated at
``DurabilityPolicy.segment_bytes``), plus spilled swap images
(``img-*.npz``) and the deployment's own ``serving_plan.json`` beside
them — the whole restart story in one directory.  Record types follow
the request lifecycle:

- ``SUBMIT``    request accepted (prompt, tenant, budget) — fsync'd
                immediately: a submit is an acknowledgement
- ``ADMIT``     request (re)took a slot; supersedes any spilled image
- ``CHECKPOINT``  per-boundary committed-token watermarks, batched —
                fsync'd every ``fsync_boundaries`` boundaries
- ``SWAP_IMAGE``  a preempted/quarantined request's host K/V image was
                spilled to disk beside the journal (CRC recorded)
- ``COMPLETE``  terminal success, with the full token stream — fsync'd
                immediately
- ``DEAD_LETTER``  terminal failure: the typed
                :class:`~repro_torch.serving.recovery.RequestFailed` record
                round-trips through the journal

Every payload carries a version (``"v"``); replay skips record types
and versions it does not know, so the format can grow without breaking
old journals.  Replay is **torn-tail tolerant**: a truncated or
CRC-bad record ends replay at the last good record (a conservative
prefix — exactly some crash-consistent state) instead of failing, and
a reopened writer truncates the torn tail before appending.  Replay is
a pure read, hence idempotent: replaying twice equals replaying once.

**Restart recovery.**  :class:`RestartRecovery` rebuilds a
:class:`~repro_torch.serving.engine.PagedServingEngine` (or
:class:`~repro_torch.serving.cluster.ServingCluster` — each replica journals
into its own subdirectory and the streams merge per-request) from
``ServingPlan.from_dict`` on the persisted plan JSON plus journal
replay, then finishes every journaled request through the *existing*
recovery lanes:

- completed requests re-emit their recorded tokens (no recompute);
- requests with a durable spilled image restore through the verified-
  swap-image preempted lane (the image's CRC is checked by
  ``RecoveryManager.verify_swaps`` before its restore is planned, so a
  corrupt file degrades to a restart, never a poisoned pool);
- requests that had unjournaled progress restart from checkpoint 0
  through the pending lane with one retry charged (their K/V died with
  the device state); never-admitted submissions requeue for free.

Greedy decode is deterministic, so all three lanes finish
bit-identical to an uninterrupted run.

Swap images are the JAX package's files byte for byte: raw ``uint8``
with a dtype/shape sidecar.  numpy has no bfloat16, so the port's bf16
host images are their 16-bit patterns (``int16``, serving/engine.py);
the writer names them ``"bfloat16"`` in the sidecar (its
``image_dtype``, the engine's cache dtype) and the reader maps
``"bfloat16"`` back to ``int16``.  A journal written by either package
replays in the other, with equal image bytes and checksums.

The ``wal_torn_write`` / ``wal_lost_fsync`` / ``process_crash`` fault
sites (:data:`~repro_torch.serving.faults.PROCESS_SITES`) ride the same
seeded opportunity-counted :class:`~repro_torch.serving.faults.FaultPlan` as
every other site, so crash points are bisectable and chaos runs replay
bit-exactly.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import struct
from typing import Any

import numpy as np

from repro_torch.serving.faults import FaultPlan, image_checksum
from repro_torch.serving.observe import NULL_METRIC
from repro_torch.serving.plan import DurabilityPolicy, ServingPlan


def _np_dtype(name: str) -> np.dtype:
    """np.dtype by sidecar name; ``"bfloat16"`` images load as their
    16-bit patterns (``int16``), the port's bf16 host-image form."""
    if name == "bfloat16":
        return np.dtype(np.int16)
    return np.dtype(name)


def _save_image(path: str, host_k: np.ndarray, host_v: np.ndarray,
                dtype: str | None = None) -> None:
    """Write a host swap image as raw bytes + dtype/shape sidecar fields,
    the JAX package's format.  ``dtype`` names the cache dtype the image
    holds; ``"bfloat16"`` marks 16-bit patterns as bf16 (numpy has no
    bfloat16), any other value or None takes the array's own name."""
    k = np.ascontiguousarray(host_k)
    v = np.ascontiguousarray(host_v)

    def meta(a):
        name = "bfloat16" if dtype == "bfloat16" else str(a.dtype)
        return np.array([name] + [str(s) for s in a.shape])

    np.savez(path,
             k=k.reshape(-1).view(np.uint8),
             v=v.reshape(-1).view(np.uint8),
             k_meta=meta(k), v_meta=meta(v))


def _load_image(path: str) -> tuple[np.ndarray, np.ndarray]:
    with np.load(path) as z:
        out = []
        for name in ("k", "v"):
            meta = [str(m) for m in z[f"{name}_meta"]]
            dt = _np_dtype(meta[0])
            shape = tuple(int(s) for s in meta[1:])
            out.append(z[name].view(dt).reshape(shape))
    return out[0], out[1]

JOURNAL_VERSION = 1
# record types, in lifecycle order (the on-disk "t" field)
SUBMIT = "SUBMIT"
ADMIT = "ADMIT"
CHECKPOINT = "CHECKPOINT"
SWAP_IMAGE = "SWAP_IMAGE"
COMPLETE = "COMPLETE"
DEAD_LETTER = "DEAD_LETTER"
RECORD_TYPES = (SUBMIT, ADMIT, CHECKPOINT, SWAP_IMAGE, COMPLETE,
                DEAD_LETTER)

_HEADER = struct.Struct("<II")          # payload_len, crc32(payload)
_SEG_FMT = "wal-{:08d}.seg"
_SEG_GLOB = "wal-*.seg"
_PLAN_FILE = "serving_plan.json"
_MAX_RECORD = 16 << 20                  # framing sanity bound


class JournalError(RuntimeError):
    """Unrecoverable journal misuse (bad directory, closed writer).
    Never raised for on-disk corruption — that degrades, by design."""


def _crc(payload: bytes) -> int:
    import zlib
    return zlib.crc32(payload) & 0xFFFFFFFF


def _frame(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), _crc(payload)) + payload


def _scan_segment(path: str) -> tuple[list[dict], int, bool]:
    """Parse one segment file into ``(records, valid_bytes, clean)``.
    ``valid_bytes`` is the offset of the first bad frame (== file size
    when ``clean``) — what a reopened writer truncates the tail to."""
    with open(path, "rb") as f:
        data = f.read()
    records: list[dict] = []
    off = 0
    while off < len(data):
        if off + _HEADER.size > len(data):
            return records, off, False          # torn header
        n, crc = _HEADER.unpack_from(data, off)
        if n > _MAX_RECORD or off + _HEADER.size + n > len(data):
            return records, off, False          # torn/insane payload
        payload = data[off + _HEADER.size:off + _HEADER.size + n]
        if _crc(payload) != crc:
            return records, off, False          # bit rot
        try:
            rec = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            return records, off, False
        if isinstance(rec, dict):
            records.append(rec)
        off += _HEADER.size + n
    return records, off, True


def _segments(journal_dir: str) -> list[str]:
    return sorted(glob.glob(os.path.join(journal_dir, _SEG_GLOB)))


def read_records(journal_dir: str) -> tuple[list[dict], bool]:
    """All readable records in ``journal_dir``, in append order, with a
    flag for whether a torn/corrupt tail was dropped.  Conservative
    prefix: the first bad frame ends the read entirely (everything
    before it is exactly some crash-consistent state; resyncing past
    corruption could interleave states)."""
    out: list[dict] = []
    for seg in _segments(journal_dir):
        records, _, clean = _scan_segment(seg)
        out.extend(records)
        if not clean:
            return out, True
    return out, False


class JournalWriter:
    """Append side of the WAL: CRC framing, segment rotation, fsync
    batching, torn-write/lost-fsync fault probes, and the request-
    lifecycle helpers the engine calls inside its boundary protocol.

    Buffering model: ``append`` stages a framed record in memory;
    ``flush`` writes the batch and fsyncs.  Terminal records (submit /
    complete / dead-letter / spilled image) flush immediately — they
    acknowledge something to the outside world; progress records ride
    the ``fsync_boundaries`` cadence.  ``crash`` abandons the unflushed
    buffer without writing — kill -9 semantics for in-process crash
    simulation (only fsync'd records survive a real one anyway).
    """

    def __init__(self, journal_dir: str, *, segment_bytes: int = 1 << 20,
                 fsync_boundaries: int = 1,
                 faults: FaultPlan | None = None):
        if not journal_dir:
            raise JournalError("journal_dir must be non-empty")
        self.journal_dir = str(journal_dir)
        self.segment_bytes = int(segment_bytes)
        self.fsync_boundaries = max(1, int(fsync_boundaries))
        self._faults = faults
        # the cache dtype of the spilled images (the sidecar's name for
        # bf16 patterns); the EngineRun a writer serves sets its engine's
        self.image_dtype: str | None = None
        os.makedirs(self.journal_dir, exist_ok=True)
        self._buf: list[bytes] = []
        self._f = None
        self._closed = False
        self._dead = False              # a torn write went dark
        self.n_appended = 0
        self.n_flushes = 0
        self.n_spilled = 0
        # telemetry handles (serving/observe.py); NULL_METRIC until an
        # EngineRun binds its Observability via bind_metrics() — the
        # plain counters above stay the source for stats() either way
        self._m_appends = NULL_METRIC
        self._m_fsyncs = NULL_METRIC
        self._m_bytes = NULL_METRIC
        self._m_spills = NULL_METRIC
        self._rep = ""
        # rid -> (journaled committed-token count) to skip no-op
        # checkpoint entries, and rid -> spilled image path for GC
        self._ckpt_counts: dict[Any, int] = {}
        self._images: dict[Any, str] = {}
        self._img_seq = 0
        segs = _segments(self.journal_dir)
        if segs:
            # reopen: repair a torn tail (a crashed writer's last frame)
            # so appended records stay framable, then continue appending
            # to the same segment
            last = segs[-1]
            _, valid, clean = _scan_segment(last)
            if not clean:
                with open(last, "r+b") as f:
                    f.truncate(valid)
            self._seg_index = int(os.path.basename(last)[4:12])
            self._seg_written = os.path.getsize(last)
            for img in glob.glob(os.path.join(self.journal_dir,
                                              "img-*.npz")):
                self._img_seq = max(self._img_seq, 1 + int(
                    os.path.basename(img)[4:12]))
        else:
            self._seg_index = 1
            self._seg_written = 0

    @classmethod
    def from_policy(cls, policy: DurabilityPolicy, *,
                    plan: ServingPlan | None = None, subdir: str = "",
                    faults: FaultPlan | None = None) -> "JournalWriter":
        d = (os.path.join(policy.journal_dir, subdir) if subdir
             else policy.journal_dir)
        w = cls(d, segment_bytes=policy.segment_bytes,
                fsync_boundaries=policy.fsync_boundaries, faults=faults)
        if plan is not None:
            w.write_plan(plan.to_dict())
        return w

    def bind_metrics(self, obs) -> None:
        """Attach an Observability's registry handles.  Counters here
        are real only when telemetry is enabled (unlike the serving
        ledgers, the plain ``n_*`` attributes already serve stats());
        idempotent, so re-binding on crash-restart recovery is safe."""
        if not obs.enabled:
            return
        rep = ("replica",)
        self._rep = obs.replica
        self._m_appends = obs.counter(
            "serving_journal_appends_total",
            "WAL records staged for append", rep)
        self._m_fsyncs = obs.counter(
            "serving_journal_fsyncs_total",
            "WAL fsync batches reaching disk", rep)
        self._m_bytes = obs.counter(
            "serving_journal_bytes_total",
            "WAL bytes written (framed, post-batch)", rep)
        self._m_spills = obs.counter(
            "serving_journal_images_spilled_total",
            "host swap images spilled beside the WAL", rep)

    # ------------------------------------------------------------ frames
    def _seg_path(self) -> str:
        return os.path.join(self.journal_dir,
                            _SEG_FMT.format(self._seg_index))

    def _file(self):
        if self._f is None:
            self._f = open(self._seg_path(), "ab")
        return self._f

    def _rotate(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        self._seg_index += 1
        self._seg_written = 0

    def append(self, rtype: str, payload: dict, *,
               flush: bool = False) -> None:
        """Stage one record; ``flush=True`` forces it (and everything
        staged before it) to disk with an fsync."""
        if self._closed:
            raise JournalError("append on a closed journal")
        if self._dead:
            return                      # torn write: the WAL went dark
        body = dict(payload)
        body["v"] = JOURNAL_VERSION
        body["t"] = rtype
        frame = _frame(json.dumps(body).encode("utf-8"))
        if self._faults is not None \
                and self._faults.should_fire("wal_torn_write"):
            # the crash-mid-write tail: everything staged before this
            # record lands whole, this record lands truncated, and
            # nothing after it ever reaches disk
            self.flush()
            f = self._file()
            f.write(frame[:max(1, len(frame) // 2)])
            f.flush()
            os.fsync(f.fileno())
            self._dead = True
            return
        self._buf.append(frame)
        self.n_appended += 1
        self._m_appends.inc(1.0, (self._rep,))
        if flush:
            self.flush()

    def flush(self) -> None:
        """Write + fsync the staged batch (the wal_lost_fsync site: a
        fired probe drops the batch on the floor while later batches
        still land — the page-cache reordering hazard, reproduced)."""
        if self._closed or self._dead or not self._buf:
            return
        data = b"".join(self._buf)
        self._buf = []
        if self._faults is not None \
                and self._faults.should_fire("wal_lost_fsync"):
            return
        f = self._file()
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
        self.n_flushes += 1
        self._m_fsyncs.inc(1.0, (self._rep,))
        self._m_bytes.inc(float(len(data)), (self._rep,))
        self._seg_written += len(data)
        if self._seg_written >= self.segment_bytes:
            self._rotate()

    def crash(self) -> None:
        """Simulated kill -9: drop the unflushed buffer, close the fd.
        Everything already fsync'd stays; nothing else does."""
        self._buf = []
        self._closed = True
        if self._f is not None:
            self._f.close()
            self._f = None

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._closed = True
        if self._f is not None:
            self._f.close()
            self._f = None

    # -------------------------------------------------------- plan + GC
    def write_plan(self, plan_dict: dict) -> None:
        """Persist the deployment's ServingPlan JSON beside the journal
        (write-once; the restart side loads it with
        ``ServingPlan.from_dict``)."""
        path = os.path.join(self.journal_dir, _PLAN_FILE)
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(plan_dict, f, indent=2, sort_keys=True)
            os.replace(tmp, path)

    def adopt_images(self, images: dict[Any, str]) -> None:
        """Seed the image-GC map from a replayed journal (restart
        resume): when a replayed request re-admits or completes, its
        pre-crash spilled image is deleted like a home-grown one."""
        self._images.update(images)

    def _gc_image(self, rid: Any) -> None:
        path = self._images.pop(rid, None)
        if path is not None:
            try:
                os.remove(path)
            except OSError:
                pass

    # ---------------------------------------------- lifecycle shorthands
    def submit(self, req) -> None:
        self.append(SUBMIT, {
            "rid": req.rid, "tenant": req.tenant,
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "arrival": float(req.arrival)}, flush=True)

    def admit(self, req, *, restore: bool) -> None:
        """(Re)admission: supersedes any spilled image (the restore
        consumed it; a fresh admit restarts past it)."""
        self.append(ADMIT, {"rid": req.rid, "restore": bool(restore),
                            "retries": int(req.n_retries)})
        if not restore:
            self._ckpt_counts[req.rid] = 0
        self._gc_image(req.rid)

    def checkpoint(self, boundary: int, running) -> None:
        """One batched watermark record per boundary (only requests
        whose committed count moved), then the fsync cadence."""
        moved = []
        for req in running:
            n = len(req.tokens)
            if self._ckpt_counts.get(req.rid) != n:
                self._ckpt_counts[req.rid] = n
                moved.append([req.rid, n])
        if moved:
            self.append(CHECKPOINT, {"b": int(boundary), "reqs": moved})
        if boundary % self.fsync_boundaries == 0:
            self.flush()

    def spill_image(self, req) -> None:
        """Persist a host swap image beside the journal and record it.
        A lost image (swap_loss fired before the spill) records
        ``file: None`` — replay sends the request down the restart
        lane.  The image file is written *before* its record: a record
        implies the file was at least attempted."""
        sw = req.swap
        if sw is None:
            return
        fname = None
        if sw.host_k is not None and sw.host_v is not None:
            self._gc_image(req.rid)     # an older image is now stale
            fname = f"img-{self._img_seq:08d}.npz"
            self._img_seq += 1
            path = os.path.join(self.journal_dir, fname)
            _save_image(path, np.asarray(sw.host_k),
                        np.asarray(sw.host_v), self.image_dtype)
            self._images[req.rid] = path
            self.n_spilled += 1
            self._m_spills.inc(1.0, (self._rep,))
        self.append(SWAP_IMAGE, {
            "rid": req.rid, "n_tokens": int(sw.n_tokens),
            "tokens": [int(t) for t in req.tokens],
            "retries": int(req.n_retries), "file": fname,
            "checksum": sw.checksum}, flush=True)

    def complete(self, req) -> None:
        self.append(COMPLETE, {"rid": req.rid,
                               "tokens": [int(t) for t in req.tokens]},
                    flush=True)
        self._gc_image(req.rid)

    def dead_letter(self, record: dict) -> None:
        self.append(DEAD_LETTER, {"record": dict(record)}, flush=True)
        self._gc_image(record.get("rid"))


# ---------------------------------------------------------------- replay
# per-request status lattice; merge across journal streams takes the
# highest rank (greedy determinism makes any crash-consistent state
# resume bit-identical, so rank only encodes "how much work is saved")
_RANK = {"submitted": 0, "running": 1, "swapped": 2, "dead": 3,
         "completed": 4}


@dataclasses.dataclass
class ReplayedRequest:
    """One request's journal-final state."""
    rid: Any
    status: str = "submitted"
    tenant: str = "default"
    prompt: list[int] | None = None
    max_new_tokens: int = 0
    arrival: float = 0.0
    tokens: list[int] = dataclasses.field(default_factory=list)
    n_tokens: int = 0                   # committed watermark (progress)
    retries: int = 0
    image_file: str | None = None       # abs path of the spilled image
    image_checksum: int | None = None
    image_n_tokens: int = 0
    failure: dict | None = None         # DEAD_LETTER record

    def summary(self) -> dict:
        """JSON-safe state for idempotence checks and telemetry."""
        return {"status": self.status, "tokens": list(self.tokens),
                "n_tokens": self.n_tokens, "retries": self.retries,
                "image": os.path.basename(self.image_file)
                if self.image_file else None}


def _apply(state: dict[Any, ReplayedRequest], rec: dict,
           journal_dir: str, counters: dict) -> None:
    v = rec.get("v")
    t = rec.get("t")
    if not isinstance(v, int) or v > JOURNAL_VERSION \
            or t not in RECORD_TYPES:
        counters["skipped"] += 1        # future format: skip, don't die
        return
    if t == CHECKPOINT:
        for rid, n in rec.get("reqs", ()):
            r = state.setdefault(rid, ReplayedRequest(rid=rid))
            r.n_tokens = int(n)
            if r.status in ("submitted", "swapped"):
                # an ADMIT was lost to a dropped fsync batch; progress
                # proves the (re)admission happened and consumed any
                # image — conservative: restart lane
                r.status, r.image_file = "running", None
        return
    if t == DEAD_LETTER:
        d = rec.get("record") or {}
        rid = d.get("rid")
        r = state.setdefault(rid, ReplayedRequest(rid=rid))
        r.status, r.failure, r.image_file = "dead", d, None
        return
    rid = rec.get("rid")
    r = state.setdefault(rid, ReplayedRequest(rid=rid))
    if t == SUBMIT:
        r.tenant = rec.get("tenant", r.tenant)
        r.prompt = [int(x) for x in rec.get("prompt", [])]
        r.max_new_tokens = int(rec.get("max_new_tokens", 0))
        r.arrival = float(rec.get("arrival", 0.0))
        # never downgrades: a duplicate SUBMIT (resume append) keeps
        # whatever progress state the stream already established
    elif t == ADMIT:
        r.retries = int(rec.get("retries", r.retries))
        r.status = "running"
        r.image_file = None             # image consumed or superseded
        if not rec.get("restore", False):
            r.tokens, r.n_tokens = [], 0
    elif t == SWAP_IMAGE:
        r.status = "swapped"
        r.tokens = [int(x) for x in rec.get("tokens", [])]
        r.n_tokens = len(r.tokens)
        r.retries = int(rec.get("retries", r.retries))
        fname = rec.get("file")
        r.image_file = (os.path.join(journal_dir, fname)
                        if fname else None)
        r.image_checksum = rec.get("checksum")
        r.image_n_tokens = int(rec.get("n_tokens", 0))
    elif t == COMPLETE:
        r.status = "completed"
        r.tokens = [int(x) for x in rec.get("tokens", [])]
        r.image_file = None


@dataclasses.dataclass
class JournalReplay:
    """The crash-consistent state a journal directory replays to."""
    journal_dir: str
    requests: dict[Any, ReplayedRequest]
    plan: dict | None                   # serving_plan.json, if present
    truncated: bool                     # a torn/corrupt tail was dropped
    n_records: int
    n_skipped: int                      # unknown type/version records

    def state(self) -> dict:
        """Canonical JSON-safe summary — two replays of the same
        directory are equal iff their ``state()`` dicts are."""
        return {str(rid): self.requests[rid].summary()
                for rid in sorted(self.requests, key=str)}


def replay_journal(journal_dir: str) -> JournalReplay:
    """Replay a journal directory (single-engine: segments at the root;
    cluster: one subdirectory per replica, merged per-request by
    status rank — terminal beats image beats restart; under greedy
    determinism every choice resumes bit-identical, higher rank just
    re-does less work)."""
    journal_dir = str(journal_dir)
    streams = []
    if _segments(journal_dir):
        streams.append(journal_dir)
    for sub in sorted(os.listdir(journal_dir)
                      if os.path.isdir(journal_dir) else []):
        d = os.path.join(journal_dir, sub)
        if os.path.isdir(d) and _segments(d):
            streams.append(d)
    merged: dict[Any, ReplayedRequest] = {}
    truncated = False
    n_records = 0
    counters = {"skipped": 0}
    for d in streams:
        records, torn = read_records(d)
        truncated = truncated or torn
        n_records += len(records)
        state: dict[Any, ReplayedRequest] = {}
        for rec in records:
            _apply(state, rec, d, counters)
        for rid, r in state.items():
            cur = merged.get(rid)
            if cur is None:
                merged[rid] = r
                continue
            # meta can live in one stream (the SUBMIT) and progress in
            # another (post-migration): graft meta onto the winner
            winner, loser = (r, cur) if _RANK[r.status] > \
                _RANK[cur.status] else (cur, r)
            if winner.prompt is None and loser.prompt is not None:
                winner.prompt = loser.prompt
                winner.tenant = loser.tenant
                winner.max_new_tokens = loser.max_new_tokens
                winner.arrival = loser.arrival
            merged[rid] = winner
    plan = None
    plan_path = os.path.join(journal_dir, _PLAN_FILE)
    if os.path.exists(plan_path):
        with open(plan_path) as f:
            plan = json.load(f)
    return JournalReplay(journal_dir=journal_dir, requests=merged,
                         plan=plan, truncated=truncated,
                         n_records=n_records,
                         n_skipped=counters["skipped"])


# ------------------------------------------------------ restart recovery
class RestartRecovery:
    """Cold-restart a serving deployment from its journal directory.

    ``RestartRecovery(journal_dir).resume(model, params)`` loads the
    persisted ServingPlan, rebuilds the engine (or cluster, when the
    plan says ``n_replicas > 1``), reconstructs every journaled request
    into its recovery lane, drives the run to completion, and returns
    the full request set — replayed completions and dead letters
    included — with recovery counters.  The resumed run journals into
    the same directory, so a crash *during* recovery recovers too.
    """

    def __init__(self, journal_dir: str):
        self.journal_dir = str(journal_dir)
        self.replay = replay_journal(self.journal_dir)

    # ------------------------------------------------- request rebuilds
    def _load_image(self, r: ReplayedRequest):
        """Reconstitute a spilled SwapState; None when the file is
        missing or unreadable (the restart lane absorbs it — and a
        readable-but-corrupt image is caught later by verify_swaps'
        CRC, exactly like an in-process swap fault)."""
        from repro_torch.serving.resources import SwapState
        if r.image_file is None:
            return None
        try:
            host_k, host_v = _load_image(r.image_file)
        except Exception:
            return None
        return SwapState(pages=[], n_tokens=r.image_n_tokens, slot=-1,
                         host_k=host_k, host_v=host_v,
                         checksum=r.image_checksum, verified=False)

    def _failure(self, d: dict):
        from repro_torch.serving.recovery import RequestFailed
        kw = dict(rid=d.get("rid"), tenant=d.get("tenant", "default"),
                  reason=d.get("reason", ""),
                  boundary=int(d.get("boundary", 0)),
                  retries=int(d.get("retries", 0)),
                  site=d.get("site", "unknown"),
                  ckpt_tokens=int(d.get("ckpt_tokens", 0)))
        if "replica" in d:
            from repro_torch.serving.cluster import ReplicaLost
            return ReplicaLost(replica=d["replica"], **kw)
        return RequestFailed(**kw)

    def _rebuild(self, policy) -> dict:
        """Classify every replayed request into its lane.  Returns
        terminal/inflight request lists plus counters."""
        from repro_torch.serving.scheduler import Request
        terminal: list = []
        inflight: list = []
        c = {"replayed_completed": 0, "replayed_dead": 0,
             "image_restores": 0, "restarts": 0, "requeued": 0,
             "retries_exhausted": 0, "unrecoverable": 0}
        for rid in sorted(self.replay.requests, key=str):
            r = self.replay.requests[rid]
            if r.status == "dead":
                req = Request(rid=rid,
                              prompt=np.asarray(r.prompt or [],
                                                np.int32),
                              max_new_tokens=r.max_new_tokens,
                              arrival=r.arrival, tenant=r.tenant)
                req.failure = self._failure(r.failure or {})
                req.n_retries = req.failure.retries
                req.t_done = 0.0
                terminal.append(req)
                c["replayed_dead"] += 1
                continue
            if r.prompt is None:
                # the SUBMIT never became durable: the request was
                # never acknowledged, so there is nothing to finish
                c["unrecoverable"] += 1
                continue
            req = Request(rid=rid,
                          prompt=np.asarray(r.prompt, np.int32),
                          max_new_tokens=r.max_new_tokens,
                          arrival=r.arrival, tenant=r.tenant)
            if r.status == "completed":
                req.tokens = list(r.tokens)
                req.t_done = 0.0
                terminal.append(req)
                c["replayed_completed"] += 1
                continue
            req.n_retries = r.retries
            swap = self._load_image(r) if r.status == "swapped" else None
            if swap is not None:
                # verified-swap-image preempted lane: tokens resume at
                # the image's watermark, verify_swaps CRCs it once
                req.swap = swap
                req.tokens = list(r.tokens)
                req.ckpt_tokens = len(req.tokens)
                c["image_restores"] += 1
            elif r.status == "submitted":
                c["requeued"] += 1      # never ran: requeue for free
            else:
                # running at crash (or an unusable image): the device
                # K/V died with the process — restart from ckpt 0,
                # charging a retry iff committed work was lost
                if r.n_tokens > 0 or r.status == "swapped":
                    req.n_retries += 1
                if req.n_retries > policy.max_retries:
                    from repro_torch.serving.recovery import RequestFailed
                    req.failure = RequestFailed(
                        rid=rid, tenant=req.tenant,
                        reason="retries exhausted after process crash",
                        boundary=0, retries=req.n_retries,
                        site="process_crash", ckpt_tokens=0)
                    req.t_done = 0.0
                    terminal.append(req)
                    c["retries_exhausted"] += 1
                    continue
                c["restarts"] += 1
            inflight.append(req)
        return {"terminal": terminal, "inflight": inflight,
                "counters": c}

    # ------------------------------------------------------------ resume
    def resume(self, model, params, *, engine=None,
               faults: FaultPlan | None = None,
               recovery=None) -> dict:
        """Rebuild and run to completion.  ``engine`` short-circuits the
        plan rebuild with an already-built engine (its geometry must
        match the journaled plan — tests reuse cached engines this
        way); otherwise the plan JSON beside the journal decides, via
        ``PagedServingEngine.from_plan`` or — when it says
        ``n_replicas > 1`` — ``ServingCluster.from_plan`` with each
        replica journaling into its subdirectory."""
        from repro_torch.serving.engine import EngineRun, PagedServingEngine
        from repro_torch.serving.recovery import RecoveryPolicy
        policy = recovery if recovery is not None else RecoveryPolicy()
        plan = None
        if engine is None:
            if self.replay.plan is None:
                raise JournalError(
                    f"no {_PLAN_FILE} beside the journal in "
                    f"{self.journal_dir!r} and no engine given")
            plan = ServingPlan.from_dict(self.replay.plan)
            # resume journals into THIS directory, whatever path the
            # plan was originally deployed under (the directory may
            # have been copied/moved wholesale)
            plan = dataclasses.replace(
                plan, durability=dataclasses.replace(
                    plan.durability, enabled=True,
                    journal_dir=self.journal_dir))
        built = self._rebuild(policy)
        terminal, inflight = built["terminal"], built["inflight"]
        counters = dict(built["counters"],
                        truncated_tail=self.replay.truncated,
                        n_records=self.replay.n_records)
        if plan is not None and plan.n_replicas > 1:
            stats = self._resume_cluster(model, params, plan, inflight,
                                         terminal, faults, policy)
        else:
            eng = engine if engine is not None \
                else PagedServingEngine.from_plan(model, plan,
                                                  faults=faults,
                                                  recovery=policy)
            pol = plan.durability if plan is not None \
                else DurabilityPolicy(enabled=True,
                                      journal_dir=self.journal_dir)
            journal = JournalWriter.from_policy(pol, plan=eng.plan,
                                                faults=faults)
            journal.adopt_images(
                {r.rid: r.image_file
                 for r in self.replay.requests.values()
                 if r.image_file is not None})
            er = EngineRun(eng, params, faults=faults, recovery=policy,
                           journal=journal)
            lanes = er.obs.counter(
                "serving_journal_replay_requests_total",
                "restart-recovery replayed requests, by lane", ("lane",))
            for lane, n in built["counters"].items():
                if n:
                    lanes.inc(float(n), (lane,))
            for req in inflight:
                er.sched.rm.requeue(req)
            while er.has_work:
                if er.step() == "idle" and er.has_work:
                    er.note_stall()
            stats = er.result()
            terminal.extend(er.sched.finished)
            terminal.extend(er.rec.dead)
            journal.close()
        return {"requests": terminal, "stats": stats,
                "recovered": counters}

    def _resume_cluster(self, model, params, plan, inflight, terminal,
                        faults, policy) -> dict:
        from repro_torch.serving.cluster import ServingCluster
        cluster = ServingCluster.from_plan(model, params, plan,
                                           faults=faults,
                                           recovery=policy)
        for req in inflight:
            target = cluster.front_door.route(req)
            if target is None:
                cluster._cluster_dead_letter(
                    req, "no live replica at restart recovery",
                    site="process_crash", replica="-")
                continue
            target.run.sched.rm.requeue(req)
        stats = cluster.run([])
        terminal.extend(cluster.finished)
        terminal.extend(cluster.dead_lettered)
        cluster.close_journals()
        return stats
