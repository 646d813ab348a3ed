"""Request-level recovery for the serving engine: checkpoints,
quarantine, retries, and graceful degradation.

Before this layer, every anomaly in the boundary loop was a bare
``RuntimeError`` that killed the whole engine — and with it every
co-resident tenant's in-flight requests.  The recovery model instead
treats faults the way the resource manager treats page pressure: as a
per-request event with an automated policy response.

**Boundary checkpoints.**  At every segment boundary each running
request's committed state is exactly ``(tokens so far)`` — the device
pages hold K/V for positions ``[0, prompt + len(tokens) - 1)`` and
everything a later segment writes lands strictly *beyond* that
watermark (decode appends; masked positions are dead until their write
lands).  So the per-boundary checkpoint is one integer
(``Request.ckpt_tokens``), and rollback is: truncate the token list to
the checkpoint, snapshot the pages that back it through the *existing*
preemption machinery (``ResourceManager.preempt`` → ``SwapState`` host
image), and requeue.  The restore path then resumes bit-identically,
exactly as it does for an ordinary preemption.

**Quarantine lifecycle.**  A faulted request is quarantined: its slot
is vacated (healthy slots keep generating), its state rolls back to the
last checkpoint, and it waits out an exponential *segment* backoff
(``backoff_segments * backoff_factor**(n_retries-1)`` boundaries) before
re-entering its tenant's queue — through the preempted lane when a
verified host image exists (one-dispatch restore), through the pending
lane as a full restart when it does not (greedy decode is deterministic,
so a restart regenerates the same tokens).  Retries are bounded;
exhaustion dead-letters the request with a typed :class:`RequestFailed`
terminal record and per-tenant accounting in
``ResourceManager.stats()``.

**Swap integrity.**  Swap images carry a CRC recorded at ``device_get``
time; a corrupted or lost image is detected *before* its restore is
planned (``verify_swaps``) and converts the request to a restart instead
of scattering garbage K/V back into the pool.

**Invariant checker (opt-in).**  ``RecoveryPolicy.check_invariants``
audits the boundary state — block-table coverage ⊆ owned pages,
refcount and quota ledgers consistent — and quarantines the offending
request (full restart: its state is suspect) instead of crashing.  It
walks every running request's page list each boundary, so it costs
O(running x pages) host work per boundary: cheap next to a dispatch,
but nonzero — hence opt-in, for chaos runs and debugging.

**Watchdog.**  The engine's no-progress guard raises
:class:`EngineStalledError` carrying a structured diagnostic snapshot
(queue depths, free pages, per-slot state, quarantine/dead-letter
counts) — the one remaining way out of ``run()``, reserved for genuine
policy deadlocks and unbounded fault patterns.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import TYPE_CHECKING, Any, Iterable

from repro_torch.serving.faults import image_checksum

if TYPE_CHECKING:                       # import cycle: engine imports us
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                         Request)


class EngineStalledError(RuntimeError):
    """The engine made no progress for ``watchdog_boundaries``
    consecutive boundaries.  Carries the structured diagnostic the old
    bare RuntimeError only alluded to."""

    def __init__(self, message: str, snapshot: dict):
        super().__init__(message)
        self.snapshot = snapshot


@dataclasses.dataclass(frozen=True)
class RequestFailed:
    """Typed terminal state of a dead-lettered request (attached as
    ``Request.failure``; the request is *not* in ``scheduler.finished``).

    ``site`` names the last fault site that drove the request under
    (a :data:`~repro_torch.serving.faults.SITES` name where the origin is
    known, a recovery-layer tag like ``"shed"``/``"invariant"`` where it
    is not) and ``ckpt_tokens`` is the boundary-checkpoint watermark the
    request had committed when it died — together with ``tenant`` and
    ``retries`` this is the structured record ``RecoveryManager.stats()``
    exports per dead letter.
    """
    rid: Any
    tenant: str
    reason: str
    boundary: int                       # boundary index at dead-letter
    retries: int
    site: str = "unknown"               # last fault site (or policy tag)
    ckpt_tokens: int = 0                # committed tokens at death

    def record(self) -> dict:
        """JSON-safe dict for bench rows / telemetry."""
        return {"rid": self.rid, "tenant": self.tenant, "site": self.site,
                "reason": self.reason, "boundary": self.boundary,
                "retries": self.retries, "ckpt_tokens": self.ckpt_tokens}


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Knobs for the recovery layer; defaults favor transparent retries.

    ``shed_after_boundaries`` arms load shedding: a queued request that
    stays inadmissible that many consecutive boundaries (sustained
    allocator/quota pressure) is dead-lettered instead of queueing
    forever.  None (default) never sheds.
    """
    max_retries: int = 3
    backoff_segments: int = 1           # quarantine wait after 1st fault
    backoff_factor: float = 2.0         # exponential per further retry
    max_backoff_segments: int = 32
    check_invariants: bool = False
    shed_after_boundaries: int | None = None
    watchdog_boundaries: int = 256

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_segments < 0 or self.max_backoff_segments < 0:
            raise ValueError("backoff bounds must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1.0")
        if self.shed_after_boundaries is not None \
                and self.shed_after_boundaries < 1:
            raise ValueError("shed_after_boundaries must be >= 1 or None")


class RecoveryManager:
    """Per-run fault bookkeeping: the quarantine pen, retry/backoff
    policy, swap-image verification, dead-letter records, and the
    invariant checker.  All device data movement stays in the engine;
    this object only decides and accounts (the ResourceManager split,
    applied to failure handling)."""

    def __init__(self, policy: RecoveryPolicy,
                 sched: "ContinuousBatchingScheduler"):
        self.policy = policy
        self.sched = sched
        self.rm = sched.rm
        # write-ahead journal (serving/journal.py), set by EngineRun when
        # durability is on: dead letters round-trip through it so a
        # restart re-emits the same typed terminal records
        self.journal = None
        # (request, boundary at which its backoff expires)
        self._quarantine: list[tuple["Request", int]] = []
        self.dead: list["Request"] = []
        self._queued_since: dict[Any, int] = {}   # rid -> boundary
        # stats()/diagnostic counters live in the scheduler's metrics
        # registry; the historical attributes read back through it, and
        # the tracer (None unless telemetry is on) gets the QUARANTINE/
        # RETRY/DEAD_LETTER lifecycle events
        self.obs = sched.obs
        self.tracer = self.obs.tracer
        self._rep = self.obs.replica
        rep = ("replica",)
        self._c_quar = self.obs.counter(
            "serving_quarantines_total",
            "requests quarantined, by fault site", ("replica", "site"))
        self._c_restarts = self.obs.counter(
            "serving_restarts_total",
            "quarantines that lost their swap image", rep)
        self._c_swapf = self.obs.counter(
            "serving_swap_faults_total",
            "corrupt/lost swap images detected pre-restore", rep)
        self._c_shed = self.obs.counter(
            "serving_shed_total",
            "queued requests shed under sustained pressure", rep)
        self._c_dispatch_faults = self.obs.counter(
            "serving_segment_dispatch_faults_total",
            "decode segment dispatches that raised", rep)
        self._c_retries = self.obs.counter(
            "serving_retries_total",
            "quarantined requests requeued after backoff", rep)
        self._c_inv = self.obs.counter(
            "serving_invariant_violations_total",
            "boundary-audit violations recorded", rep)
        self.invariant_violations: list[str] = []

    # --------------------------------------------- registry thin views
    @property
    def quarantines(self) -> int:
        return int(self._c_quar.total(replica=self._rep))

    @property
    def restarts(self) -> int:
        return int(self._c_restarts.total(replica=self._rep))

    @property
    def swap_faults_detected(self) -> int:
        return int(self._c_swapf.total(replica=self._rep))

    @property
    def shed(self) -> int:
        return int(self._c_shed.total(replica=self._rep))

    @property
    def segment_dispatch_faults(self) -> int:
        return int(self._c_dispatch_faults.total(replica=self._rep))

    @property
    def has_quarantined(self) -> bool:
        return bool(self._quarantine)

    # -------------------------------------------------------- checkpoints
    def checkpoint(self, running: Iterable["Request"]) -> None:
        """Record the boundary watermark every rollback targets.  Called
        once per boundary, after admissions and before the segment
        dispatch — the committed tokens at this instant are exactly what
        the device pages back."""
        for req in running:
            req.ckpt_tokens = len(req.tokens)

    # --------------------------------------------------------- quarantine
    def backoff(self, req: "Request") -> int:
        b = self.policy.backoff_segments * \
            self.policy.backoff_factor ** max(req.n_retries - 1, 0)
        return int(min(b, self.policy.max_backoff_segments))

    def hold(self, req: "Request", reason: str, boundary: int,
             now: float, site: str = "unknown") -> bool:
        """Quarantine ``req`` (already off-slot, pages released): bump
        its retry count and either park it for its backoff or dead-letter
        it when retries are exhausted.  Returns False on dead-letter."""
        req.n_retries += 1
        self._c_quar.inc(1.0, (self._rep, site))
        if req.swap is None:
            self._c_restarts.inc(1.0, (self._rep,))
        if self.tracer is not None:
            self.tracer.event(req.rid, "QUARANTINE", boundary, now,
                              site=site, reason=reason,
                              retries=req.n_retries,
                              has_image=req.swap is not None)
        if req.n_retries > self.policy.max_retries:
            self.dead_letter(req, f"retries exhausted after {reason}",
                             boundary, now, site=site)
            return False
        self._quarantine.append((req, boundary + self.backoff(req)))
        return True

    def release_due(self, boundary: int, now: float = 0.0) -> int:
        """Requeue quarantined requests whose backoff expired: verified
        host image → the tenant's preempted lane (one-dispatch restore);
        none → the pending lane (full restart)."""
        due = [(r, b) for r, b in self._quarantine if b <= boundary]
        if not due:
            return 0
        self._quarantine = [(r, b) for r, b in self._quarantine
                            if b > boundary]
        for req, _ in due:
            self.rm.requeue(req)
            self._c_retries.inc(1.0, (self._rep,))
            if self.tracer is not None:
                self.tracer.event(req.rid, "RETRY", boundary, now,
                                  retries=req.n_retries,
                                  has_image=req.swap is not None)
        return len(due)

    def drain_quarantined(self) -> "list[Request]":
        """Empty the quarantine pen (replica drain/failover): the cluster
        migrates these requests to another replica, backoff forgiven —
        the faulting engine is gone, so there is nothing to back off
        from."""
        out = [req for req, _ in self._quarantine]
        self._quarantine = []
        return out

    def reset_for_restart(self, req: "Request") -> None:
        """Strip a request back to as-submitted: no swap image, no
        tokens, no sharing state.  Greedy decode is deterministic, so a
        restart regenerates exactly the fault-free token stream."""
        req.swap = None
        req.tokens = []
        req.ckpt_tokens = 0
        req.shared_tokens = 0
        req.shared_pages = 0
        req.cow_src = None
        req.cow_dst = None
        req.restore_blocks = (0, 0)
        req.stalled = False
        req.protected = False
        req.slot = None

    # -------------------------------------------------------- dead letter
    def dead_letter(self, req: "Request", reason: str, boundary: int,
                    now: float, site: str = "unknown") -> None:
        req.swap = None
        req.failure = RequestFailed(rid=req.rid, tenant=req.tenant,
                                    reason=reason, boundary=boundary,
                                    retries=req.n_retries, site=site,
                                    ckpt_tokens=req.ckpt_tokens)
        req.t_done = now
        self.rm.note_dead_letter(req, site)
        self.dead.append(req)
        if self.tracer is not None:
            self.tracer.event(req.rid, "DEAD_LETTER", boundary, now,
                              site=site, reason=reason,
                              retries=req.n_retries)
        if self.journal is not None:
            self.journal.dead_letter(req.failure.record())

    # ------------------------------------------------------ swap integrity
    def verify_swaps(self, boundary: int, now: float) -> int:
        """Verify each queued restore's host image once (CRC recorded at
        swap-out).  A corrupted or lost image converts the request to a
        quarantined restart — scattering it back would poison the pool.
        Returns the number of conversions."""
        converted = 0
        for st in self.rm._tenants.values():
            keep: deque = deque()
            for req in st.preempted:
                sw = req.swap
                if sw is not None and not sw.verified:
                    sw.verified = True
                    lost = sw.host_k is None or sw.host_v is None
                    ok = not lost and (sw.checksum is None or sw.checksum
                                       == image_checksum(sw.host_k,
                                                         sw.host_v))
                    if not ok:
                        self._c_swapf.inc(1.0, (self._rep,))
                        self.reset_for_restart(req)
                        self.hold(req, "swap image corrupt or lost",
                                  boundary, now,
                                  site="swap_loss" if lost
                                  else "swap_corrupt")
                        converted += 1
                        continue
                keep.append(req)
            st.preempted = keep
        return converted

    # ------------------------------------------------------- load shedding
    def note_admitted(self, reqs: Iterable["Request"]) -> None:
        for req in reqs:
            self._queued_since.pop(req.rid, None)

    def shed_stalled(self, boundary: int, now: float) -> int:
        """Graceful degradation under sustained pressure: dead-letter any
        request queued (and inadmissible) for ``shed_after_boundaries``
        consecutive boundaries.  Disabled when the policy knob is None."""
        limit = self.policy.shed_after_boundaries
        if limit is None:
            return 0
        n = 0
        for st in self.rm._tenants.values():
            for lane in ("pending", "preempted"):
                keep: deque = deque()
                for req in getattr(st, lane):
                    first = self._queued_since.setdefault(req.rid,
                                                          boundary)
                    if boundary - first >= limit:
                        req.swap = None
                        self.dead_letter(
                            req, f"shed after {boundary - first} "
                            f"boundaries queued under pressure",
                            boundary, now, site="shed")
                        self._c_shed.inc(1.0, (self._rep,))
                        n += 1
                    else:
                        keep.append(req)
                setattr(st, lane, keep)
        return n

    # --------------------------------------------------- invariant checker
    def check_invariants(self, bt, seq_lens):
        """Audit the boundary state the dispatches are about to trust.
        Returns ``(per_request, global_violations)``: per-request entries
        are ``(request, why)`` pairs the engine quarantines (full
        restart — the state is suspect); global ledger drift cannot be
        attributed to one request and is recorded + surfaced in stats
        and the watchdog snapshot instead."""
        from repro_torch.serving.paged_cache import TRASH_PAGE
        sched = self.sched
        alloc = sched.allocator
        pcfg = sched.pcfg
        bad: list[tuple["Request", str]] = []
        for slot, req in sorted(sched.running.items()):
            pages = [int(p) for p in (req.pages or [])]
            row = [int(p) for p in bt[slot]]
            if row[:len(pages)] != pages:
                bad.append((req, "block-table row diverged from owned "
                            "pages"))
            elif any(p != TRASH_PAGE for p in row[len(pages):]):
                bad.append((req, "block-table coverage beyond owned "
                            "pages"))
            elif any(alloc.refcount(p) < 1 for p in pages):
                bad.append((req, "owned page with zero refcount"))
            elif int(seq_lens[slot]) > len(pages) * pcfg.page_size:
                bad.append((req, "resident tokens beyond owned page "
                            "coverage"))
        glob: list[str] = []
        live = sum(r.charged for r in sched.running.values())
        total = sum(st.charged for st in self.rm._tenants.values())
        if live != total:
            glob.append(f"quota ledger drift: running charges {live} != "
                        f"tenant charges {total}")
        if alloc.n_free + alloc.n_held != pcfg.allocatable_pages:
            glob.append(f"page ledger drift: free {alloc.n_free} + held "
                        f"{alloc.n_held} != pool "
                        f"{pcfg.allocatable_pages}")
        for req, why in bad:
            self.invariant_violations.append(f"{req.rid!r}: {why}")
        self.invariant_violations.extend(glob)
        if bad or glob:
            self._c_inv.inc(float(len(bad) + len(glob)), (self._rep,))
        return bad, glob

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {"quarantines": self.quarantines,
                "restarts": self.restarts,
                "swap_faults_detected": self.swap_faults_detected,
                "segment_dispatch_faults": self.segment_dispatch_faults,
                "shed": self.shed,
                "dead_lettered": len(self.dead),
                # structured per-request terminal records (site, tenant,
                # retries, checkpoint) — the bench/telemetry view of WHY
                # each dead letter died, not just how many did
                "dead_letter_records": [req.failure.record()
                                        for req in self.dead],
                "invariant_violations": list(self.invariant_violations)}


def diagnostic_snapshot(sched: "ContinuousBatchingScheduler",
                        recovery: RecoveryManager | None = None,
                        boundary: int | None = None,
                        **extra) -> dict:
    """Structured engine state for the watchdog (and debugging): queue
    depths, pool pressure, per-slot request state, recovery counters."""
    rm = sched.rm
    snap: dict = {
        "boundary": boundary,
        "free_pages": sched.allocator.n_free,
        "held_pages": sched.allocator.n_held,
        "free_slots": list(sched.free_slots),
        "queues": {name: {"pending": len(st.pending),
                          "preempted": len(st.preempted),
                          "deficit": st.deficit}
                   for name, st in sorted(rm._tenants.items())},
        "running": {int(slot): {"rid": req.rid, "tenant": req.tenant,
                                "n_pages": len(req.pages or []),
                                "n_tokens": len(req.tokens),
                                "stalled": req.stalled,
                                "protected": req.protected,
                                "n_retries": req.n_retries}
                    for slot, req in sorted(sched.running.items())},
        "stats": rm.stats(),
    }
    if recovery is not None:
        snap["recovery"] = recovery.stats()
        snap["quarantined"] = [
            {"rid": req.rid, "tenant": req.tenant,
             "release_boundary": b, "n_retries": req.n_retries,
             "has_image": req.swap is not None}
            for req, b in recovery._quarantine]
    snap.update(extra)
    return snap
