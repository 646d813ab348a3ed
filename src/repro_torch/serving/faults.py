"""Deterministic fault-injection harness for the serving stack.

MetaML's design-flow thesis is that a flow must survive bad candidate
stages automatically instead of dying on the first anomaly; the serving
engine's analogue is surviving runtime faults — allocation failures,
corrupted host-swap images, poisoned decode numerics, failed dispatches
— without taking down co-resident tenants.  You cannot test that
property without a way to *cause* those faults, and chaos that is not
reproducible is useless in CI.  This module provides the cause:

- A :class:`FaultPlan` is a seed-driven schedule of injections over
  named :data:`SITES`.  Every decision is drawn from a per-site
  ``numpy`` generator keyed on ``(seed, crc32(site))``, and sites count
  their *opportunities* (times the instrumented code path asked),
  so a plan replays bit-exactly whenever the engine's boundary
  schedule replays — which it does: the scheduler is deterministic
  given the request set.
- Injection sites are threaded through the stack as plain
  ``plan.should_fire(site)`` probes: the page allocator
  (``serving/paged_cache.py`` — alloc returns None as if the pool were
  dry), the engine's swap-out path (host image corrupted or dropped
  after its checksum is recorded), the decode segment (a NaN poisoned
  into one slot's logits, in-graph), and the boundary dispatches
  (``plan.gate(site)`` raises :class:`InjectedFault` instead of
  dispatching).
- Plans terminate by construction: every armed site carries a
  ``max_fires`` bound, so a chaos run eventually reverts to fault-free
  behavior — the property the recovery layer's liveness argument
  (``serving/recovery.py``) needs.

The harness is pure host-side bookkeeping (numpy only) and
costs nothing when no plan is installed: every probe is behind a
``plan is not None`` check in the instrumented modules.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

# Injection sites, in stack order.  Each names one instrumented probe:
#   alloc            PageAllocator.alloc returns None (pool "dry")
#   swap_corrupt     host swap image bytes flipped after checksum capture
#   swap_loss        host swap image dropped entirely
#   decode_poison    NaN added to one slot's logits inside the segment scan
#   dispatch_admit   an admission prefill dispatch raises InjectedFault
#   dispatch_restore a restore scatter dispatch raises InjectedFault
#   dispatch_segment the decode segment dispatch raises InjectedFault
ENGINE_SITES = ("alloc", "swap_corrupt", "swap_loss", "decode_poison",
                "dispatch_admit", "dispatch_restore", "dispatch_segment")
# Replica-level sites, probed by the cluster loop (serving/cluster.py)
# once per live replica per round — never inside a single engine run:
#   replica_crash    the replica's device state is destroyed; its host
#                    loop stops stepping and its heartbeats cease
#   replica_hang     the replica stops stepping indefinitely (heartbeats
#                    cease) but nothing is destroyed — indistinguishable
#                    from a crash to the health model, which is the point
#   heartbeat_loss   one round's heartbeat is dropped while the replica
#                    keeps stepping — exercises false-positive resilience
#                    (a healthy replica marked SUSPECT must recover, and
#                    one fenced DEAD must stay fenced)
REPLICA_SITES = ("replica_crash", "replica_hang", "heartbeat_loss")
# Process-level sites, probed only when a write-ahead journal is armed
# (serving/journal.py) — without one a process death is unrecoverable and
# injecting it would only prove the obvious:
#   wal_torn_write   one journal record reaches disk truncated and the
#                    writer goes dark — the classic crash-mid-write tail
#                    that replay must drop, not die on
#   wal_lost_fsync   one fsync batch silently never reaches disk (page
#                    cache lost at crash); later batches may still land,
#                    so replay sees a record *hole*, not a prefix
#   process_crash    the whole process dies between boundaries: raised
#                    as ProcessCrashed out of EngineRun.step after the
#                    journal drops its unflushed buffer (kill -9
#                    semantics: only fsync'd records survive)
PROCESS_SITES = ("wal_torn_write", "wal_lost_fsync", "process_crash")
SITES = ENGINE_SITES + REPLICA_SITES + PROCESS_SITES
FAULT_SITES = SITES                     # package-level export alias


class InjectedFault(RuntimeError):
    """Raised by ``FaultPlan.gate`` at a dispatch site.  The recovery
    layer catches exactly this type (plus AllocatorError) — real bugs
    keep their own exception types and still fail loudly."""

    def __init__(self, site: str, opportunity: int):
        super().__init__(f"injected fault at site {site!r} "
                         f"(opportunity {opportunity})")
        self.site = site
        self.opportunity = opportunity


class ProcessCrashed(RuntimeError):
    """The ``process_crash`` site fired: the serving process is "dead".
    Deliberately NOT an :class:`InjectedFault` subclass — the in-process
    recovery layer must never catch it (a dead process cannot heal
    itself); it propagates out of ``run()`` and the journal's
    :class:`~repro_torch.serving.journal.RestartRecovery` is the only way
    back."""

    def __init__(self, boundary: int):
        super().__init__(f"injected process crash at boundary {boundary}")
        self.boundary = boundary


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Arming of one site: skip the first ``after`` opportunities, then
    fire with probability ``rate`` per opportunity, at most ``max_fires``
    times.  ``rate=1.0, max_fires=1`` is a scheduled one-shot."""
    site: str
    rate: float = 1.0
    max_fires: int = 1
    after: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites are {SITES}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"{self.site}: rate must be in [0, 1]")
        if self.max_fires < 1:
            raise ValueError(f"{self.site}: max_fires must be >= 1 "
                             f"(plans must terminate)")
        if self.after < 0:
            raise ValueError(f"{self.site}: after must be >= 0")


def _site_rng(seed: int, site: str) -> np.random.Generator:
    """Per-site stream: independent of every other site's draw count,
    so adding a probe at one site never perturbs another's schedule."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFF,
                                  zlib.crc32(site.encode())])


class FaultPlan:
    """A reproducible injection schedule over :data:`SITES`.

    State is per-plan (opportunity/fire counters + a fired log), so a
    fresh plan with the same seed and specs replays identically; reusing
    one plan across engine runs continues its counters — construct a new
    plan per run when you want replay.
    """

    def __init__(self, specs: "list[FaultSpec] | tuple" = (),
                 seed: int = 0):
        self.seed = int(seed)
        self.specs: dict[str, FaultSpec] = {}
        for spec in specs:
            if spec.site in self.specs:
                raise ValueError(f"duplicate spec for site {spec.site!r}")
            self.specs[spec.site] = spec
        self._rng = {site: _site_rng(self.seed, site)
                     for site in self.specs}
        self.opportunities = {site: 0 for site in SITES}
        self.fires = {site: 0 for site in SITES}
        self.log: list[tuple[str, int]] = []   # (site, opportunity idx)
        # optional telemetry taps (serving/observe.py), attached by the
        # engine/cluster when observability is threaded through: a
        # Counter handle labeled (site,) and a (site, opportunity)
        # callable emitting a FAULT trace event.  Both stay outside the
        # draw path, so attaching them never perturbs a schedule.
        self.metrics = None
        self.trace_hook = None

    # ------------------------------------------------------ constructors
    @classmethod
    def at(cls, seed: int = 0, **site_nth: int) -> "FaultPlan":
        """Scheduled one-shots: ``FaultPlan.at(alloc=2, decode_poison=0)``
        fires each named site exactly once, at its nth opportunity
        (0-indexed)."""
        return cls([FaultSpec(site=s, rate=1.0, max_fires=1, after=n)
                    for s, n in site_nth.items()], seed=seed)

    @classmethod
    def seeded(cls, seed: int, sites=SITES, rate: float = 0.1,
               max_fires: int = 2, after: int = 0) -> "FaultPlan":
        """Probabilistic chaos over ``sites``, bounded per site."""
        return cls([FaultSpec(site=s, rate=rate, max_fires=max_fires,
                              after=after) for s in sites], seed=seed)

    # ------------------------------------------------------------ probes
    def should_fire(self, site: str) -> bool:
        """One opportunity at ``site``; True when the plan injects here."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}")
        k = self.opportunities[site]
        self.opportunities[site] = k + 1
        spec = self.specs.get(site)
        if spec is None or k < spec.after \
                or self.fires[site] >= spec.max_fires:
            return False
        # draw only when armed: disarming a site never shifts the stream
        if spec.rate < 1.0 and self._rng[site].random() >= spec.rate:
            return False
        self.fires[site] += 1
        self.log.append((site, k))
        if self.metrics is not None:
            self.metrics.inc(1.0, (site,))
        if self.trace_hook is not None:
            self.trace_hook(site, k)
        return True

    def gate(self, site: str) -> None:
        """Dispatch-site probe: raise instead of returning True."""
        if self.should_fire(site):
            raise InjectedFault(site, self.opportunities[site] - 1)

    @property
    def total_fires(self) -> int:
        return len(self.log)

    def summary(self) -> dict:
        """JSON-safe record of what actually fired (bench/telemetry)."""
        return {"seed": self.seed,
                "specs": {s: dataclasses.asdict(sp)
                          for s, sp in sorted(self.specs.items())},
                "fired": [list(e) for e in self.log],
                "opportunities": {s: n for s, n
                                  in sorted(self.opportunities.items())
                                  if n}}


# ------------------------------------------------- host-image integrity
def image_checksum(*arrays) -> int:
    """CRC32 over the host swap image — recorded at swap-out (before any
    injected corruption), verified once before a restore is planned."""
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc


def corrupt_image(arr: np.ndarray) -> np.ndarray:
    """Deterministically flip the first bytes of ``arr`` — the
    swap_corrupt site's payload.  Returns a new array (device_get views
    may be read-only)."""
    buf = bytearray(np.ascontiguousarray(arr).tobytes())
    for i in range(min(8, len(buf))):
        buf[i] ^= 0xFF
    return np.frombuffer(bytes(buf), dtype=arr.dtype).reshape(arr.shape)
