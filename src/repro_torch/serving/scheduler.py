"""Continuous-batching scheduler over the quota-aware resource manager.

The engine (serving/engine.py) decodes in fixed-length scan *segments*;
this scheduler is the host-side brain that runs at segment boundaries,
with every page/quota/victim decision delegated to
:class:`~repro_torch.serving.resources.ResourceManager`:

- ``submit`` queues a request onto its tenant's FIFO queue (validated
  once against pool capacity and the tenant's page budget);
- ``plan_growth`` (first at each boundary) tops every running request up
  to the next segment's page coverage — growth-on-demand instead of the
  old whole-lifetime reservation.  A dry pool first evicts the prefix
  cache's retention pins, then **preempts** a victim (swap its pages to
  host, recycle them); a quota-dry tenant can only preempt its own
  requests.  A grower with no admissible victim *stalls* for one segment
  (inactive, its frozen write slot still backed by pages it owns) and
  retries at the next boundary.
- ``try_admit`` runs deficit-round-robin across tenant queues — restores
  ahead of fresh admissions, FIFO within a tenant (no overtaking), each
  admission billed its *marginal* fresh pages (prefix-shared pages are
  free).  Fresh admissions map the longest resident prompt prefix from
  the trie exactly as before; preempted requests re-admit with a
  prefix-trie re-match plus a host swap-in plan for the remainder.
  Admission never preempts — only a running request's growth does — so
  a queued burst cannot evict in-flight work.
- ``complete`` retires a finished request; all page accounting flows
  through the allocator's refcounts via ``ResourceManager.release_request``
  (the PR-3/4 scheduler kept a parallel whole-lifetime page count that
  growth-on-demand made wrong; the refcounts are now the only truth).
- ``end_segment`` clears the anti-livelock ``protected`` flag on every
  request that generated through the segment — from then on it is a
  preemption candidate again.

The scheduler moves no device data: the engine executes the swap
(``device_get`` before any same-boundary dispatch) and the one-dispatch
restore scatter, in the order run() documents.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np

from repro_torch.serving.paged_cache import PagedCacheConfig
from repro_torch.serving.resources import (DEFAULT_TENANT, AdmissionPlan,
                                     ResourceManager, SwapState,
                                     TenantConfig)


@dataclasses.dataclass
class Request:
    """One generation request plus its runtime bookkeeping."""
    rid: Any
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int
    arrival: float = 0.0               # offset from engine start (bench)
    tenant: str = DEFAULT_TENANT

    # runtime state, owned by the scheduler/resource manager/engine
    slot: int | None = None
    pages: list[int] | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    t_admitted: float | None = None
    t_first: float | None = None       # first token on device (TTFT)
    t_done: float | None = None
    # prefix-sharing state: tokens [0, shared_tokens) are served by mapped
    # pages; the engine prefills only [shared_tokens, prompt_len).
    shared_tokens: int = 0
    shared_pages: int = 0              # full pages mapped from the trie
    cow_src: int | None = None         # tail page to copy-on-write from
    cow_dst: int | None = None         # the request's own tail page
    # resource-manager state
    charged: int = 0                   # fresh pages billed to the tenant
    admit_seq: int = -1                # admission order (victim policy)
    protected: bool = False            # anti-livelock: no preemption yet
    stalled: bool = False              # growth denied; inactive one segment
    swap: SwapState | None = None      # host image while preempted
    n_preempted: int = 0               # times this request was swapped out
    preempted_by: Any = None           # rid of the grower that evicted us
    # host-image block range [b0, b1) the engine scatters on restore (the
    # blocks before b0 were re-matched from the prefix trie)
    restore_blocks: tuple[int, int] = (0, 0)
    # recovery state (serving/recovery.py): the boundary checkpoint every
    # rollback targets, the bounded retry count, and — for dead-lettered
    # requests — the typed RequestFailed terminal record
    ckpt_tokens: int = 0               # committed tokens at last boundary
    n_retries: int = 0                 # quarantine cycles so far
    failure: Any = None                # RequestFailed when dead-lettered

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return self.t_done is not None


class ContinuousBatchingScheduler:
    @classmethod
    def from_plan(cls, plan, *, faults=None, obs=None
                  ) -> "ContinuousBatchingScheduler":
        """Construct from a :class:`~repro_torch.serving.plan.ServingPlan` —
        cache geometry, effective sharing flag, and tenant roster all
        come from the one declarative artifact."""
        return cls(plan.cache, sharing=plan.sharing,
                   tenants=plan.tenants or None, faults=faults,
                   obs=obs)

    def __init__(self, pcfg: PagedCacheConfig, *,
                 sharing: bool | None = None,
                 tenants: Iterable[TenantConfig] | None = None,
                 faults=None, obs=None):
        self.pcfg = pcfg
        self.rm = ResourceManager(pcfg, tenants, sharing=sharing,
                                  faults=faults, obs=obs)
        self.obs = self.rm.obs
        self._rep = self.obs.replica
        self._c_blocked = self.obs.counter(
            "serving_admission_blocked_total",
            "admission attempts held back, by reason",
            ("replica", "reason"))
        self._c_rounds = self.obs.counter(
            "serving_admission_rounds_total",
            "deficit-round-robin rounds of admission planning",
            ("replica",))
        self._c_plans = self.obs.counter(
            "serving_admission_plans_total",
            "admission plans computed (one per queue head tried)",
            ("replica",))
        # gauges only exist when telemetry is on (NULL_METRIC otherwise)
        self._g_deficit = self.obs.gauge(
            "serving_tenant_deficit_pages",
            "DRR credit per tenant at boundary end",
            ("replica", "tenant"))
        # aliases: the allocator/trie are owned by the resource manager
        self.allocator = self.rm.allocator
        self.sharing = self.rm.sharing
        self.prefix_cache = self.rm.prefix_cache
        self.running: dict[int, Request] = {}       # slot -> request
        self.free_slots = sorted(range(pcfg.max_slots))
        self.finished: list[Request] = []
        self.n_admitted = 0

    @property
    def pending(self) -> list[Request]:
        """Queued requests across all tenants (restores first)."""
        return self.rm.queued()

    @property
    def has_work(self) -> bool:
        return bool(self.rm.has_queued or self.running)

    def submit(self, req: Request) -> None:
        self.rm.validate(req)
        self.rm.enqueue(req)

    # ------------------------------------------------- growth + preemption
    def plan_growth(self) -> list[Request]:
        """Top every running request up to next-segment page coverage,
        preempting victims when allocations bounce.  Oldest admissions
        grow first (they are closest to finishing — freeing everything).
        Returns the preempted requests, whose ``swap`` snapshots the
        engine must ``device_get`` before its next dispatch."""
        preempted: list[Request] = []
        for req in sorted(self.running.values(), key=lambda r: r.admit_seq):
            if req.swap is not None:
                continue                  # preempted earlier this boundary
            need = self.rm.growth_need(req)
            if need == 0:
                req.stalled = False
                continue
            while True:
                pages, reason = self.rm.grow(req, need)
                if pages is not None:
                    req.stalled = False
                    break
                if reason == "pool":
                    short = need - self.rm.allocator.n_free
                    if self.rm.release_pressure(short) > 0:
                        continue          # pins yielded: retry the alloc
                    victim = self.rm.pick_victim(self.running.values(),
                                                 exclude=req)
                else:                     # quota: the tenant evicts itself
                    victim = self.rm.pick_victim(self.running.values(),
                                                 exclude=req,
                                                 tenant=req.tenant)
                if victim is None:
                    req.stalled = True    # safe: coverage >= frozen slot
                    break
                self._preempt(victim, grower=req)
                preempted.append(victim)
        return preempted

    def _preempt(self, victim: Request,
                 grower: Request | None = None) -> None:
        self.rm.preempt(victim)           # snapshot + release + requeue
        victim.n_preempted += 1
        victim.preempted_by = grower.rid if grower is not None else None
        self.vacate(victim)

    def vacate(self, req: Request) -> int:
        """Free a request's slot without completing it — the
        scheduler-side half of emptying a slot, shared by preemption,
        fault quarantine, and drain evacuation (the engine parks the
        device row on the scratch page).  Returns the freed slot."""
        slot = req.slot
        del self.running[slot]
        self.free_slots.append(slot)
        self.free_slots.sort()
        req.slot = None
        req.stalled = False
        req.protected = False
        return slot

    # ----------------------------------------------------------- admission
    def try_admit(self) -> list[Request]:
        """Deficit-round-robin admission across tenant queues.

        Each round every tenant with queued work accrues
        ``weight x quantum`` pages of deficit and admits queue heads
        while the deficit covers their marginal (fresh-page) cost and a
        slot + pages + quota headroom exist.  A blocked head blocks its
        tenant's queue (no overtaking); rounds continue while someone is
        deficit-blocked, bounded by ``ResourceManager.max_rounds``.
        Restored requests come back ``swap is not None`` — the engine
        runs their swap-in scatter instead of a prefill.

        The call is the ``serve.plan`` span; its rounds and
        ``plan_admission`` calls add to ``serving_admission_rounds_total``
        and ``serving_admission_plans_total``."""
        tracer = self.obs.tracer
        with self.obs.span("serve.plan") as sp:
            if tracer is not None:
                blocked0 = dict(self._c_blocked.series)
            admitted, rounds, plans = self._drr_rounds()
            lab = (self._rep,)
            self._c_rounds.inc(rounds, lab)
            self._c_plans.inc(plans, lab)
            if tracer is not None:
                sp.set(rounds=rounds, plans=plans,
                       admitted=[r.rid for r in admitted],
                       blocked={k[1]: v - blocked0.get(k, 0.0)
                                for k, v in self._c_blocked.series.items()
                                if k[0] == self._rep
                                and v != blocked0.get(k, 0.0)})
        return admitted

    def _drr_rounds(self) -> tuple[list[Request], int, int]:
        """``try_admit``'s rounds; returns (admitted, rounds, plans)."""
        admitted: list[Request] = []
        rounds = plans = 0
        if not self.free_slots or not self.rm.has_queued:
            return admitted, rounds, plans
        order = self.rm.rotation()
        for _ in range(self.rm.max_rounds()):
            if not self.rm.has_queued:
                break                     # every credit is already 0
            rounds += 1
            any_admit = False
            deficit_blocked = False
            for st in order:
                if not st.has_queued:
                    st.deficit = 0.0      # classic DRR: credit dies idle
                    continue
                # cap at the costliest possible admission: a head blocked
                # on pages for many boundaries must not bank unbounded
                # credit and later lock out every other tenant
                st.deficit = min(st.deficit + st.cfg.weight
                                 * self.rm.quantum,
                                 float(self.pcfg.allocatable_pages))
                while self.free_slots and st.has_queued:
                    req = st.head()
                    plan = self.rm.plan_admission(req)
                    plans += 1
                    if not isinstance(plan, AdmissionPlan):
                        # quota/pool: head holds the line
                        self._c_blocked.inc(1.0, (self._rep, plan))
                        break
                    if plan.cost > st.deficit:
                        deficit_blocked = True
                        self._c_blocked.inc(1.0, (self._rep, "deficit"))
                        break
                    if not self.rm.commit_admission(plan):
                        break             # optimistic pins freed nothing
                    st.pop_head()
                    st.deficit -= plan.cost
                    req.restore_blocks = plan.restore_blocks
                    req.slot = self.free_slots.pop(0)
                    self.running[req.slot] = req
                    self.n_admitted += 1
                    admitted.append(req)
                    any_admit = True
                if not st.has_queued:
                    st.deficit = 0.0
            if not any_admit and not deficit_blocked:
                break
        return admitted, rounds, plans

    def finish_boundary(self, admitted: list[Request]) -> None:
        """Called by the engine after the boundary dispatches: CoW copies
        and restore scatters have landed (drop source pins, drop host
        images) and the admitted requests' K/V is on device (trie entries
        become ready)."""
        for req in admitted:
            if req.cow_src is not None:
                self.rm.allocator.release([req.cow_src])
                req.cow_src = None
            req.swap = None               # host image no longer needed
        if self.prefix_cache is not None:
            self.prefix_cache.mark_ready()
        if self.obs.enabled:
            for name, st in self.rm._tenants.items():
                self._g_deficit.set(st.deficit, (self._rep, name))

    def end_segment(self, generated_slots: Iterable[int]) -> None:
        """Anti-livelock bookkeeping: a request that generated through a
        full segment loses its protection and becomes preemptable."""
        for slot in generated_slots:
            req = self.running.get(slot)
            if req is not None:
                req.protected = False

    def complete(self, slot: int) -> Request:
        """Retire the request in ``slot``.  All page bookkeeping is the
        allocator's refcounts (ResourceManager.release_request): pages
        whose last reference dies are free for the very next admission."""
        req = self.running.pop(slot)
        self.rm.release_request(req)
        req.slot = None
        self.free_slots.append(slot)
        self.free_slots.sort()
        self.finished.append(req)
        return req

    def stats(self) -> dict[str, Any]:
        """Resource/prefix counters for benches and telemetry."""
        return self.rm.stats()
