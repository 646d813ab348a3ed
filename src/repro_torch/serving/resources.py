"""Quota-aware preemptive resource manager for the paged serving stack.

MetaML's thesis is that resource-constrained optimization decisions should
be automated policy, not hand tuning; this module is that policy layer for
the serving engine's budgeted resource — KV pages.  It replaces the PR-3
whole-lifetime reservation (``prompt + max_new + 1`` tokens locked at
admission) with three cooperating mechanisms:

- **Growth-on-demand paging** — an admission backs only the prompt plus
  one decode segment (:meth:`PagedCacheConfig.admission_tokens`); every
  later segment boundary tops a running request up to the next segment's
  coverage in :attr:`~PagedCacheConfig.growth_granule` multiples
  (:meth:`ResourceManager.growth_need` / :meth:`grow`).  The pool packs
  by what requests have *written*, not what they might write, so bursty
  admission waves co-reside where lifetime reservation would serialize.

- **Host-swap preemption** — when a growth allocation finds the pool dry
  (after the prefix cache's retention pins have been pressure-evicted),
  a victim is preempted: :meth:`preempt` snapshots its block-ordered page
  list + control state into a :class:`SwapState`, the engine
  copies those pages to host memory, and the pages are
  released for the grower.  Re-admission is a *one-dispatch restore*:
  the prefix trie is consulted first (a still-resident prompt prefix is
  re-mapped by refcount, no data moves), and only the remaining blocks
  are scattered back from the host copy.  The anti-livelock rule: a
  restored request is ``protected`` — not a preemption candidate — until
  it has generated through one full decode segment.  Liveness follows:
  preemption only ever transfers pages to a *running* request whose
  remaining demand is finite, and a preempted request re-admits through
  the ordinary (never-preempting) admission path once pages free up.

- **Multi-tenant quotas + weighted scheduling** — every request carries a
  tenant; each tenant has a page budget and a scheduling weight
  (:class:`TenantConfig`).  Admission is deficit-round-robin across
  per-tenant FIFO queues (restores ahead of fresh admissions, no
  overtaking within a tenant): each round a tenant's deficit grows by
  ``weight x quantum`` pages and it admits heads while the deficit
  covers their *marginal* cost.  Quota accounting is marginal too — a
  prefix-shared page is charged to nobody but its allocator refcounts;
  a sharer pays only for its CoW fork and suffix pages — so sharing a
  system prompt never burns the sharer's budget.  A tenant at its budget
  can only preempt *its own* requests (quota pressure is private); pool
  pressure picks the victim from the most-over-share tenant
  (``charged / weight``), newest request first, so one tenant's burst is
  fed back to that tenant and cannot starve another's latency SLO.

The manager is pure host-side mechanism + policy: all device data
movement (page extraction, restore scatter) is executed by the engine at
segment boundaries, strictly before any dispatch that could overwrite a
released page.  ``scheduler.py`` drives the boundary protocol; this
module owns every page, charge, and victim decision.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import TYPE_CHECKING, Any, Iterable

from repro_torch.serving.observe import Observability
from repro_torch.serving.paged_cache import (PageAllocator, PagedCacheConfig,
                                       PrefixCache, PrefixMatch)

if TYPE_CHECKING:                        # import cycle: scheduler imports us
    from repro_torch.serving.scheduler import Request

DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's share of the pool.

    ``page_budget`` caps the pages *charged* to the tenant at any instant
    (marginal accounting: prefix-shared pages are free, CoW forks and
    suffix/decode pages are not); None means the whole allocatable pool.
    ``weight`` scales the tenant's deficit-round-robin quantum — a
    weight-2 tenant admits twice the pages per round of a weight-1 one
    when both have queued work.
    """
    name: str
    weight: float = 1.0
    page_budget: int | None = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.page_budget is not None and self.page_budget < 1:
            raise ValueError(f"tenant {self.name!r}: page_budget must be "
                             f">= 1 (or None for the whole pool)")


@dataclasses.dataclass
class SwapState:
    """Host-side image of a preempted request, captured at the boundary.

    ``pages`` is the block-ordered physical page list that held tokens
    ``[0, n_tokens)`` at preemption time — snapshotted *before* release so
    the engine can ``device_get`` the K/V out of the pool before any
    later dispatch recycles those pages.  ``slot`` is the batch row the
    request vacated (the engine parks it on the scratch page).
    """
    pages: list[int]
    n_tokens: int                       # cache tokens resident at preempt
    slot: int
    host_k: Any = None                  # (L, len(pages), ps, KV, hd)
    host_v: Any = None
    # Integrity: CRC of (host_k, host_v) recorded by the engine at
    # device_get time; the recovery layer verifies it once before the
    # restore is planned and converts a mismatch (or a lost image) into
    # a full restart instead of scattering garbage K/V into the pool.
    checksum: int | None = None
    verified: bool = False


@dataclasses.dataclass
class _TenantState:
    cfg: TenantConfig
    rm: Any = None                      # owning ResourceManager backref
    pending: deque = dataclasses.field(default_factory=deque)
    preempted: deque = dataclasses.field(default_factory=deque)
    deficit: float = 0.0                # DRR credit, in pages
    charged: int = 0                    # pages currently charged

    # Lifetime counters (the bench/JSON schema) are thin views over the
    # metrics registry — the registry is the only bookkeeping, these
    # properties just filter it down to (replica, tenant).
    def _ctr(self, handle) -> int:
        return int(handle.value((self.rm._rep, self.cfg.name)))

    @property
    def admitted(self) -> int:
        return self._ctr(self.rm._c_admitted)

    @property
    def preempted_n(self) -> int:
        return self._ctr(self.rm._c_preempt)

    @property
    def restored(self) -> int:
        return self._ctr(self.rm._c_restores)

    @property
    def pages_swapped(self) -> int:     # pages device_get'd out on preempt
        return self._ctr(self.rm._c_swap_out)

    @property
    def dead_lettered(self) -> int:     # requests ended in RequestFailed
        return int(self.rm._c_dead.total(replica=self.rm._rep,
                                         tenant=self.cfg.name))

    @property
    def has_queued(self) -> bool:
        return bool(self.pending or self.preempted)

    def head(self) -> "Request | None":
        """Next admissible request: restores before fresh, FIFO within."""
        if self.preempted:
            return self.preempted[0]
        if self.pending:
            return self.pending[0]
        return None

    def pop_head(self) -> "Request":
        return (self.preempted.popleft() if self.preempted
                else self.pending.popleft())


@dataclasses.dataclass(frozen=True)
class AdmissionPlan:
    """Everything an admission needs, decided before any state moves."""
    req: "Request"
    cost: int                           # fresh pages to charge
    n_shared: int                       # trie full pages re-mapped
    match: Any = None                   # PrefixMatch (fresh admissions)
    restore_blocks: tuple[int, int] = (0, 0)   # host blocks to scatter


class ResourceManager:
    """Owns the page allocator, tenant accounting, and preemption policy.

    Every page the serving stack touches moves through this object, and
    page *accounting* is exactly the allocator's refcounts: a request's
    ``pages`` list is its block table, ``charged`` is the fresh-page
    count billed to its tenant, and release/refund happen in one place
    (:meth:`release_request`) regardless of how the request ends —
    completion, preemption, or engine teardown.
    """

    @classmethod
    def from_plan(cls, plan, *, faults=None, obs=None) -> "ResourceManager":
        """Construct from a :class:`~repro_torch.serving.plan.ServingPlan`:
        pool geometry, tenant roster, and the plan's effective sharing
        flag (prefix sharing requires the batched prefill path)."""
        return cls(plan.cache, plan.tenants or None,
                   sharing=plan.sharing, faults=faults, obs=obs)

    def __init__(self, pcfg: PagedCacheConfig,
                 tenants: Iterable[TenantConfig] | None = None,
                 *, sharing: bool | None = None, faults=None, obs=None):
        self.pcfg = pcfg
        self.allocator = PageAllocator(pcfg.n_pages, faults=faults)
        self.sharing = (pcfg.enable_prefix_sharing if sharing is None
                        else bool(sharing))
        self.prefix_cache = PrefixCache(
            self.allocator, pcfg.page_size,
            chunk_pages=pcfg.prefix_chunk_pages,
            retain_pages=pcfg.retain_pages) if self.sharing else None
        self._tenants: dict[str, _TenantState] = {}
        for t in tenants or ():
            self._tenants[t.name] = _TenantState(cfg=t, rm=self)
        # with an explicit tenant roster, unknown names are rejected at
        # submit — auto-registering them would hand a typo'd tenant a
        # default (whole-pool) budget and silently void the quotas
        self._closed_roster = bool(self._tenants)
        self._rr = 0                     # DRR rotation origin
        self._admit_seq = 0
        # All page-movement counters live in the metrics registry —
        # labeled (replica, tenant) so a cluster's replicas share one
        # store — and the legacy attributes/stats() keys read back
        # through it.  Counters are live even with telemetry disabled
        # (a fresh disabled Observability per manager keeps independent
        # engines isolated).
        self.obs = obs if obs is not None else Observability.disabled()
        self._rep = self.obs.replica
        lab = ("replica", "tenant")
        self._c_admitted = self.obs.counter(
            "serving_admitted_total",
            "fresh admissions committed", lab)
        self._c_preempt = self.obs.counter(
            "serving_preemptions_total",
            "requests host-swap preempted", lab)
        self._c_restores = self.obs.counter(
            "serving_restores_total",
            "preempted requests restored", lab)
        self._c_swap_out = self.obs.counter(
            "serving_pages_swapped_out_total",
            "pages device_get to host on preempt", lab)
        self._c_swap_in = self.obs.counter(
            "serving_pages_swapped_in_total",
            "host pages scattered back on restore", lab)
        self._c_grown = self.obs.counter(
            "serving_pages_grown_total",
            "pages added by growth-on-demand", lab)
        self._c_dead = self.obs.counter(
            "serving_dead_letters_total",
            "requests ended in typed RequestFailed",
            ("replica", "tenant", "site"))

    # ------------------------------------------------- registry thin views
    # The historical total attributes, as read-only filters over the
    # shared registry (per-tenant splits live on _TenantState).
    @property
    def preemptions(self) -> int:
        return int(self._c_preempt.total(replica=self._rep))

    @property
    def restores(self) -> int:
        return int(self._c_restores.total(replica=self._rep))

    @property
    def pages_swapped_out(self) -> int:
        return int(self._c_swap_out.total(replica=self._rep))

    @property
    def pages_swapped_in(self) -> int:
        return int(self._c_swap_in.total(replica=self._rep))

    @property
    def pages_grown(self) -> int:
        return int(self._c_grown.total(replica=self._rep))

    @property
    def dead_letters(self) -> int:
        return int(self._c_dead.total(replica=self._rep))

    def note_dead_letter(self, req: "Request", site: str) -> None:
        """Called by the recovery layer when a request dead-letters —
        the one increment behind every dead-letter count."""
        self._c_dead.inc(1.0, (self._rep, req.tenant, site))

    # ------------------------------------------------------------ tenants
    def state(self, name: str) -> _TenantState:
        """Tenant state.  Without an explicit roster, unknown tenants
        auto-register with defaults (unlimited budget, weight 1) so
        single-tenant callers never have to mention tenants at all; with
        one, an unknown name is an error — quotas only isolate if no
        request can route around them."""
        st = self._tenants.get(name)
        if st is None:
            if self._closed_roster:
                raise ValueError(
                    f"unknown tenant {name!r}: the configured roster is "
                    f"{sorted(self._tenants)}")
            st = _TenantState(cfg=TenantConfig(name=name), rm=self)
            self._tenants[name] = st
        return st

    def budget(self, name: str) -> int:
        b = self.state(name).cfg.page_budget
        return self.pcfg.allocatable_pages if b is None else b

    def headroom(self, name: str) -> int:
        return self.budget(name) - self.state(name).charged

    def validate(self, req: "Request") -> None:
        """Reject at submit what can never run: the whole-lifetime page
        demand must fit the pool *and* the tenant's budget (all those
        pages are simultaneously resident on the final decode step;
        prefix sharing may reduce the realized charge, but admission
        cannot rely on what may have been evicted by then)."""
        need = self.pcfg.validate_request(req.prompt_len,
                                          req.max_new_tokens)
        budget = self.budget(req.tenant)
        if need > budget:
            raise ValueError(
                f"request {req.rid!r}: lifetime demand of {need} pages "
                f"exceeds tenant {req.tenant!r} page_budget {budget}")

    def enqueue(self, req: "Request") -> None:
        self.state(req.tenant).pending.append(req)

    def queued(self) -> list["Request"]:
        """All queued requests, restores first, FIFO within each class."""
        out: list[Request] = []
        for st in self._tenants.values():
            out.extend(st.preempted)
        for st in self._tenants.values():
            out.extend(st.pending)
        return out

    @property
    def has_queued(self) -> bool:
        return any(st.has_queued for st in self._tenants.values())

    def drain_queued(self) -> list["Request"]:
        """Pop every queued request (both lanes, all tenants, restores
        first) and zero the DRR credit.  The cluster's drain/failover
        path migrates the returned requests to another replica; nothing
        queued holds pages, so no allocator state moves."""
        out: list[Request] = []
        for name in sorted(self._tenants):
            st = self._tenants[name]
            out.extend(st.preempted)
            st.preempted = deque()
        for name in sorted(self._tenants):
            st = self._tenants[name]
            out.extend(st.pending)
            st.pending = deque()
            st.deficit = 0.0
        return out

    # ------------------------------------------------------------- sizing
    def lifetime_pages(self, req: "Request") -> int:
        return self.pcfg.pages_for(
            self.pcfg.lifetime_tokens(req.prompt_len, req.max_new_tokens))

    def admission_pages(self, req: "Request") -> int:
        return self.pcfg.pages_for(
            self.pcfg.admission_tokens(req.prompt_len, req.max_new_tokens))

    def restore_target_pages(self, req: "Request") -> int:
        """A restore must cover its resident tokens plus one segment —
        the same coverage invariant a fresh admission gets, so a restored
        request never needs growth before its first (protected) segment."""
        return self.pcfg.pages_for(self.pcfg.coverage_tokens(
            req.swap.n_tokens, req.prompt_len, req.max_new_tokens))

    def growth_need(self, req: "Request") -> int:
        """Pages to add so the next segment's writes are backed
        (PagedCacheConfig.coverage_tokens from the current seq_len),
        rounded up to the growth granule, capped at the lifetime pages.
        0 when the current allocation already covers the segment — which
        also means a stalled request (inactive, seq_len frozen) is always
        safe: its parked write slot sits inside pages it already owns."""
        sl = req.prompt_len + len(req.tokens) - 1
        target = self.pcfg.coverage_tokens(sl, req.prompt_len,
                                           req.max_new_tokens)
        need = self.pcfg.pages_for(target) - len(req.pages)
        if need <= 0:
            return 0
        g = self.pcfg.growth_granule
        need = -(-need // g) * g
        return min(need, self.lifetime_pages(req) - len(req.pages))

    # -------------------------------------------------------- page moves
    def alloc_charged(self, req: "Request", n: int
                      ) -> tuple[list[int] | None, str | None]:
        """``n`` fresh pages charged to ``req``'s tenant, or
        ``(None, reason)`` with reason ``"quota"`` (tenant budget — only
        same-tenant victims can help) or ``"pool"`` (allocator dry —
        global pressure)."""
        if n == 0:
            return [], None
        st = self.state(req.tenant)
        if self.headroom(req.tenant) < n:
            return None, "quota"
        pages = self.allocator.alloc(n)
        if pages is None:
            return None, "pool"
        st.charged += n
        req.charged += n
        return pages, None

    def grow(self, req: "Request", n: int
             ) -> tuple[list[int] | None, str | None]:
        pages, reason = self.alloc_charged(req, n)
        if pages:
            req.pages.extend(pages)
            self._c_grown.inc(len(pages), (self._rep, req.tenant))
        return pages, reason

    def share(self, req: "Request", pages: list[int]) -> None:
        """Map already-resident pages into ``req`` (refcount bump, no
        charge — the marginal cost of a shared page is zero)."""
        if pages:
            self.allocator.share(pages)

    def release_pressure(self, n: int) -> int:
        """Pool-pressure callback: evict prefix-retention pins before any
        request is made to pay for them."""
        if self.prefix_cache is None or n <= 0:
            return 0
        return self.prefix_cache.release_pins(n)

    def release_request(self, req: "Request") -> None:
        """The single exit path for a request's pages: drop the CoW pin
        if the engine never ran its boundary, release one reference per
        block-table page, refund the tenant charge.  Everything else
        (free-list return, trie invalidation) follows from the
        allocator's refcounts."""
        if req.cow_src is not None:
            self.allocator.release([req.cow_src])
            req.cow_src = None
        if req.pages:
            self.allocator.release(req.pages)
        st = self.state(req.tenant)
        st.charged -= req.charged
        req.charged = 0
        req.pages = None

    # -------------------------------------------------------- preemption
    def pick_victim(self, running: Iterable["Request"],
                    exclude: "Request", tenant: str | None = None
                    ) -> "Request | None":
        """Preemption victim among ``running``: never the grower, never a
        ``protected`` (just-restored/admitted, pre-first-segment) request.
        Quota pressure (``tenant`` set) stays inside that tenant; pool
        pressure picks from the most-over-share tenant — highest
        ``charged / weight`` — so the burst pays for the burst.  Within a
        tenant the newest admission goes first (LIFO), preserving the
        FIFO completion order the queues promise."""
        cands = [r for r in running
                 if r is not exclude and not r.protected
                 and (tenant is None or r.tenant == tenant)]
        if not cands:
            return None
        if tenant is None:
            def key(r: "Request"):
                st = self.state(r.tenant)
                return (st.charged / st.cfg.weight, r.admit_seq)
        else:
            def key(r: "Request"):
                return (0, r.admit_seq)
        return max(cands, key=key)

    def preempt(self, req: "Request", requeue: bool = True) -> SwapState:
        """Snapshot ``req``'s device-resident state and release its
        pages.  The page *data* is untouched until some later dispatch
        reuses the pages — the engine must ``device_get`` the snapshot
        before issuing one (serving/engine.py sequences this).

        ``requeue=False`` leaves the request out of the tenant queues:
        the recovery layer uses this to quarantine a faulted request (it
        re-enters via :meth:`requeue` once its backoff expires)."""
        sl = req.prompt_len + len(req.tokens) - 1
        swap = SwapState(pages=list(req.pages[:self.pcfg.pages_for(sl)]),
                         n_tokens=sl, slot=req.slot)
        req.swap = swap
        st = self.state(req.tenant)
        self._c_preempt.inc(1.0, (self._rep, req.tenant))
        self._c_swap_out.inc(len(swap.pages), (self._rep, req.tenant))
        self.release_request(req)
        if requeue:
            st.preempted.append(req)
        return swap

    def requeue(self, req: "Request") -> None:
        """Return a quarantined request to its tenant's queues: with a
        (verified) host image through the preempted lane — a
        one-dispatch restore — and without one through the pending lane
        as a full restart."""
        st = self.state(req.tenant)
        if req.swap is not None:
            st.preempted.append(req)
        else:
            st.pending.append(req)

    # --------------------------------------------------------- admission
    def plan_admission(self, req: "Request") -> AdmissionPlan | str:
        """Decide an admission without moving state: the fresh-page cost
        (the DRR currency), the trie prefix re-map, and — for restores —
        which host blocks the engine must scatter back.  Returns a reason
        string (``"quota"``/``"pool"``) when resources block it."""
        restore = req.swap is not None
        if restore:
            need = self.restore_target_pages(req)
        else:
            need = self.admission_pages(req)
        match = None
        n_shared = 0
        if self.prefix_cache is not None:
            match = self.prefix_cache.lookup(req.prompt)
            n_shared = len(match.pages)
        if restore:
            # full-chunk prefix pages only: they are immutable and cover
            # tokens this request has definitely written (prompt ⊆
            # resident); the host image covers everything else, so a tail
            # CoW fork would copy data we already hold exactly.  Truncate
            # the match so the hit counters reflect what the restore
            # actually consumed.
            if match is not None:
                match = PrefixMatch(pages=match.pages,
                                    n_tokens=n_shared
                                    * self.pcfg.page_size)
            fresh = need - n_shared
            blocks = (n_shared, self.pcfg.pages_for(req.swap.n_tokens))
            plan = AdmissionPlan(req, cost=fresh, n_shared=n_shared,
                                 match=match, restore_blocks=blocks)
        else:
            fresh = need - n_shared
            plan = AdmissionPlan(req, cost=fresh, n_shared=n_shared,
                                 match=match)
        if fresh > self.headroom(req.tenant):
            return "quota"
        evictable = (self.prefix_cache.pinned_pages
                     if self.prefix_cache else 0)
        if fresh > self.allocator.n_free + evictable:
            # optimistic: pins count as free here, but are only evicted
            # at commit time — a plan the DRR deficit then rejects must
            # not strip retention as a planning side effect
            return "pool"
        return plan

    def commit_admission(self, plan: AdmissionPlan) -> bool:
        """Execute a planned admission: map shared pages, evict retention
        pins if the free list is short, allocate + bill fresh pages, arm
        the CoW fork, (re)index the trie.  Returns False — with no state
        changed beyond pin eviction — when the planner's optimistic pin
        accounting does not pan out (an evicted pin that other requests
        still reference frees nothing)."""
        req, match = plan.req, plan.match
        restore = req.swap is not None
        shared = list(match.pages[:plan.n_shared]) if match else []
        if shared:
            # share BEFORE evicting pins: a matched page may be alive
            # only through a retention pin, and the bumped refcount is
            # what keeps the eviction from freeing it mid-admission
            self.allocator.share(shared)
        short = plan.cost - self.allocator.n_free
        if short > 0:
            self.release_pressure(short)
        fresh, _reason = self.alloc_charged(req, plan.cost)
        if fresh is None:
            if shared:
                self.allocator.release(shared)
            return False
        req.pages = shared + fresh
        if restore:
            req.shared_tokens = 0        # restores never re-prefill
            req.shared_pages = 0
            self._c_restores.inc(1.0, (self._rep, req.tenant))
            self._c_swap_in.inc(
                max(0, plan.restore_blocks[1] - plan.restore_blocks[0]),
                (self._rep, req.tenant))
        else:
            req.shared_pages = plan.n_shared
            req.shared_tokens = match.n_tokens if match else 0
            if match and match.tail_src is not None:
                # pin the CoW source until the engine's boundary dispatch
                # has forked it (the owner could complete first).  The
                # fork target holds the LAST matched token — see
                # scheduler history for the exactly-full-tail case.
                self.allocator.share([match.tail_src])
                req.cow_src = match.tail_src
                req.cow_dst = req.pages[(match.n_tokens - 1)
                                        // self.pcfg.page_size]
            self._c_admitted.inc(1.0, (self._rep, req.tenant))
        if self.prefix_cache is not None:
            self.prefix_cache.record(match)
            self.prefix_cache.insert(req.prompt, req.prompt_len, req.pages)
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        req.protected = True             # anti-livelock: one segment grace
        return True

    # ---------------------------------------------------------------- DRR
    @property
    def quantum(self) -> float:
        """Pages of deficit credit per round for a weight-1 tenant."""
        return float(self.pcfg.growth_granule)

    def rotation(self) -> list[_TenantState]:
        """Tenant visit order for one boundary; the origin rotates so no
        tenant is permanently first when pages run out mid-round."""
        names = sorted(self._tenants)
        if not names:
            return []
        k = self._rr % len(names)
        self._rr += 1
        return [self._tenants[n] for n in names[k:] + names[:k]]

    def max_rounds(self) -> int:
        """Deficit accrual bound: the costliest admission is the whole
        pool, the slowest accrual is min-weight x quantum per round."""
        weights = [st.cfg.weight for st in self._tenants.values()
                   if st.has_queued]
        if not weights:
            return 1
        per_round = min(weights) * self.quantum
        return int(math.ceil(self.pcfg.allocatable_pages
                             / max(per_round, 1e-9))) + 2

    # -------------------------------------------------------------- stats
    def stats(self) -> dict[str, Any]:
        pc = self.prefix_cache
        return {
            "free_pages": self.allocator.n_free,
            "held_pages": self.allocator.n_held,
            "pages_allocated_total": self.allocator.pages_allocated_total,
            "pages_shared_total": self.allocator.pages_shared_total,
            "pages_grown": self.pages_grown,
            "preemptions": self.preemptions,
            "restores": self.restores,
            "pages_swapped_out": self.pages_swapped_out,
            "pages_swapped_in": self.pages_swapped_in,
            "free_low_water": self.allocator.free_low_water,
            "alloc_failures": self.allocator.alloc_failures,
            "dead_letters": self.dead_letters,
            "pinned_pages": pc.pinned_pages if pc else 0,
            "pin_evictions": pc.pin_evictions if pc else 0,
            "prefix_lookups": pc.lookups if pc else 0,
            "prefix_hits": pc.hits if pc else 0,
            "prefix_tokens_matched": pc.tokens_matched if pc else 0,
            "tenants": {
                name: {
                    "admitted": st.admitted,
                    "preempted": st.preempted_n,
                    "restored": st.restored,
                    "pages_swapped": st.pages_swapped,
                    "dead_lettered": st.dead_lettered,
                    "pages_charged": st.charged,
                    "page_budget": self.budget(name),
                    "queued": len(st.pending) + len(st.preempted),
                } for name, st in sorted(self._tenants.items())
            },
        }
