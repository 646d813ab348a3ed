"""Paged KV-cache: fixed-size page pool + free-list allocator + block tables.

The contiguous decode cache (models/layers.py::init_attention_cache) ties
one request to one ``(cache_len, KV, hd)`` strip for its whole lifetime —
memory is reserved for the *longest possible* generation of the *whole
batch*, and a finished request's strip is dead weight until the entire
batch drains.  Paging decouples the two: KV state lives in a shared pool
of ``page_size``-token pages, each request owns an ordered list of pages
(its *block table* row), and completion returns pages to a free list the
next admission reuses immediately.  That is the memory architecture the
continuous-batching scheduler (serving/scheduler.py) allocates against.

Layout per layer: ``k_pages``/``v_pages``: (n_pages, page_size, KV, hd),
stacked over layers by :func:`init_paged_cache` into one tensor per K and
V; lm_apply hands each layer its view.  Physical
page 0 is reserved as the *scratch page* (:data:`TRASH_PAGE`): empty or
drained batch slots keep running inside a decode segment, and
their (masked, discarded) writes land there instead of corrupting pages
the allocator may already have handed to another request.

The page size is an optimization knob like any tile size: small pages
waste less pool memory on partial tails (internal fragmentation ~
``page_size/2`` tokens per request) but mean more page steps for the
paged decode kernel; big pages invert the trade.  It is tuned per shape
through kernels/autotune.py (``flash_decode_paged``) and read back via
:func:`preferred_page_size` at pool-construction time — the layout is
fixed once allocated.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import resolve_device

TRASH_PAGE = 0


class AllocatorError(ValueError):
    """Allocator misuse: double free, sharing a free page, negative
    alloc.  A real exception rather than an ``assert`` so the checks
    survive ``python -O``, and a dedicated type so the recovery layer
    (serving/recovery.py) can quarantine the offending request instead
    of crashing the engine.  Subclasses ValueError for back-compat with
    callers that caught the old untyped raises."""


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Pool geometry + scheduler cadence for one serving engine."""
    page_size: int = 16
    n_pages: int = 64        # physical pages per layer, incl. the scratch page
    max_slots: int = 8       # in-flight batch width R
    max_blocks: int = 8      # block-table width M (logical pages per request)
    segment_len: int = 8     # decode steps between scheduler syncs
    # Prefix sharing: admissions map already-resident pages holding an
    # identical page-aligned prompt prefix instead of recomputing and
    # re-storing them (refcounted; decode writes into a shared tail page
    # fork a private copy first).  The match granule is
    # ``prefix_chunk_pages * page_size`` tokens.
    enable_prefix_sharing: bool = True
    prefix_chunk_pages: int = 1   # trie-edge granularity, in pages
    # Batched admission prefill pads each admission's suffix to a multiple
    # of this bucket so one boundary's admissions share a single ragged
    # dispatch with a bounded number of compiled shapes.
    prefill_bucket: int = 8
    # Growth-on-demand granule, in pages: at each segment boundary the
    # resource manager (serving/resources.py) tops a running request up to
    # the next segment's coverage in multiples of this, trading allocator
    # churn against packing slack.  0 = auto: the pages one decode segment
    # consumes.
    growth_pages: int = 0
    # Prefix-cache retention: an LRU budget of pages the PrefixCache
    # itself holds references on, so a hot prefix (a system prompt)
    # survives the idle gap after its last request completes.  Pinned
    # pages are evicted instantly under allocator pressure (the resource
    # manager's pressure callback) before any request is preempted.
    retain_pages: int = 0

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache slots."""
        return -(-int(n_tokens) // self.page_size)

    @property
    def growth_granule(self) -> int:
        """Pages added per growth step (auto: one segment's worth)."""
        return self.growth_pages or max(1, self.pages_for(self.segment_len))

    def lifetime_tokens(self, prompt_len: int, max_new_tokens: int) -> int:
        """Cache slots a request occupies when fully generated (+1: the
        final decode step still writes its token's K/V)."""
        return prompt_len + max_new_tokens + 1

    def coverage_tokens(self, seq_len: int, prompt_len: int,
                        max_new_tokens: int) -> int:
        """Cache slots that must be page-backed before the next decode
        segment, given ``seq_len`` resident tokens: one segment of
        writes plus the parked write slot an inactive row keeps using,
        capped at the whole lifetime.  This single formula IS the
        stall-safety invariant — admission, growth, and restore all size
        against it, so a slot denied growth can sit a segment out with
        its frozen write slot still inside pages it owns."""
        return min(seq_len + self.segment_len + 1,
                   self.lifetime_tokens(prompt_len, max_new_tokens))

    def admission_tokens(self, prompt_len: int, max_new_tokens: int) -> int:
        """Coverage a fresh admission needs: the prompt is the resident
        position.  Everything past this is allocated on demand at later
        segment boundaries."""
        return self.coverage_tokens(prompt_len, prompt_len,
                                    max_new_tokens)

    @property
    def prefix_match_tokens(self) -> int:
        """Tokens per prefix-trie edge (the sharing granule)."""
        return self.prefix_chunk_pages * self.page_size

    def to_dict(self) -> dict[str, Any]:
        """JSON-safe dict (checkpoint ``extra`` payloads)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PagedCacheConfig":
        """Inverse of :meth:`to_dict`.  Unknown keys are dropped and
        missing ones take their defaults, so configs persisted before a
        knob existed (or after one is retired) stay loadable."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def capacity_tokens(self) -> int:
        """Max cache tokens a single request can hold (block-table width)."""
        return self.max_blocks * self.page_size

    @property
    def allocatable_pages(self) -> int:
        return self.n_pages - 1  # page 0 is the scratch page

    def validate_request(self, prompt_len: int, max_new_tokens: int) -> int:
        """Pages a request needs for its whole lifetime; raises if it can
        never fit.  +1 slot: the last decode step still writes its token's
        K/V before the engine retires the request."""
        need_tokens = prompt_len + max_new_tokens + 1
        if need_tokens > self.capacity_tokens:
            raise ValueError(
                f"request needs {need_tokens} cache slots > capacity "
                f"{self.capacity_tokens} (max_blocks={self.max_blocks} x "
                f"page_size={self.page_size})")
        need = self.pages_for(need_tokens)
        if need > self.allocatable_pages:
            raise ValueError(f"request needs {need} pages > pool "
                             f"{self.allocatable_pages}")
        return need


class PageAllocator:
    """Host-side refcounted free-list allocator over the physical page pool.

    Page ids are handed out lowest-first and returned pages are reused
    before fresh ones — the pool working set stays compact, and tests can
    assert literal page-id reuse after a request completes.

    Prefix sharing maps one physical page into several requests' block
    tables; each mapping holds a reference (:meth:`share`), and a page
    only returns to the free list when its last reference is released.
    Every alloc bumps the page's *generation* — the prefix trie records
    (page, generation) so an entry for a page that was freed and
    re-issued to unrelated content can never validate.
    """

    def __init__(self, n_pages: int, faults=None):
        if n_pages < 2:
            raise ValueError("need at least one allocatable page "
                             "beyond the reserved scratch page")
        # Optional FaultPlan (serving/faults.py): the "alloc" site makes
        # alloc() bounce as if the pool were dry — indistinguishable from
        # real pressure, so callers exercise their real fallback paths.
        self._faults = faults
        self._free = list(range(n_pages - 1, 0, -1))  # pop() -> ascending
        self._refs: dict[int, int] = {}               # page -> refcount
        self._gen = [0] * n_pages                     # bumped per alloc
        self.pages_allocated_total = 0                # fresh allocs (stats)
        self.pages_shared_total = 0                   # share() refs (stats)
        # pressure telemetry: the tightest the pool ever got, and how many
        # alloc() calls bounced — what the resource manager's preemption
        # policy and the bench rows read back
        self.free_low_water = n_pages - 1
        self.alloc_failures = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_held(self) -> int:
        """Distinct physical pages currently referenced."""
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def generation(self, page: int) -> int:
        return self._gen[page]

    def is_shared(self, page: int) -> bool:
        return self._refs.get(page, 0) > 1

    def alloc(self, n: int) -> list[int] | None:
        """``n`` fresh pages at refcount 1, or None (all-or-nothing)."""
        if n < 0:
            raise AllocatorError(f"alloc({n})")
        if n > 0 and self._faults is not None \
                and self._faults.should_fire("alloc"):
            self.alloc_failures += 1
            return None
        if n > len(self._free):
            self.alloc_failures += 1
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
            self._gen[p] += 1
        self.pages_allocated_total += n
        self.free_low_water = min(self.free_low_water, len(self._free))
        return pages

    def share(self, pages: list[int]) -> None:
        """Add one reference per page (mapping live pages into another
        request's block table).  Sharing a free page is a bug."""
        for p in pages:
            if self._refs.get(p, 0) < 1:
                raise AllocatorError(f"cannot share free/foreign page {p}")
        for p in pages:
            self._refs[p] += 1
        self.pages_shared_total += len(pages)

    def release(self, pages: list[int]) -> list[int]:
        """Drop one reference per page; pages hitting refcount 0 return
        to the free list (returned for tests/telemetry)."""
        freed: list[int] = []
        for p in pages:
            if self._refs.get(p, 0) < 1:
                raise AllocatorError(f"double free or foreign page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                freed.append(p)
        # freed pages go to the top of the stack: first to be reused
        self._free.extend(sorted(freed, reverse=True))
        return freed


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of a prefix-cache lookup against one prompt."""
    pages: tuple[int, ...] = ()     # full-chunk physical pages, in order
    n_tokens: int = 0               # tokens covered (full chunks + tail)
    tail_src: int | None = None     # page to copy-on-write the tail from
    tail_tokens: int = 0            # tokens matched inside the tail page


class _TrieNode:
    __slots__ = ("children", "tails")

    def __init__(self):
        # token-chunk -> (pages, gens, ready, child)
        self.children: dict[tuple, list] = {}
        # partial-page tail tokens -> [page, gen, ready]
        self.tails: dict[tuple, list] = {}


class PrefixCache:
    """Prefix trie over token-id page chunks -> resident physical pages.

    Each edge covers ``chunk_pages`` full pages of prompt tokens starting
    at a fixed absolute position (trie depth x chunk tokens), so a match
    guarantees the stored pages hold K/V for *these tokens at these
    positions* — sharing is a pure block-table aliasing, no recompute.

    Entries carry the allocator generation captured at insert; lookups
    re-validate ``refcount > 0 and generation unchanged`` and prune stale
    entries lazily, so completion never has to notify the trie.

    Tail entries index a request's final *partially filled* prompt page.
    That page is mutable (its owner decodes into it), so a tail match is
    satisfied by copy-on-write: the matching prompt slots are copied into
    a page the new request owns before its first write.  Tail entries
    only become matchable once :meth:`mark_ready` confirms their K/V has
    materialized on device — a same-boundary admission must not CoW-copy
    a page whose prefill is still in flight.  Full-chunk entries are
    matchable immediately: same-boundary sharers read them *after* the
    batched prefill's in-graph scatter, inside the same dispatch.
    """

    def __init__(self, allocator: PageAllocator, page_size: int,
                 chunk_pages: int = 1, retain_pages: int = 0):
        self.allocator = allocator
        self.page_size = int(page_size)
        self.chunk_pages = int(chunk_pages)
        self.chunk_tokens = self.page_size * self.chunk_pages
        self.root = _TrieNode()
        self._pending: list[list] = []   # entries awaiting mark_ready
        self.lookups = 0
        self.hits = 0                    # lookups matching >= 1 token
        self.tokens_matched = 0
        # Retention pins: an LRU of <= retain_pages full-chunk pages the
        # cache itself holds one reference on, so a hot prefix outlives
        # its last request.  A pinned page can never be freed, so its
        # generation never moves and its trie entries stay valid — the
        # pin IS the retention.  Only immutable full-chunk pages are
        # pinned (a tail page's owner decodes into it).
        self.retain_pages = int(retain_pages)
        self._pins: OrderedDict[int, None] = OrderedDict()
        self.pin_evictions = 0

    def _entry_valid(self, pages, gens) -> bool:
        alloc = self.allocator
        return all(alloc.refcount(p) > 0 and alloc.generation(p) == g
                   for p, g in zip(pages, gens))

    def lookup(self, tokens: np.ndarray) -> PrefixMatch:
        """Longest resident prefix of ``tokens``, full chunks first, then
        one partial-tail page.  At least one trailing token is always
        left unmatched — the admission prefill must still produce the
        request's first-token logits.

        Pure read apart from lazy pruning: the hit/token counters only
        move when :meth:`record` confirms the match was consumed by an
        admission (a blocked head-of-line request is looked up again at
        every boundary and must not inflate the stats)."""
        toks = [int(t) for t in tokens]
        cap = len(toks) - 1              # always >= 1 suffix token
        node = self.root
        pages: list[int] = []
        pos = 0
        ct = self.chunk_tokens
        while pos + ct <= cap:
            key = tuple(toks[pos:pos + ct])
            entry = node.children.get(key)
            if entry is None:
                break
            e_pages, e_gens, _ready, child = entry
            if not self._entry_valid(e_pages, e_gens):
                del node.children[key]   # lazy prune of stale entries
                break
            pages.extend(e_pages)
            pos += ct
            node = child
        tail_src, tail_tokens = None, 0
        budget = cap - pos
        if 0 < budget:
            for key, entry in list(node.tails.items()):
                page, gen, ready = entry
                if not self._entry_valid((page,), (gen,)):
                    del node.tails[key]
                    continue
                if not ready:
                    continue
                m = 0
                for a, b in zip(key, toks[pos:pos + budget]):
                    if a != b:
                        break
                    m += 1
                if m > tail_tokens:
                    tail_src, tail_tokens = page, m
        return PrefixMatch(pages=tuple(pages), n_tokens=pos + tail_tokens,
                           tail_src=tail_src, tail_tokens=tail_tokens)

    def record(self, match: PrefixMatch) -> None:
        """Count a lookup whose result an admission actually consumed."""
        self.lookups += 1
        if match.n_tokens:
            self.hits += 1
            self.tokens_matched += match.n_tokens
            self._touch_pins(match.pages)    # a consumed hit is "hot"

    # ------------------------------------------------------ retention pins
    def _touch_pins(self, pages) -> None:
        """LRU-touch ``pages``; pin live unpinned ones under the budget,
        evicting the coldest pins to make room.  ``pages`` arrive in
        prefix order and are touched in *reverse*: trie matching is
        sequential from the root, so a deep page is worthless without the
        shallow ones before it — touching shallow pages last keeps them
        hottest, and eviction truncates the retained prefix from its
        tail instead of beheading it."""
        if not self.retain_pages:
            return
        for p in reversed(list(pages)):
            if p in self._pins:
                self._pins.move_to_end(p)
            elif self.allocator.refcount(p) > 0:
                while len(self._pins) >= self.retain_pages:
                    self._evict_pin()
                self.allocator.share([p])
                self._pins[p] = None

    def _evict_pin(self) -> int:
        """Drop the LRU pin; returns how many pages actually freed (0 when
        other requests still reference the page)."""
        page, _ = self._pins.popitem(last=False)
        self.pin_evictions += 1
        return len(self.allocator.release([page]))

    def release_pins(self, n_pages: int) -> int:
        """Allocator-pressure callback: evict LRU pins until ``n_pages``
        pages returned to the free list (or no pins remain).  Retention is
        strictly weaker than any request's demand — the resource manager
        calls this before considering preemption."""
        freed = 0
        while self._pins and freed < n_pages:
            freed += self._evict_pin()
        return freed

    @property
    def pinned_pages(self) -> int:
        return len(self._pins)

    def insert(self, tokens: np.ndarray, prompt_len: int,
               pages: list[int]) -> None:
        """Register an admitted request's prompt pages.

        Full chunks whose last token lies within the prompt are immutable
        (decode writes start at ``prompt_len``, which lives in a later
        page) and are indexed directly; a trailing partial page becomes a
        tail entry.  Both are queued not-ready until :meth:`mark_ready`.
        """
        toks = [int(t) for t in tokens[:prompt_len]]
        alloc = self.allocator
        node = self.root
        ct = self.chunk_tokens
        pos = 0
        while pos + ct <= prompt_len:
            key = tuple(toks[pos:pos + ct])
            blk = pos // self.page_size
            e_pages = tuple(pages[blk:blk + self.chunk_pages])
            entry = node.children.get(key)
            if entry is not None and self._entry_valid(entry[0], entry[1]):
                node = entry[3]          # already indexed (shared hit)
            else:
                gens = tuple(alloc.generation(p) for p in e_pages)
                child = _TrieNode()
                new = [e_pages, gens, False, child]
                node.children[key] = new
                self._pending.append(new)
                node = child
            pos += ct
        # tail entries index exactly one page past the full chunks; with
        # a multi-page chunk granule, a sub-chunk run spanning several
        # pages is the (accepted) coarseness cost and is not indexed
        if pos < prompt_len and prompt_len - pos <= self.page_size:
            key = tuple(toks[pos:])
            entry = node.tails.get(key)
            if entry is None or not self._entry_valid((entry[0],),
                                                      (entry[1],)):
                page = pages[pos // self.page_size]
                new = [page, alloc.generation(page), False]
                node.tails[key] = new
                self._pending.append(new)

    def mark_ready(self) -> None:
        """Confirm queued entries: their K/V has been dispatched to the
        device (the admission-boundary prefill ran)."""
        pinnable: list[int] = []
        for entry in self._pending:
            entry[2] = True              # ready slot of both entry kinds
            if len(entry) == 4:          # full-chunk entry: pinnable
                pinnable.extend(entry[0])
        # one prefix-ordered touch across the whole boundary, so the
        # reverse-touch policy sees the chunks in trie order
        self._touch_pins(pinnable)
        self._pending.clear()


def supports_paging(cfg: ArchConfig) -> bool:
    """Paged decode covers the dense-attention families with linear
    caches.  Sliding-window ring buffers recycle slots *within* a request
    (a different page-reuse problem — ROADMAP open item), MLA caches
    compressed latents, and SSM/hybrid families carry recurrent state.

    getattr-defensive: callers may pass duck-typed configs that carry
    only the attention fields.
    """
    return (getattr(cfg, "family", None) in ("dense", "moe", "vlm")
            and not getattr(cfg, "use_mla", False)
            and not getattr(cfg, "sliding_window", 0)
            and not getattr(cfg, "enc_dec", False))


def init_paged_cache(cfg: ArchConfig, pcfg: PagedCacheConfig,
                     dtype=torch.bfloat16, device=None) -> dict:
    """Whole-model paged cache, on CUDA unless ``device`` says otherwise.

    ``blocks`` holds one stacked ``(L, P, page_size, KV, hd)`` pool per K
    and V; lm_apply hands layer ``l`` the view ``pool[l]``, so the
    layers' in-place page writes land in the stack.
    ``block_tables``/``seq_lens`` are batch state shared by every layer.
    """
    if not supports_paging(cfg):
        raise ValueError(f"{cfg.name}: family={cfg.family} "
                         f"window={cfg.sliding_window} mla={cfg.use_mla} "
                         f"does not support the paged decode path")
    dev = resolve_device(device)
    shape = (cfg.n_layers, pcfg.n_pages, pcfg.page_size,
             cfg.n_kv_heads, cfg.hd)
    return {
        "blocks": {"k_pages": torch.zeros(shape, dtype=dtype, device=dev),
                   "v_pages": torch.zeros(shape, dtype=dtype, device=dev)},
        "block_tables": torch.full((pcfg.max_slots, pcfg.max_blocks),
                                   TRASH_PAGE, dtype=torch.int32,
                                   device=dev),
        "seq_lens": torch.zeros((pcfg.max_slots,), dtype=torch.int32,
                                device=dev),
    }


def preferred_page_size(cfg: ArchConfig, pcfg_slots: int, max_len: int, *,
                        device=None) -> int:
    """Tuned page size for this arch's decode shape, from the autotuner's
    persisted cache for ``device``'s backend (pure read — tuning happens
    in the TUNE task or the ``tuned_*`` wrappers, never at
    pool-construction time).  Falls back to the kernel default on a miss.

    Thin wrapper over the consolidated readback
    (:func:`repro_torch.kernels.autotune.tile_readback` — the relax keys
    live in ``autotune.TILE_RELAX``); the provenance-tracked form is
    ``ServingPlan.resolve`` (serving/plan.py)."""
    from repro_torch.kernels import autotune
    prob = autotune.flash_decode_paged_problem(
        pcfg_slots, cfg.n_heads, cfg.n_kv_heads, cfg.hd, max_len, cfg.adt)
    tile, _ = autotune.tile_readback("flash_decode_paged", prob,
                                     device=device)
    return int(tile["page_size"])


def preferred_segment_len(cfg: ArchConfig, pcfg_slots: int, max_len: int,
                          *, device=None) -> int:
    """Tuned decode-segment length (scheduler cadence) for this arch's
    serving shape — same pure-read contract as
    :func:`preferred_page_size`.  The problem is keyed against the tuned
    page size, so TUNE picks the cadence for the pool layout it itself
    selected; with it comes the resource manager's default growth granule
    (``PagedCacheConfig.growth_granule`` = pages per segment)."""
    from repro_torch.kernels import autotune
    ps = preferred_page_size(cfg, pcfg_slots, max_len, device=device)
    prob = autotune.paged_segment_problem(
        pcfg_slots, cfg.n_heads, cfg.n_kv_heads, cfg.hd, max_len, ps,
        cfg.adt)
    tile, _ = autotune.tile_readback("paged_segment", prob, device=device)
    return int(tile["segment_len"])
