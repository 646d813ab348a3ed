"""Continuous-batching serving engine over the paged KV cache.

One engine owns: a paged cache pool (serving/paged_cache.py), a scheduler
(serving/scheduler.py), and its entry points, which run eagerly and update
the page pools in place (the JAX package jits them and donates the pools):

- ``admit_batch``: *all* requests admitted at a segment boundary prefill
  in one dispatch per suffix bucket.  Copy-on-write tail pages are forked
  first, then every admission's *suffix* tokens (the prompt after its
  shared prefix) run through the model with the paged cache attached:
  per-layer suffix K/V is written into the request's own pages and ragged
  causal attention covers shared prefix + suffix
  (models/layers.py::_paged_attention_prefill /
  kernels/flash_prefill_ragged.py).  Each request's first greedy token is
  picked from its own last valid suffix position on the device.
  Admissions that share a prefix compute it once — or zero times, when
  the prefix cache already holds it from an earlier admission.
- ``segment``: ``segment_len`` decode steps over the whole slot batch as
  one device loop, with greedy sampling, per-slot active masks, the
  non-finite-logit latch and seq_lens advancement kept on the device; the
  host reads the results back once per segment.

- ``prefill_mode="serial"``: each admission prefills alone (batch 1)
  into a contiguous scratch cache rounded up to whole pages, whose K/V
  is then scattered into the request's pages (``_admit_serial``).  No
  prefix sharing on this path (``ServingPlan.sharing``).

The write-ahead journal (``plan.durability``) is not ported yet.

The host loop runs at segment boundaries only, in a fixed order the
resource manager's correctness depends on:

1. retire finished requests (refcounts drop, rows park on the scratch
   page) — this happened at the previous boundary's tail;
2. **grow**: top every running request up to the next segment's page
   coverage (serving/scheduler.py::plan_growth), preempting victims when
   the pool runs dry;
3. **swap out**: copy every victim's snapshotted pages to host *before
   any dispatch* — the pages are back on the free list and the very next
   admission may write them;
4. admit: preempted requests **restore first** — trie-rematched prefix
   pages are pure block-table aliasing, the remaining blocks come back
   in one scatter from the host image — then fresh requests prefill.
   Restores must dispatch before fresh prefills: a fresh admission may
   prefix-share a restore-range page, and its attention needs the host
   image resident;
5. dispatch the next segment, then clear anti-livelock protection on
   every slot that generated through it.

KV state never moves on admission, growth, or completion — only
block-table rows and page refcounts change; it moves exactly twice per
preemption cycle (out to host, back in one scatter).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.serving.faults import (FaultPlan, InjectedFault,
                                        corrupt_image, image_checksum)
from repro_torch.serving.observe import Observability, render_summary
from repro_torch.serving.paged_cache import (AllocatorError,
                                             PagedCacheConfig, TRASH_PAGE,
                                             init_paged_cache,
                                             supports_paging)
from repro_torch.serving.plan import ServingPlan
from repro_torch.serving.recovery import (EngineStalledError,
                                          RecoveryManager, RecoveryPolicy,
                                          diagnostic_snapshot)
from repro_torch.serving.resources import DEFAULT_TENANT
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Request


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the plan's JSON-safe name)."""
    return str(dtype).removeprefix("torch.")


def greedy_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Index of the first maximal entry along the last axis, a NaN
    counting as maximal — ``jnp.argmax``'s rule.  Ties are common enough
    in bf16 logits over a large vocabulary that the rule decides tokens."""
    n = logits.shape[-1]
    nan = torch.isnan(logits)
    hit = torch.where(nan.any(dim=-1, keepdim=True), nan,
                      logits == logits.amax(dim=-1, keepdim=True))
    idx = torch.arange(n, device=logits.device)
    return torch.where(hit, idx, n).amin(dim=-1)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Device pages -> numpy host image.  numpy has no bfloat16, so bf16
    pages travel as their 16-bit patterns: the image's bytes (and its
    checksum) equal the JAX package's bf16 image of the same values."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == torch.bfloat16:
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device=device, dtype=dtype)


class PagedServingEngine:
    def __init__(self, model, pcfg: PagedCacheConfig,
                 cache_dtype=torch.bfloat16, prefill_mode: str = "batched",
                 tenants=None, faults: FaultPlan | None = None,
                 recovery: RecoveryPolicy | None = None):
        # the kwargs fold into a ServingPlan, the single source of truth
        # every engine carries (``self.plan``)
        plan = ServingPlan(arch=str(getattr(model.cfg, "name", "")),
                           cache=pcfg, prefill_mode=prefill_mode,
                           cache_dtype=dtype_name(cache_dtype),
                           tenants=tuple(tenants or ()))
        self._init_from_plan(model, plan, faults, recovery)

    @classmethod
    def from_plan(cls, model, plan: ServingPlan, *,
                  faults: FaultPlan | None = None,
                  recovery: RecoveryPolicy | None = None
                  ) -> "PagedServingEngine":
        """Construct from a declarative :class:`ServingPlan`: the engine's
        pool geometry, prefill mode, cache dtype, sharing flag, and tenant
        roster are exactly the plan's."""
        eng = cls.__new__(cls)
        eng._init_from_plan(model, plan, faults, recovery)
        return eng

    def _init_from_plan(self, model, plan: ServingPlan, faults, recovery):
        if not supports_paging(model.cfg):
            raise ValueError(f"{model.cfg.name} does not support the "
                             f"paged decode path")
        if plan.durability.enabled:
            raise NotImplementedError(
                "plan.durability (the write-ahead journal) is not ported "
                "yet: it waits for the journal/cluster/traffic slice")
        self.model = model
        self.device = model.device
        self.plan = plan
        self.pcfg = plan.cache
        self.cache_dtype = getattr(torch, plan.cache_dtype)
        self.prefill_mode = plan.prefill_mode
        self.tenants = list(plan.tenants) if plan.tenants else None
        # fault/recovery defaults for run(); run(faults=..., recovery=...)
        # overrides per call so one engine serves both the fault-free
        # baseline and its chaos replays
        self.faults = faults
        self.recovery = recovery
        self.sharing = plan.sharing

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------ device steps
    @torch.no_grad()
    def _write_pages(self, blocks, pk, pv, rows) -> None:
        """Scatter page chunks (L, n, ps, KV, hd) into physical ``rows``,
        in place."""
        blocks["k_pages"][:, rows] = pk
        blocks["v_pages"][:, rows] = pv

    @torch.no_grad()
    def _prefill(self, params, prompt):
        """prompt: (1, S).  Contiguous scratch cache rounded up to whole
        pages so the K/V reshapes to (L, n_pages, page_size, KV, hd).
        Returns the first greedy token (1, 1) and the page chunks."""
        s = prompt.shape[1]
        cache_len = self.pcfg.pages_for(s) * self.pcfg.page_size
        cache = self.model.init_cache(1, cache_len, self.cache_dtype)
        logits, cache = self.model.prefill(params, {"tokens": prompt},
                                           cache)
        tok = greedy_argmax(logits[:, -1:]).to(torch.int32)
        n_layers, _, _, kv, hd = cache["k"].shape
        shape = (n_layers, -1, self.pcfg.page_size, kv, hd)
        return tok, cache["k"].reshape(shape), cache["v"].reshape(shape)

    @torch.no_grad()
    def _admit_batch(self, params, blocks, tokens, bt, offsets, lens,
                     cow_src, cow_dst):
        """One dispatch for a group of admissions.

        tokens: (R, S) suffix tokens padded to the bucket; offsets/lens:
        (R,) shared-prefix offset and valid suffix length per row (0/0
        for pad rows); cow_src/cow_dst: (R,) physical pages to fork before
        the suffix write (TRASH_PAGE pairs for rows without a
        copy-on-write tail).  Returns each row's first greedy token
        (R, 1); the page pools in ``blocks`` are updated in place.
        """
        kp, vp = blocks["k_pages"], blocks["v_pages"]
        # copy-on-write first: a shared tail page's prompt slots must be
        # resident in the request's own copy before this dispatch's
        # suffix write appends to that copy.  No-CoW rows copy
        # scratch->scratch, which the trash page absorbs.
        kp[:, cow_dst] = kp[:, cow_src]
        vp[:, cow_dst] = vp[:, cow_src]
        cache = {"blocks": blocks, "block_tables": bt, "seq_lens": offsets,
                 "prefill_lens": lens}
        logits, _ = self.model.decode_step(params, cache, tokens)
        last = torch.clamp(lens - 1, min=0).long()
        sel = logits[torch.arange(logits.shape[0], device=logits.device),
                     last]                                   # (R, V)
        return greedy_argmax(sel).to(torch.int32)[:, None]

    @torch.no_grad()
    def _segment(self, params, cache, tok, active, n_gen, max_new, poison):
        """``segment_len`` decode steps as one device loop, with no host
        synchronisation inside it.

        Inactive slots still run (the batch is dense) but their tokens are
        masked, their seq_lens hold, and their writes land on pages they
        still own or on the scratch page — never on a reclaimed page.

        ``poison`` is the decode_poison fault payload: a (R,) float added
        to the first step's logits (all-zero in normal operation, NaN on
        one slot in a chaos run — adding 0.0 leaves every logit's value
        and so every token unchanged).  Whatever the source, a non-finite
        last-position logit row latches that slot's ``poisoned`` flag on
        the device: the slot stops emitting and advancing for the rest of
        the segment and the host quarantines it at the boundary.

        Returns (cache, tok, active, n_gen, toks (T, R), emits (T, R),
        poisoned), all on the device.
        """
        poisoned = torch.zeros_like(active)
        toks, emits = [], []
        for _ in range(self.pcfg.segment_len):
            logits, cache = self.model.decode_step(params, cache, tok)
            logits = logits + poison.to(logits.dtype)[:, None, None]
            bad = ~torch.isfinite(logits[:, -1]).all(dim=-1)
            poisoned = poisoned | bad
            ok = active & ~poisoned
            nxt = greedy_argmax(logits[:, -1:]).to(torch.int32)   # (R, 1)
            nxt = torch.where(ok[:, None], nxt, 0)
            live = ok.to(torch.int32)
            n_gen = n_gen + live
            cache = dict(cache, seq_lens=cache["seq_lens"] + live)
            active = active & ~poisoned & (n_gen < max_new)
            poison = torch.zeros_like(poison)   # first step only
            tok = nxt
            toks.append(nxt[:, 0])
            emits.append(ok)
        return (cache, tok, active, n_gen, torch.stack(toks),
                torch.stack(emits), poisoned)

    # --------------------------------------------------------- host loop
    def _admit_serial(self, cache, bt, req, params):
        """Serial admission: batch-1 prefill + page scatter (no sharing).
        Returns (cache, first greedy token)."""
        tok1, pk, pv = self._prefill(params, self._dev(req.prompt[None]))
        n_pp = self.pcfg.pages_for(req.prompt_len)
        rows = self._dev(np.asarray(req.pages[:n_pp], np.int64))
        self._write_pages(cache["blocks"], pk, pv, rows)
        bt[req.slot] = TRASH_PAGE
        bt[req.slot, :len(req.pages)] = req.pages
        return cache, int(tok1.cpu()[0, 0])

    def _admit_batched(self, cache, bt, admitted, params, faults=None):
        """Batched ragged admission: one dispatch per suffix bucket.

        Rows of a dispatch are the admissions themselves (compact — idle
        slots cost nothing), padded to a power-of-two row count and to
        the bucketized max suffix length, so a burst whose prefix already
        hit the cache pays only for its short suffixes.

        Ordering invariant: a sharer must not attend pages its
        same-boundary prefix owner has not written yet.  Within one
        dispatch the per-layer write-then-attend ordering covers this;
        across dispatches, buckets run longest-first, which is owner-first
        whenever the owner's suffix is at least as long as the sharer's.
        The one case that violates it — a sharer whose *own* suffix
        outgrows its owner's whole suffix — is split into a later *wave*
        by ``_admission_waves``, so its dispatch runs after the owner's.

        Returns ``(cache, {slot: first greedy token}, n_dispatches,
        failed)`` where ``failed`` lists admissions whose dispatch was
        killed by an injected ``dispatch_admit`` fault.  A fault aborts
        the *rest of the boundary* conservatively: later dispatches may
        prefix-share pages the faulted dispatch was supposed to write.
        """
        pcfg = self.pcfg
        bucket = max(1, pcfg.prefill_bucket)
        tok_by_slot: dict[int, int] = {}
        n_dispatches = 0
        failed: list = []
        aborted = False
        for req in admitted:
            bt[req.slot] = TRASH_PAGE
            bt[req.slot, :len(req.pages)] = req.pages
        for wave in self._admission_waves(admitted, bucket):
            groups: dict[int, list] = {}
            for req, s_pad in wave:
                groups.setdefault(s_pad, []).append(req)
            for s_pad, reqs in sorted(groups.items(), reverse=True):
                if aborted:
                    failed.extend(reqs)
                    continue
                try:
                    if faults is not None:
                        faults.gate("dispatch_admit")
                    toks = self._dispatch_admissions(cache, bt, reqs,
                                                     s_pad, params)
                except InjectedFault:
                    aborted = True
                    failed.extend(reqs)
                    continue
                tok_by_slot.update(toks)
                n_dispatches += 1
        return cache, tok_by_slot, n_dispatches, failed

    def _admission_waves(self, admitted, bucket):
        """Partition a boundary's admissions (FIFO order) into waves such
        that every same-boundary prefix dependency points to an
        equal-or-larger suffix bucket within the wave — which descending
        bucket order then dispatches first.  A sharer with a *larger*
        bucket than a current-wave owner closes the wave."""
        waves: list[list] = []
        cur: list = []
        cur_writers: dict[int, int] = {}   # page -> writer's bucket
        for req in admitted:
            sfx = req.prompt_len - req.shared_tokens
            s_pad = -(-sfx // bucket) * bucket
            deps = [cur_writers[p] for p in req.pages[:req.shared_pages]
                    if p in cur_writers]
            if any(b < s_pad for b in deps):
                waves.append(cur)
                cur, cur_writers = [], {}
            cur.append((req, s_pad))
            # pages this request's dispatch writes: its fresh suffix +
            # decode pages (shared prefix pages belong to their writer)
            for p in req.pages[req.shared_pages:]:
                cur_writers[p] = s_pad
        if cur:
            waves.append(cur)
        return waves

    def _dispatch_admissions(self, cache, bt, reqs, s_pad, params):
        """One compact dispatch for ``reqs`` at suffix pad ``s_pad``;
        returns {slot: first token}.  The pools update in place."""
        pcfg = self.pcfg
        a = 1
        while a < len(reqs):
            a *= 2
        tokens = np.zeros((a, s_pad), np.int32)
        offs = np.zeros((a,), np.int32)
        lens = np.zeros((a,), np.int32)
        gbt = np.full((a, pcfg.max_blocks), TRASH_PAGE, np.int32)
        cow_src = np.full((a,), TRASH_PAGE, np.int64)
        cow_dst = np.full((a,), TRASH_PAGE, np.int64)
        for i, req in enumerate(reqs):
            suffix = req.prompt[req.shared_tokens:]
            tokens[i, :len(suffix)] = suffix
            offs[i] = req.shared_tokens
            lens[i] = len(suffix)
            gbt[i] = bt[req.slot]
            if req.cow_src is not None:
                cow_src[i] = req.cow_src
                cow_dst[i] = req.cow_dst
        tok1 = self._admit_batch(
            params, cache["blocks"], self._dev(tokens), self._dev(gbt),
            self._dev(offs), self._dev(lens), self._dev(cow_src),
            self._dev(cow_dst))
        tok1 = tok1.cpu().numpy()
        return {req.slot: int(tok1[i, 0]) for i, req in enumerate(reqs)}

    def _swap_out(self, cache, swap, faults=None) -> None:
        """Pull a preempted request's pages back to host memory.  Must
        run before any subsequent dispatch: the pages are already on the
        free list, and the next admission/restore may overwrite them —
        the device data is only guaranteed intact until then.

        The image's CRC is recorded the moment it lands on host, so any
        later corruption or loss (real, or the swap_corrupt/swap_loss
        fault sites below) is caught by the recovery layer's one-time
        verification before a restore of the image is ever planned."""
        idx = self._dev(np.asarray(swap.pages, np.int64))
        swap.host_k = _to_host(cache["blocks"]["k_pages"][:, idx])
        swap.host_v = _to_host(cache["blocks"]["v_pages"][:, idx])
        swap.checksum = image_checksum(swap.host_k, swap.host_v)
        swap.verified = False
        if faults is not None:
            if faults.should_fire("swap_corrupt"):
                swap.host_k = corrupt_image(swap.host_k)
            if faults.should_fire("swap_loss"):
                swap.host_k = swap.host_v = None

    def _restore(self, cache, bt, req):
        """One-dispatch restore of a preempted request: blocks below
        ``restore_blocks[0]`` were re-matched from the prefix trie (pure
        aliasing, no data movement); the rest scatter back from the host
        image.  Row counts pad to a power of two (pad rows land on the
        scratch page), as in the JAX package."""
        slot = req.slot
        bt[slot] = TRASH_PAGE
        bt[slot, :len(req.pages)] = req.pages
        b0, b1 = req.restore_blocks
        if b1 <= b0:
            return cache, 0
        rows = np.asarray(req.pages[b0:b1], np.int64)
        pk = req.swap.host_k[:, b0:b1]
        pv = req.swap.host_v[:, b0:b1]
        n = len(rows)
        a = 1
        while a < n:
            a *= 2
        if a > n:
            rows = np.concatenate(
                [rows, np.full((a - n,), TRASH_PAGE, np.int64)])
            pad = np.zeros((pk.shape[0], a - n) + pk.shape[2:], pk.dtype)
            pk = np.concatenate([pk, pad], axis=1)
            pv = np.concatenate([pv, pad], axis=1)
        self._write_pages(
            cache["blocks"], _from_host(pk, self.cache_dtype, self.device),
            _from_host(pv, self.cache_dtype, self.device), self._dev(rows))
        return cache, 1

    def run(self, requests: list[Request], params, *,
            faults: FaultPlan | None = None,
            recovery: RecoveryPolicy | None = None,
            obs: Observability | None = None) -> dict:
        """Serve ``requests`` (honoring their ``arrival`` offsets) to
        completion.  Mutates each request in place (tokens, t_admitted,
        t_done, all relative to engine start) and returns run counters.

        ``faults`` installs a FaultPlan for this run (falling back to the
        engine default) and ``recovery`` overrides the RecoveryPolicy,
        so one engine serves both the fault-free baseline and its chaos
        replays.  With faults armed at any site, run() still
        never raises an injected fault: affected requests roll back to
        their boundary checkpoint, retry with exponential segment
        backoff, and either complete bit-identical to the fault-free run
        or land dead-lettered (``Request.failure``) after bounded
        retries.  The only exception that escapes the loop is
        :class:`EngineStalledError` from the no-progress watchdog.

        This is a thin wrapper over :class:`EngineRun`: feed arrivals,
        step boundaries, sleep through idle gaps.
        """
        er = EngineRun(self, params, faults=faults, recovery=recovery,
                       obs=obs)
        queue = sorted(requests, key=lambda q: q.arrival)
        nxt_arrival = 0
        with torch.no_grad():
            while nxt_arrival < len(queue) or er.has_work:
                now = er.clock()
                while (nxt_arrival < len(queue)
                       and queue[nxt_arrival].arrival <= now):
                    er.submit(queue[nxt_arrival])
                    nxt_arrival += 1
                if er.step() == "idle":
                    if nxt_arrival < len(queue):
                        # the pre-sorted queue's next arrival is the only
                        # possible event while idle: sleep the whole gap
                        wait = queue[nxt_arrival].arrival - er.clock()
                        if wait > 0:
                            time.sleep(wait)
                    elif er.has_work:
                        # queued/preempted/quarantined requests, nothing
                        # running, no arrivals left: only an admission (or
                        # a backoff expiry) can make progress and this
                        # boundary produced none — count it toward the
                        # watchdog instead of busy-spinning
                        er.note_stall()
            out = er.result()
            pol = er.obs.policy
            if er.obs.enabled and pol is not None and pol.export_dir:
                out["exports"] = er.obs.export(pol.export_dir)
            return out


class EngineRun:
    """One in-flight serving run: every piece of boundary-loop state —
    scheduler, recovery manager, device cache, per-slot host mirrors,
    counters — as attributes, advanced one segment boundary at a time by
    :meth:`step`.

    The split from :class:`PagedServingEngine` (entry points, stateless
    across runs) keeps one engine reusable across runs, each with its own
    page pool, block tables, tenant ledgers, and prefix trie.
    ``submit`` injects work mid-run and ``evacuate`` empties the run for
    a graceful drain, with every running request preserved as a verified
    host swap image.
    """

    def __init__(self, engine: PagedServingEngine, params, *,
                 faults: FaultPlan | None = None,
                 recovery: RecoveryPolicy | None = None,
                 clock=None, obs: Observability | None = None):
        self.engine = engine
        self.params = params
        pcfg = engine.pcfg
        self.pcfg = pcfg
        self.faults = faults if faults is not None else engine.faults
        policy = recovery if recovery is not None else engine.recovery
        self.policy = policy if policy is not None else RecoveryPolicy()
        if obs is None:
            obs = Observability.from_policy(engine.plan.observability)
        self.obs = obs
        self.tracer = obs.tracer
        self._rep = obs.replica
        self.sched = ContinuousBatchingScheduler.from_plan(
            engine.plan, faults=self.faults, obs=obs)
        self.rec = RecoveryManager(self.policy, self.sched)
        # latency histograms (NULL_METRIC when telemetry is off) + the
        # per-request records result() exports either way
        rep = ("replica",)
        self._h_queue = obs.histogram(
            "serving_queue_wait_seconds",
            "submit (arrival) to admission", rep)
        self._h_ttft = obs.histogram(
            "serving_ttft_seconds",
            "submit (arrival) to first token on device", rep)
        self._h_e2e = obs.histogram(
            "serving_e2e_latency_seconds",
            "submit (arrival) to completion", rep)
        self._h_decode = obs.histogram(
            "serving_decode_seconds_per_token",
            "segment dispatch wall over tokens committed", rep)
        self._h_admit = obs.histogram(
            "serving_admission_batch_seconds",
            "boundary admission wall (restores + prefills)", rep)
        self._g_free = obs.gauge(
            "serving_pool_free_pages", "allocator free pages", rep)
        self._g_held = obs.gauge(
            "serving_pool_held_pages", "allocator held pages", rep)
        self._g_running = obs.gauge(
            "serving_running_requests", "occupied slots", rep)
        self._g_queued = obs.gauge(
            "serving_queued_requests",
            "pending + preempted across tenants", rep)
        self.request_records: list[dict] = []
        self.cache = init_paged_cache(engine.model.cfg, pcfg,
                                      engine.cache_dtype, engine.device)
        r, m = pcfg.max_slots, pcfg.max_blocks
        self.bt = np.full((r, m), TRASH_PAGE, np.int32)
        self.seq_lens = np.zeros((r,), np.int32)
        self.tok = np.zeros((r, 1), np.int32)
        self.active = np.zeros((r,), bool)
        self.n_gen = np.zeros((r,), np.int32)
        self.max_new = np.ones((r,), np.int32)
        self.boundary = 0
        self.no_progress = 0
        self.n_segments = 0
        self.n_prefill_dispatches = 0
        self.n_restore_dispatches = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        if clock is None:
            t0 = time.perf_counter()
            clock = lambda: time.perf_counter() - t0   # noqa: E731
        self.clock = clock          # shared by all replicas of a cluster
        if self.faults is not None:
            # telemetry taps: fired AFTER a site's draw, outside the RNG
            # path, so attaching them never perturbs a chaos schedule
            self.faults.metrics = obs.counter(
                "serving_fault_fires_total",
                "injected fault fires, by site", ("site",))
            if self.tracer is not None:
                self.faults.trace_hook = (
                    lambda site, k: self.tracer.event(
                        None, "FAULT", self.boundary, self.clock(),
                        site=site, opportunity=k))

    # ----------------------------------------------------------- frontend
    def submit(self, req: Request) -> None:
        self.sched.submit(req)
        if self.tracer is not None:
            self.tracer.event(req.rid, "SUBMIT", self.boundary,
                              self.clock(), tenant=req.tenant,
                              prompt_len=req.prompt_len,
                              max_new=req.max_new_tokens)

    @property
    def has_work(self) -> bool:
        return self.sched.has_work or self.rec.has_quarantined

    # ------------------------------------------------- slot/request moves
    def _park_slot(self, slot: int) -> None:
        """Return a vacated slot to the inert state: row on the scratch
        page, no position, no activity.  Shared by retirement,
        preemption, and quarantine — every way a slot empties."""
        self.bt[slot] = TRASH_PAGE
        self.seq_lens[slot] = 0
        self.tok[slot] = 0
        self.active[slot] = False
        self.n_gen[slot] = 0

    def _retire_finished(self, now: float) -> None:
        for slot, req in list(self.sched.running.items()):
            if self.n_gen[slot] >= req.max_new_tokens:
                req.t_done = now
                self.sched.complete(slot)
                self._park_slot(slot)
                self._record_done(req)

    def _request_record(self, req: Request) -> dict:
        """Measured per-request latencies, all relative to arrival —
        result()['requests'] is the telemetry source SLO gates read
        instead of recomputing from Request fields."""
        arr = req.arrival
        return {"rid": req.rid, "tenant": req.tenant,
                "queue_wait_s": None if req.t_admitted is None
                else req.t_admitted - arr,
                "ttft_s": None if req.t_first is None
                else req.t_first - arr,
                "e2e_s": None if req.t_done is None
                else req.t_done - arr,
                "n_tokens": len(req.tokens),
                "preemptions": req.n_preempted,
                "retries": req.n_retries,
                "dead": req.failure is not None}

    def _record_done(self, req: Request) -> None:
        rec = self._request_record(req)
        self.request_records.append(rec)
        lab = (self._rep,)
        if rec["queue_wait_s"] is not None:
            self._h_queue.observe(rec["queue_wait_s"], lab)
        if rec["ttft_s"] is not None:
            self._h_ttft.observe(rec["ttft_s"], lab)
        if rec["e2e_s"] is not None:
            self._h_e2e.observe(rec["e2e_s"], lab)
        if self.tracer is not None:
            self.tracer.event(req.rid, "COMPLETE", self.boundary,
                              req.t_done or 0.0,
                              n_tokens=len(req.tokens),
                              preemptions=req.n_preempted,
                              retries=req.n_retries)

    def _start_request(self, req: Request, first_tok: int,
                       now: float) -> None:
        slot = req.slot
        self.seq_lens[slot] = req.prompt_len
        self.tok[slot] = first_tok
        self.n_gen[slot] = 1
        self.max_new[slot] = req.max_new_tokens
        self.active[slot] = req.max_new_tokens > 1
        req.tokens = [int(first_tok)]
        req.t_admitted = now
        if req.t_first is None:
            req.t_first = now

    def note_stall(self) -> None:
        """The deduplicated no-progress watchdog: both the
        nothing-running and the nothing-emitted paths count toward one
        threshold, and tripping it raises a typed error carrying the
        full diagnostic picture instead of a bare message."""
        self.no_progress += 1
        if self.no_progress > self.policy.watchdog_boundaries:
            raise EngineStalledError(
                f"serving engine made no progress for "
                f"{self.policy.watchdog_boundaries} consecutive "
                f"boundaries with work outstanding: resource-"
                f"manager deadlock (diagnostic snapshot attached)",
                diagnostic_snapshot(self.sched, self.rec, self.boundary,
                                    no_progress=self.no_progress,
                                    n_segments=self.n_segments))

    def _vacate(self, req: Request) -> None:
        """Pull a faulted request off its slot: scheduler row freed,
        device row parked on the scratch page."""
        self._park_slot(self.sched.vacate(req))

    def _quarantine_running(self, req: Request, reason: str,
                            site: str) -> None:
        """Roll a faulted running request back to its boundary
        checkpoint: truncate its tokens to the checkpoint, snapshot the
        pages that back it through the ordinary preemption machinery
        (the retry is then a bit-identical one-dispatch restore), vacate
        the slot, and park the request in the quarantine pen for its
        backoff.  Healthy slots are untouched."""
        now = self.clock()
        del req.tokens[req.ckpt_tokens:]
        if req.tokens:
            swap = self.sched.rm.preempt(req, requeue=False)
            self.engine._swap_out(self.cache, swap, self.faults)
            self._vacate(req)
        else:
            # no committed state to preserve: full restart
            self.sched.rm.release_request(req)
            self._vacate(req)
            self.rec.reset_for_restart(req)
        self.rec.hold(req, reason, self.boundary, now, site=site)

    def _unwind_admission(self, kind: str, req: Request) -> None:
        """A boundary dispatch for this freshly (re)admitted request
        faulted — or a dispatch it could alias did: its K/V never
        materialized on device, so drop the pages and retry.  A failed
        restore keeps its (verified) host image and retries as a
        restore; a failed fresh admission restarts from the prompt."""
        now = self.clock()
        self.sched.rm.release_request(req)
        self._vacate(req)
        if req.swap is not None:
            req.restore_blocks = (0, 0)
        else:
            self.rec.reset_for_restart(req)
        if self.tracer is not None:
            self.tracer.event(req.rid, "ADMIT_FAIL", self.boundary, now,
                              kind=kind)
        self.rec.hold(req, f"injected {kind} dispatch fault",
                      self.boundary, now,
                      site="dispatch_restore" if kind == "restore"
                      else "dispatch_admit")

    # ------------------------------------------------------ one boundary
    def step(self) -> str:
        """Advance one segment boundary (the host-loop order run()'s
        docstring fixes): recovery preflight → growth/swap-out →
        admissions → retire → invariant audit → checkpoint → segment
        dispatch → commit + quarantine + retire.

        Returns ``"ran"`` after a segment dispatch, ``"skipped"`` when an
        injected ``dispatch_segment`` fault dropped it (the boundary
        simply retries), and ``"idle"`` when nothing is running — the
        caller decides whether idleness means sleep (arrivals coming),
        a watchdog tick (:meth:`note_stall` — queued work that cannot
        admit), or that the run is simply drained.
        """
        engine, sched, rec = self.engine, self.sched, self.rec
        faults, clock = self.faults, self.clock
        bt, seq_lens = self.bt, self.seq_lens
        self.boundary += 1
        boundary = self.boundary
        # recovery preflight: quarantined requests whose backoff
        # expired rejoin their tenant queues; queued host images are
        # checksum-verified exactly once (a corrupted/lost image
        # becomes a restart *before* its restore is planned); under
        # sustained pressure, stale queued work is shed (opt-in)
        rec.release_due(boundary, clock())
        rec.verify_swaps(boundary, clock())
        rec.shed_stalled(boundary, clock())
        # growth-on-demand: back the next segment's writes, possibly
        # preempting victims...
        preempted = sched.plan_growth()
        # ...whose pages must reach host memory before any dispatch
        # below can recycle them (their refs are already dropped)
        for req in preempted:
            engine._swap_out(self.cache, req.swap, faults)
            self._park_slot(req.swap.slot)
            if self.tracer is not None:
                self.tracer.event(req.rid, "PREEMPT", boundary, clock(),
                                  by=req.preempted_by,
                                  pages=len(req.swap.pages),
                                  n_preempted=req.n_preempted)
        # grown block tables: new pages append to the owned prefix
        for slot, req in sched.running.items():
            bt[slot, :len(req.pages)] = req.pages
        if self.tracer is not None:
            for slot in sorted(sched.running):
                if sched.running[slot].stalled:
                    self.tracer.event(sched.running[slot].rid, "STALL",
                                      boundary, clock())
        admitted = sched.try_admit()
        rec.note_admitted(admitted)
        fresh = [r for r in admitted if r.swap is None]
        restored = [r for r in admitted if r.swap is not None]
        failed_admissions: list = []
        if admitted:
            t_pf = time.perf_counter()
            ok_admitted: list = []
            restore_fault = False
            # restores scatter FIRST: a same-boundary fresh admission
            # may trie-share a restore-range page (full-chunk entries
            # are matchable pre-ready by design), so its prefill must
            # only dispatch after the host image is back on device.
            # The reverse order is safe — a restore reads nothing at
            # scatter time; its aliased pages are only attended at
            # the next segment, after every boundary dispatch.
            for req in restored:
                if restore_fault:
                    failed_admissions.append(("restore", req))
                    continue
                try:
                    if faults is not None:
                        faults.gate("dispatch_restore")
                    self.cache, n_disp = engine._restore(self.cache, bt,
                                                         req)
                except InjectedFault:
                    restore_fault = True
                    failed_admissions.append(("restore", req))
                    continue
                self.n_restore_dispatches += n_disp
                slot = req.slot
                seq_lens[slot] = req.swap.n_tokens
                self.tok[slot] = req.tokens[-1]
                self.n_gen[slot] = len(req.tokens)
                self.max_new[slot] = req.max_new_tokens
                ok_admitted.append(req)
            if restore_fault:
                # conservative: a fresh admission may prefix-share a
                # page in the failed restore's range — without the
                # host image resident, its prefill would attend
                # garbage.  The boundary's remaining admissions all
                # unwind and retry.
                failed_admissions.extend(("admission", r)
                                         for r in fresh)
            elif fresh and engine.prefill_mode == "batched":
                self.cache, tok1, n_disp, failed = engine._admit_batched(
                    self.cache, bt, fresh, self.params, faults)
                for req in fresh:
                    if req.slot in tok1:
                        self._start_request(req, tok1[req.slot], clock())
                        ok_admitted.append(req)
                failed_admissions.extend(("admission", r)
                                         for r in failed)
                self.n_prefill_dispatches += n_disp
            elif fresh:
                # serial: one dispatch per admission; a fault aborts the
                # rest of the boundary, as in the batched path
                admit_fault = False
                for req in fresh:
                    if admit_fault:
                        failed_admissions.append(("admission", req))
                        continue
                    try:
                        if faults is not None:
                            faults.gate("dispatch_admit")
                        self.cache, first = engine._admit_serial(
                            self.cache, bt, req, self.params)
                    except InjectedFault:
                        admit_fault = True
                        failed_admissions.append(("admission", req))
                        continue
                    self._start_request(req, first, clock())
                    self.n_prefill_dispatches += 1
                    ok_admitted.append(req)
            if self.tracer is not None:
                # before finish_boundary: it clears req.swap, which is
                # what distinguishes a restore from a fresh admission
                rest_ids = set(map(id, restored))
                for req in ok_admitted:
                    self.tracer.event(req.rid, "ADMIT", boundary,
                                      clock(),
                                      restore=id(req) in rest_ids,
                                      slot=req.slot,
                                      pages=len(req.pages or []),
                                      shared_tokens=req.shared_tokens)
            sched.finish_boundary(ok_admitted)
            for kind, req in failed_admissions:
                self._unwind_admission(kind, req)
            dt_pf = time.perf_counter() - t_pf
            self.prefill_s += dt_pf
            self._h_admit.observe(dt_pf, (self._rep,))
        self._retire_finished(clock())
        if not sched.running:
            return "idle"
        if self.policy.check_invariants:
            # opt-in boundary audit of the state the dispatches are
            # about to trust; a violating request is quarantined as
            # a full restart (its pages are suspect) instead of
            # crashing the engine
            bad, _glob = rec.check_invariants(bt, seq_lens)
            for req, why in bad:
                now2 = clock()
                try:
                    sched.rm.release_request(req)
                except AllocatorError:
                    # the ledger itself is inconsistent for this
                    # request; shed what bookkeeping we can
                    req.charged = 0
                    req.pages = None
                self._vacate(req)
                rec.reset_for_restart(req)
                rec.hold(req, f"invariant violation: {why}",
                         boundary, now2, site="invariant")
            if not sched.running:
                return "idle"
        # the boundary checkpoint: everything committed as of this
        # instant is exactly what the device pages back — the
        # watermark every later rollback truncates to
        rec.checkpoint(sched.running.values())
        # activity is a pure function of scheduler state: stalled
        # slots sit a segment out (their frozen write slot stays
        # inside pages they own), everyone else runs to max_new.
        # The feed token is re-derived from committed state, not the
        # segment carry: an inactive slot's carry is masked to 0
        # on the device, so a slot coming back from a stalled segment
        # would otherwise resume from a zero token (for healthy
        # active slots tokens[-1] IS the carried token, so this is
        # an identity)
        for slot, req in sched.running.items():
            self.active[slot] = (not req.stalled) \
                and self.n_gen[slot] < self.max_new[slot]
            self.tok[slot] = req.tokens[-1]

        poison = np.zeros((self.pcfg.max_slots,), np.float32)
        if faults is not None and faults.should_fire("decode_poison"):
            live = [s for s in sched.running if self.active[s]]
            if live:
                poison[min(live)] = np.nan
        try:
            if faults is not None:
                faults.gate("dispatch_segment")
        except InjectedFault:
            # segment skipped wholesale: no state moved, nothing to
            # roll back — the boundary simply retries.  Bounded by
            # the plan's max_fires.
            rec._c_dispatch_faults.inc(1.0, (rec._rep,))
            return "skipped"
        t_seg = time.perf_counter()
        cache = dict(self.cache, block_tables=engine._dev(bt),
                     seq_lens=engine._dev(seq_lens))
        cache, tok_d, act_d, gen_d, toks, emits, pois_d = \
            engine._segment(self.params, cache, engine._dev(self.tok),
                            engine._dev(self.active),
                            engine._dev(self.n_gen),
                            engine._dev(self.max_new),
                            engine._dev(poison))
        # one device->host copy per segment
        r = self.pcfg.max_slots
        n_steps = toks.shape[0]
        host = torch.cat([toks.reshape(-1), emits.reshape(-1).int(),
                          tok_d.reshape(-1), act_d.int(), gen_d,
                          cache["seq_lens"], pois_d.int()]).cpu().numpy()
        dt_seg = time.perf_counter() - t_seg
        self.cache = {"blocks": cache["blocks"],
                      "block_tables": cache["block_tables"],
                      "seq_lens": cache["seq_lens"]}
        self.n_segments += 1
        self.decode_s += dt_seg
        parts = np.split(host, np.cumsum([n_steps * r, n_steps * r,
                                          r, r, r, r]))
        toks = parts[0].reshape(n_steps, r)
        emits = parts[1].reshape(n_steps, r).astype(bool)
        n_emitted = int(emits.sum())
        if n_emitted:
            self._h_decode.observe(dt_seg / n_emitted, (self._rep,))
        # copies: host bookkeeping mutates these in place
        self.tok = parts[2].reshape(r, 1).copy()
        self.active = parts[3].astype(bool)
        self.n_gen = parts[4].copy()
        self.seq_lens = seq_lens = parts[5].copy()
        poisoned = parts[6].astype(bool)
        for slot, req in sched.running.items():
            req.tokens.extend(
                int(t) for t in toks[emits[:, slot], slot])
        if self.tracer is not None:
            for slot in sorted(sched.running):
                n_em = int(emits[:, slot].sum())
                if n_em:
                    self.tracer.event(sched.running[slot].rid, "SEGMENT",
                                      boundary, clock(), tokens=n_em)
        # anti-livelock: surviving one generated segment makes a
        # request preemptable again
        sched.end_segment(slot for slot in sched.running
                          if emits[:, slot].any())
        # NaN/inf logit guard, before retirement: a poisoned slot
        # stopped emitting on the device and must never retire garbage —
        # it rolls back to this boundary's checkpoint and retries
        for slot in [s for s in list(sched.running) if poisoned[s]]:
            self._quarantine_running(sched.running[slot],
                                     "non-finite decode logits",
                                     site="decode_poison")
        if emits.any() or admitted or preempted:
            self.no_progress = 0
        else:
            # unreachable by the liveness argument in resources.py
            # (a stall implies an unprotected victim exists, and
            # protected requests are freshly provisioned to run) —
            # fail loudly rather than spin if a policy bug lands
            self.note_stall()
        self._retire_finished(clock())
        if self.obs.enabled:
            alloc = sched.allocator
            lab = (self._rep,)
            self._g_free.set(alloc.n_free, lab)
            self._g_held.set(alloc.n_held, lab)
            self._g_running.set(len(sched.running), lab)
            self._g_queued.set(
                sum(len(st.pending) + len(st.preempted)
                    for st in sched.rm._tenants.values()), lab)
        return "ran"

    # ------------------------------------------------------------- drain
    def evacuate(self) -> list[Request]:
        """Empty the run for a graceful drain: preempt every running
        request through the ordinary host-swap machinery (the device is
        healthy, so every image is captured and CRC'd), then hand back
        everything queued and quarantined.  After this the run holds no
        requests and its pool is back to free + retention pins; the
        caller (cluster drain/rolling restart) re-routes the returned
        requests to other replicas."""
        out: list[Request] = []
        for slot in sorted(self.sched.running):
            req = self.sched.running[slot]
            swap = self.sched.rm.preempt(req, requeue=False)
            self.engine._swap_out(self.cache, swap, self.faults)
            req.n_preempted += 1
            self._vacate(req)
            out.append(req)
        out.extend(self.sched.rm.drain_queued())
        out.extend(self.rec.drain_quarantined())
        return out

    # ------------------------------------------------------------ result
    def result(self) -> dict:
        out = {"n_segments": self.n_segments,
               "n_admitted": self.sched.n_admitted,
               "n_finished": len(self.sched.finished),
               "n_dead_lettered": len(self.rec.dead),
               "n_prefill_dispatches": self.n_prefill_dispatches,
               "n_restore_dispatches": self.n_restore_dispatches,
               "prefill_s": self.prefill_s,   # summed admission work
               "decode_s": self.decode_s,     # summed segment dispatches
               "wall_s": self.clock(),
               "recovery": self.rec.stats(),
               # measured per-request latency records (dead letters
               # included) + the registry roll-up: SLO gates and the
               # traffic replay feature vector read from here instead of
               # re-deriving from Request fields
               "requests": [dict(r) for r in self.request_records]
               + [self._request_record(r) for r in self.rec.dead],
               "metrics": render_summary(self.obs.registry),
               **self.sched.stats()}
        if self.faults is not None:
            out["faults"] = self.faults.summary()
        return out


def warmup(engine: PagedServingEngine, params, prompt_len: int,
           max_new_tokens: int, n_requests: int = 1) -> None:
    """Run one small workload outside any timed region: the first run
    builds the CUDA kernels and warms the allocator and the libraries'
    per-shape setup.  For bursty shared-prefix traffic the simplest
    warmup is running the actual workload once untimed.
    """
    # a tenant-configured engine rejects unknown tenant names (closed
    # roster), so warmup traffic runs as the first configured tenant
    tenant = (engine.tenants[0].name if engine.tenants
              else DEFAULT_TENANT)
    reqs = [Request(rid=f"warmup{i}",
                    prompt=np.zeros((prompt_len,), np.int32),
                    max_new_tokens=max_new_tokens, tenant=tenant)
            for i in range(n_requests)]
    engine.run(reqs, params)
