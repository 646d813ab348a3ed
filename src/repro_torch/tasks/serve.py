"""SERVE O-task: staged search over the joint ServingPlan space.

TUNE picks per-kernel tile configs; SERVE closes the remaining gap
between a tuned model and a deployment: it searches the *joint* serving
configuration — pool geometry (page size, pages, oversubscription),
scheduler cadence (segment length, prefill bucket), growth/retention
policy — as one :class:`~repro_torch.serving.plan.ServingPlan`, scored by
replaying a seeded :class:`~repro_torch.serving.traffic.TrafficProfile`
through the real engine.

The search is two-staged (core/search.staged_search, uptune's
intermediate-feature idiom): stage 1 replays a shrunk profile and every
candidate's cheap intermediate features (admission latency, preemptions,
peak pages) land in the step trace; only the top-ranked survivors pay
for the full stage-2 replay.  The hand-assembled default plan is always
candidate 0 and always promoted to stage 2, so the searched winner is
gated against it on equal footing — the emitted plan is never worse
than the default on the profile's objective, by construction.

In a flow, SERVE sits after TUNE (``T → V``): TUNE persists its winning
tile configs to the autotune cache, and :meth:`ServingPlan.resolve`
reads page_size/segment_len back from that same cache when assembling
the default candidate — the cross-stage linkage is the on-disk cache,
same as the serving benches.  Every trial is republished as a
``SearchStep`` (``serve.probe`` events), and the winning plan is
attached to the output artifact (``handle.meta["serving_plan"]``), to
the shared CFG (``serve.result``), and — when ``artifact_path`` is set
— written as the deployable JSON artifact that
``ServingPlan.from_dict`` + ``PagedServingEngine.from_plan`` turn back
into the exact searched deployment.

Multiplicity 1-to-1 (paper Table I): the model is unchanged; the output
artifact is a child carrying the deployment plan.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from repro_torch.core.metamodel import LEVEL_DNN, MetaModel
from repro_torch.core.search import staged_search
from repro_torch.core.task import OTask, TaskError
from repro_torch.tasks.handle import DNNHandle


class Serve(OTask):
    n_in = 1
    n_out = 1
    defaults = {
        "profile": None,        # None -> tiny smoke profile; dict ok
        "slots": 4,             # concurrent decode slots
        "pool_slots": None,     # pool sized for fewer lifetimes (oversub)
        "tenants": (),          # TenantConfig roster for every candidate
        "n_replicas": 1,        # deployment shape (not a fitness term)
        "grid": None,           # None -> candidate_grid(default_plan)
        "keep": None,           # stage-2 survivors; None -> see execute()
        "stage1_frac": 0.5,     # stage-1 profile shrink factor
        "warm": 1,              # untimed warmup replays per trial
        "cache_path": None,     # autotune cache (None -> default path)
        "artifact_path": None,  # write winning plan JSON here
        "scorer": None,         # override: scorer(plan, stage) -> triple
    }

    def execute(self, meta: MetaModel, inputs):
        # deferred: pulls in the serving engine and the kernels, which
        # flows without a SERVE stage should not pay for at import time
        from repro_torch.serving.paged_cache import supports_paging
        from repro_torch.serving.plan import ServingPlan
        from repro_torch.serving.traffic import TrafficProfile, \
            make_replay_scorer

        art = meta.model(inputs[0])
        handle: DNNHandle = art.payload
        if handle.model is None or not supports_paging(handle.model.cfg):
            raise TaskError(
                f"{self.name}: input model does not support paged "
                "serving (needs an LM arch with dense-attention linear "
                "caches)")
        profile = self.param(meta, "profile")
        if profile is None:
            profile = TrafficProfile(name="smoke", n_requests=4,
                                     prompt_len=16, max_new_tokens=8)
        elif isinstance(profile, dict):
            profile = TrafficProfile.from_dict(profile)

        cfg = handle.model.cfg
        default_plan = ServingPlan.resolve(
            cfg, slots=self.param(meta, "slots"),
            max_prompt_len=profile.prompt_len,
            max_new_tokens=profile.max_new_tokens,
            pool_slots=self.param(meta, "pool_slots"),
            tenants=self.param(meta, "tenants"),
            n_replicas=self.param(meta, "n_replicas"),
            cache_path=self.param(meta, "cache_path"),
            device=handle.model.device)
        grid = self.param(meta, "grid")
        if grid is None:
            grid = candidate_grid(default_plan)
        keep = self.param(meta, "keep")
        if keep is None:
            # worst case stage 2 runs keep+1 plans (survivors plus the
            # promoted default), so this keeps stage-2 replays at no more
            # than half the grid — the pruning the staged search is for
            keep = max(1, len(grid) // 2 - 1)
        scorer = self.param(meta, "scorer")
        if scorer is None:
            scorer = make_replay_scorer(
                handle.model, handle.params, profile,
                stage1_frac=self.param(meta, "stage1_frac"),
                warm=self.param(meta, "warm"))

        meta.record("serve.start", task=self.name, profile=profile.name,
                    n_candidates=len(grid), keep=keep)
        result = staged_search(
            grid, lambda p: scorer(p, 1), lambda p: scorer(p, 2),
            keep=keep, must_keep=(0,))
        for step in result.steps:
            meta.record("serve.probe", step=step.step,
                        stage=step.info.get("stage"),
                        page_size=step.x.cache.page_size,
                        segment_len=step.x.cache.segment_len,
                        n_pages=step.x.cache.n_pages,
                        objective=step.objective, feasible=step.feasible,
                        **{k: v for k, v in step.info.items()
                           if k not in ("stage",)})
        best = result.best_x
        if best is None:
            raise TaskError(f"{self.name}: no feasible plan on profile "
                            f"{profile.name!r}")
        stage2 = [s for s in result.steps if s.info.get("stage") == 2]
        default_obj = next(
            (s.objective for s in stage2 if s.info.get("candidate") == 0),
            None)
        n_stage2 = len(stage2)
        meta.record("serve.done", profile=profile.name,
                    objective=result.best_objective,
                    default_objective=default_obj,
                    n_stage2=n_stage2, n_pruned=len(grid) - n_stage2,
                    plan=best.to_dict())

        artifact_path = self.param(meta, "artifact_path")
        if artifact_path:
            with open(artifact_path, "w") as f:
                json.dump(best.to_dict(), f, indent=2, sort_keys=True)

        out_handle = handle.child(
            meta={**handle.meta, "serving_plan": best.to_dict()})
        metrics = {**{k: v for k, v in art.metrics.items()
                      if isinstance(v, (int, float))},
                   "serve.objective": result.best_objective,
                   "serve.n_candidates": len(grid),
                   "serve.n_stage2": n_stage2,
                   "serve.n_pruned": len(grid) - n_stage2}
        if default_obj is not None:
            metrics["serve.default_objective"] = default_obj
        out = meta.add_model(f"{handle.name}+V", LEVEL_DNN, out_handle,
                             parent=inputs[0], metrics=metrics)
        meta.set("serve.result", {
            "plan": best.to_dict(),
            "profile": profile.to_dict(),
            "objective": result.best_objective,
            "default_objective": default_obj,
            "n_candidates": len(grid),
            "n_stage2": n_stage2,
            "n_pruned": len(grid) - n_stage2,
        })
        return [out]


def _regeometry(plan, *, page_size: int | None = None,
                **cache_overrides: Any):
    """One grid neighbor: replace cache knobs, re-deriving the pool
    geometry when the page size changes (same ``blocks = ceil(cap /
    page_size)``, ``n_pages = pool * blocks + 1`` rule as
    :meth:`ServingPlan.resolve`), and mark the moved knobs as
    ``searched`` in provenance."""
    cache = plan.cache
    prov = dict(plan.provenance)
    if page_size is not None and page_size != cache.page_size:
        blocks = -(-plan.cap_tokens // page_size)
        pool = (cache.n_pages - 1) // cache.max_blocks
        cache = dataclasses.replace(cache, page_size=page_size,
                                    n_pages=pool * blocks + 1,
                                    max_blocks=blocks)
        prov["page_size"] = "searched"
    if cache_overrides:
        cache = dataclasses.replace(cache, **cache_overrides)
        for k in cache_overrides:
            prov[k] = "searched"
    return dataclasses.replace(plan, cache=cache, provenance=prov)


def candidate_grid(default_plan) -> list:
    """The SERVE search space: the resolved default plan first (index 0
    — the staged search pins it to stage 2 as the gate baseline), then
    its one-knob neighbors: page size halved/doubled (pool geometry
    re-derived), segment cadence halved/doubled, a smaller prefill
    admission bucket, growth-on-demand enabled, and retention-assisted
    restore enabled.  Deduplicated on the effective cache config."""
    c = default_plan.cache
    cands = [default_plan]
    if c.page_size // 2 >= 4:
        cands.append(_regeometry(default_plan,
                                 page_size=c.page_size // 2))
    cands.append(_regeometry(default_plan, page_size=c.page_size * 2))
    if c.segment_len // 2 >= 2:
        cands.append(_regeometry(default_plan,
                                 segment_len=c.segment_len // 2))
    cands.append(_regeometry(default_plan,
                             segment_len=c.segment_len * 2))
    if c.prefill_bucket // 2 >= 1:
        cands.append(_regeometry(default_plan,
                                 prefill_bucket=c.prefill_bucket // 2))
    cands.append(_regeometry(default_plan, growth_pages=c.max_blocks))
    cands.append(_regeometry(default_plan, retain_pages=c.max_blocks))
    seen: set[str] = set()
    out = []
    for p in cands:
        key = json.dumps(p.cache.to_dict(), sort_keys=True)
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out
