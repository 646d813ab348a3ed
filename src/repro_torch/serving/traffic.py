"""TrafficProfile: seeded synthetic serving workloads + the replay scorer.

The SERVE design-flow task (tasks/serve.py) needs a *fitness function*
for candidate :class:`~repro_torch.serving.plan.ServingPlan`\\ s, and a
serving benchmark needs reproducible request streams.  Both are the
same thing: a :class:`TrafficProfile` — request count, arrival process,
shared-prefix ratio, tenant mix, prompt/gen lengths, one seed — expanded
deterministically into :class:`~repro_torch.serving.scheduler.Request`
lists by :meth:`requests`, so the flow's objective is measured on
exactly the workload a benchmark row replays.

:func:`replay` runs one profile through an engine built from a plan and
returns the uptune-style split the staged search prunes on:

- *intermediate features* (cheap, behavioral, deterministic for a burst
  profile): admission latency percentiles, preemptions, peak resident
  pages, allocation failures, segment count, dead letters;
- the *objective*: aggregate generated tokens per wall second, with
  feasibility = every request finished and nothing dead-lettered.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.serving.resources import DEFAULT_TENANT


@dataclasses.dataclass(frozen=True)
class TrafficProfile:
    """One synthetic serving workload, fully determined by its fields.

    ``arrival_rate`` (requests/s) drives a seeded Poisson arrival
    process; ``None`` means a burst (everything arrives at t=0 — also
    the fully deterministic mode, since no wall-clock sleeping is
    involved).  ``prefix_share`` is the fraction of the prompt shared
    verbatim by every request (aligned down to page granularity by
    :meth:`requests`, mirroring real system prompts).  ``tenant_mix``
    assigns tenants by seeded weighted sampling."""
    name: str = "smoke"
    n_requests: int = 8
    arrival_rate: float | None = None     # req/s; None = burst at t=0
    prefix_share: float = 0.0             # fraction of prompt shared
    prompt_len: int = 32
    max_new_tokens: int = 16
    tenant_mix: tuple[tuple[str, float], ...] = ()   # (tenant, weight)
    seed: int = 0

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if not 0.0 <= self.prefix_share < 1.0:
            raise ValueError("need 0 <= prefix_share < 1")

    # ------------------------------------------------------- (de)serialize
    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["tenant_mix"] = [list(t) for t in self.tenant_mix]
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrafficProfile":
        """Unknown keys dropped, missing keys defaulted — the same
        forward-compat contract as ServingPlan/PagedCacheConfig."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if "tenant_mix" in kw:
            kw["tenant_mix"] = tuple((str(n), float(w))
                                     for n, w in kw["tenant_mix"])
        return cls(**kw)

    def scaled(self, frac: float) -> "TrafficProfile":
        """A cheaper copy for the staged search's stage 1: same arrival
        process, same mix, same seed, ``frac`` of the requests and of
        the generation length (floored so the workload stays
        non-trivial)."""
        return dataclasses.replace(
            self,
            name=f"{self.name}@{frac:g}",
            n_requests=max(1, int(round(self.n_requests * frac))),
            max_new_tokens=max(2, int(round(self.max_new_tokens * frac))))

    # ------------------------------------------------------------ expand
    def requests(self, vocab_size: int, *, page_size: int = 1) -> list:
        """Deterministic request list for this profile.

        Prompts come from the same Zipf-bigram token stream the benches
        use (data/synthetic.lm_tokens, keyed on ``seed``); the shared
        prefix overwrites the head of every prompt with request 0's,
        aligned down to ``page_size`` (the prefix cache's match
        granule).  Arrivals are a seeded exponential cumsum when
        ``arrival_rate`` is set; tenants are seeded weighted draws from
        ``tenant_mix``."""
        from repro_torch.data.synthetic import lm_tokens
        from repro_torch.serving.scheduler import Request

        n, pl = self.n_requests, self.prompt_len
        prompts = np.asarray(
            lm_tokens(n * pl, vocab_size, seed=self.seed)
        ).reshape(n, pl).astype(np.int32)
        if self.prefix_share > 0.0 and page_size >= 1:
            prefix_len = int(self.prefix_share * pl) // page_size \
                * page_size
            prefix_len = min(prefix_len, pl - 1)  # keep >= 1 suffix token
            if prefix_len > 0:
                prompts[:, :prefix_len] = prompts[0, :prefix_len]
        arrivals = [0.0] * n
        rng = np.random.default_rng(self.seed + 1)
        if self.arrival_rate:
            arrivals = np.cumsum(
                rng.exponential(1.0 / self.arrival_rate, size=n)).tolist()
        tenants = [DEFAULT_TENANT] * n
        if self.tenant_mix:
            names = [t for t, _ in self.tenant_mix]
            w = np.asarray([w for _, w in self.tenant_mix], float)
            tenants = [str(t) for t in
                       rng.choice(names, size=n, p=w / w.sum())]
        return [Request(rid=i, prompt=prompts[i],
                        max_new_tokens=self.max_new_tokens,
                        arrival=arrivals[i], tenant=tenants[i])
                for i in range(n)]


def replay(model, params, plan, profile: TrafficProfile, *,
           warm: int = 1) -> tuple[bool, float, dict[str, Any]]:
    """Score one :class:`~repro_torch.serving.plan.ServingPlan` on one profile.

    Builds the engine via ``PagedServingEngine.from_plan``, runs ``warm``
    untimed passes (kernel builds, allocator warm-up), then one measured
    pass.  Returns the ``(feasible, objective, features)`` triple the
    search primitives consume: objective is aggregate generated tokens
    per wall second; features are the cheap intermediate signals
    (admission latency, preemptions, peak pages, ...) stage 1 prunes on.
    Replication is a deployment knob, not a fitness term — scoring runs
    a single engine regardless of ``plan.n_replicas``.

    Isolation: a candidate plan that stalls its engine (pathological
    geometry under the profile) scores infeasible instead of raising —
    and win or lose, every request's engine residue (host swap images,
    page lists into the candidate's pool) is scrubbed in a ``finally``,
    so a faulted stage-1 replay in ``staged_search`` can never leak
    pool state into the next candidate's measurement.
    """
    from repro_torch.serving.engine import PagedServingEngine
    from repro_torch.serving.recovery import EngineStalledError

    engine = PagedServingEngine.from_plan(model, plan)
    vocab = int(model.cfg.vocab_size)
    ps = plan.cache.page_size
    warm_reqs: list = []
    reqs = profile.requests(vocab, page_size=ps)
    try:
        for _ in range(max(0, warm)):
            warm_reqs = profile.requests(vocab, page_size=ps)
            engine.run(warm_reqs, params)
        stats = engine.run(reqs, params)
    except EngineStalledError as e:
        return False, 0.0, {"profile": profile.name, "stalled": True,
                            "reason": str(e)}
    finally:
        for r in reqs + warm_reqs:
            r.swap = None
            r.pages = None
            r.slot = None
            r.restore_blocks = (0, 0)
        del engine
    # stage-1 feature vector reads from the telemetry layer — the
    # measured per-request records in stats["requests"] and the
    # registry-backed counters — not from Request fields
    adm = [rec["queue_wait_s"] for rec in stats["requests"]
           if rec["queue_wait_s"] is not None]
    tokens = sum(rec["n_tokens"] for rec in stats["requests"])
    feats = {
        "profile": profile.name,
        "admission_p50_s": float(np.percentile(adm, 50)) if adm else 0.0,
        "admission_p95_s": float(np.percentile(adm, 95)) if adm else 0.0,
        "preemptions": int(stats["preemptions"]),
        "peak_pages": int(plan.cache.allocatable_pages
                          - stats["free_low_water"]),
        "alloc_failures": int(stats["alloc_failures"]),
        "n_segments": int(stats["n_segments"]),
        "dead_letters": int(stats["n_dead_lettered"]),
        "tokens": int(tokens),
        "wall_s": float(stats["wall_s"]),
        "decode_s": float(stats["decode_s"]),
    }
    ok = stats["n_dead_lettered"] == 0 \
        and stats["n_finished"] == len(reqs)
    objective = tokens / max(stats["wall_s"], 1e-9)
    return ok, objective, feats


def make_replay_scorer(model, params, profile: TrafficProfile, *,
                       stage1_frac: float = 0.5, warm: int = 1):
    """The SERVE task's default two-stage fitness function: stage 1
    replays a :meth:`TrafficProfile.scaled` shrink of the profile
    (cheap — fewer requests, shorter generations), stage 2 the full
    profile.  Returns ``scorer(plan, stage) -> (ok, objective, info)``.
    """
    cheap = profile.scaled(stage1_frac)

    def scorer(plan, stage: int):
        prof = cheap if stage == 1 else profile
        return replay(model, params, plan, prof, warm=warm)

    return scorer
