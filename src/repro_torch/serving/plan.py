"""ServingPlan: the single declarative serving artifact.

PRs 3–7 built every serving mechanism, but deployment stayed
hand-assembled: pool geometry lived in :class:`PagedCacheConfig`
construction sites, kernel tile choices in ad-hoc
``preferred_page_size``/``preferred_segment_len`` readbacks, tenant
quotas in engine kwargs, and cluster shape in ``ServingCluster`` kwargs.
A :class:`ServingPlan` folds all of it into one frozen, JSON-round-trip
dataclass:

- the paged-cache geometry and scheduler cadence (``cache``);
- how each tuned knob was obtained (``provenance``: the
  :meth:`resolve` step reads page_size and segment_len back from the
  autotuner's persisted cache through the consolidated
  :func:`repro_torch.kernels.autotune.tile_readback` and records per knob
  whether the value was ``tuned``/``relaxed``/``default``/``explicit``);
- admission/growth/retention policy (all `PagedCacheConfig` fields:
  ``prefill_bucket``, ``growth_pages``, ``retain_pages``,
  prefix-sharing flags);
- the tenant roster and the cluster shape (``n_replicas``,
  :class:`HealthPolicy`);
- the durability story (:class:`DurabilityPolicy`: whether runs built
  from the plan keep a write-ahead request journal, where it lives,
  its fsync cadence and segment rotation size — serving/journal.py);
- the workload sizing the pool was resolved against
  (``max_prompt_len``/``max_new_tokens``), so a loaded plan can
  re-validate or re-resolve.

Deployment is then one call: ``PagedServingEngine.from_plan(model,
plan)`` or ``ServingCluster.from_plan(model, params, plan)``.  The
kwargs constructors stay as thin compat layers that assemble a plan
internally, so every pre-existing call site keeps working while the
plan remains the single source of truth (``engine.plan``).

``to_dict``/``from_dict`` follow PagedCacheConfig's checkpoint-compat
contract — unknown keys dropped, missing keys defaulted — applied
recursively through the nested config dataclasses, so a plan JSON
written before a knob existed (or after one is retired) stays loadable
bit-for-bit on the fields both sides know.

The SERVE design-flow task (tasks/serve.py) searches the space of these
plans and emits the winner as a deployable JSON artifact.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.serving.paged_cache import PagedCacheConfig
from repro_torch.serving.resources import TenantConfig


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Boundary-heartbeat thresholds.  A replica beats once per round it
    steps; ``suspect_after`` consecutive misses mark it SUSPECT (still
    routed as a last resort, still stepped), ``dead_after`` mark it DEAD
    (fenced + salvaged).  One dropped heartbeat with stepping intact
    (the ``heartbeat_loss`` site) therefore never kills a replica on its
    own — the false-positive resilience the thresholds exist for.

    Defined here (not serving/cluster.py, which re-exports it) so a
    :class:`ServingPlan` can carry the cluster shape without importing
    the cluster module."""
    suspect_after: int = 2
    dead_after: int = 4

    def __post_init__(self):
        if not 1 <= self.suspect_after <= self.dead_after:
            raise ValueError("need 1 <= suspect_after <= dead_after")


@dataclasses.dataclass(frozen=True)
class DurabilityPolicy:
    """Write-ahead-journal knobs (serving/journal.py).

    ``enabled`` turns on journaling for every run built from the plan;
    ``journal_dir`` is where segments, spilled swap images, and the
    plan's own JSON land (the *whole* restart story lives in that one
    directory); ``fsync_boundaries`` is the fsync batching cadence —
    progress records buffer and hit disk every N segment boundaries
    (terminal records always fsync immediately: a SUBMIT/COMPLETE/
    DEAD-LETTER is an acknowledgement); ``segment_bytes`` rotates the
    journal to a fresh segment file once the current one exceeds it.

    Defined here (not serving/journal.py) for the same reason as
    :class:`HealthPolicy`: the plan must carry the knob group without
    importing the machinery."""
    enabled: bool = False
    journal_dir: str = ""
    fsync_boundaries: int = 1
    segment_bytes: int = 1 << 20

    def __post_init__(self):
        if self.enabled and not self.journal_dir:
            raise ValueError("durability enabled without a journal_dir")
        if self.fsync_boundaries < 1:
            raise ValueError("fsync_boundaries must be >= 1")
        if self.segment_bytes < 256:
            raise ValueError("segment_bytes must be >= 256 (a segment "
                             "must fit at least one framed record)")


@dataclasses.dataclass(frozen=True)
class ObservabilityPolicy:
    """Telemetry knobs (serving/observe.py).

    ``enabled`` arms the full layer for runs built from the plan:
    latency histograms, pool/queue gauges, the request-lifecycle
    tracer with the engine's boundary spans, and (when ``export_dir``
    is set) a Prometheus text export plus JSONL traces and spans
    written at run end.  Counters stay live either
    way — they back the ``stats()`` views — so disabling telemetry
    only strips the probes that cost something (a disabled probe is
    one attribute lookup against a shared no-op handle).

    ``histogram_buckets`` overrides the default exponential latency
    grid (strictly increasing upper bounds, seconds); empty means the
    default.  ``trace`` turns the tracer off independently for
    metrics-only runs.

    Defined here (not serving/observe.py) for the same reason as
    :class:`HealthPolicy`: the plan carries the knob group without
    importing the machinery."""
    enabled: bool = False
    export_dir: str = ""
    histogram_buckets: tuple = ()
    trace: bool = True

    def __post_init__(self):
        object.__setattr__(self, "histogram_buckets",
                           tuple(float(b)
                                 for b in self.histogram_buckets))
        b = self.histogram_buckets
        if any(x <= 0 for x in b) or list(b) != sorted(set(b)):
            raise ValueError("histogram_buckets must be positive and "
                             f"strictly increasing: {b}")
        if self.export_dir and not self.enabled:
            raise ValueError("export_dir set but observability "
                             "disabled — nothing would be written")


def _filtered(cls, d: dict[str, Any]):
    """Drop-unknown/default-missing constructor for a dataclass — the
    PagedCacheConfig.from_dict forward-compat contract, shared by every
    nested config the plan serializes."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """One deployment, declaratively.  See the module docstring."""
    arch: str = ""                        # arch config name (informational)
    cache: PagedCacheConfig = dataclasses.field(
        default_factory=PagedCacheConfig)
    prefill_mode: str = "batched"         # "batched" | "serial"
    cache_dtype: str = "bfloat16"         # dtype name (JSON-safe)
    tenants: tuple[TenantConfig, ...] = ()
    n_replicas: int = 1
    health: HealthPolicy = dataclasses.field(default_factory=HealthPolicy)
    durability: DurabilityPolicy = dataclasses.field(
        default_factory=DurabilityPolicy)
    observability: ObservabilityPolicy = dataclasses.field(
        default_factory=ObservabilityPolicy)
    # workload sizing the pool geometry was resolved against
    max_prompt_len: int = 32
    max_new_tokens: int = 16
    # knob -> "tuned" | "relaxed" | "default" | "capped" | "explicit"
    # (or "searched" once the SERVE task moves it off the resolved
    # value); filled by resolve(), empty for hand-assembled plans
    provenance: dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.prefill_mode not in ("batched", "serial"):
            raise ValueError(f"prefill_mode={self.prefill_mode!r}")
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")

    # ------------------------------------------------------------ derived
    @property
    def slots(self) -> int:
        return self.cache.max_slots

    @property
    def sharing(self) -> bool:
        """Effective prefix sharing: the serial batch-1 prefill path
        always computes (and would re-store) whole prompts, so sharing
        requires the batched ragged admission path."""
        return self.cache.enable_prefix_sharing \
            and self.prefill_mode == "batched"

    @property
    def cap_tokens(self) -> int:
        """Cache slots one fully generated request occupies (+1: the
        final decode step still writes its token's K/V)."""
        return self.max_prompt_len + self.max_new_tokens + 1

    # ------------------------------------------------------------ resolve
    @classmethod
    def resolve(cls, cfg, *, slots: int, max_prompt_len: int,
                max_new_tokens: int, pool_slots: int | None = None,
                page_size: int | None = None,
                page_size_cap: int | None = None,
                segment_len: int | None = None,
                prefill_mode: str = "batched",
                cache_dtype: str = "bfloat16",
                tenants=(), n_replicas: int = 1,
                health: HealthPolicy | None = None,
                durability: DurabilityPolicy | None = None,
                observability: ObservabilityPolicy | None = None,
                cache_path: str | None = None,
                device=None,
                **cache_overrides: Any) -> "ServingPlan":
        """The one provenance-tracked readback-and-geometry step.

        Reads the tuned page size (``flash_decode_paged``) and
        decode-segment cadence (``paged_segment``) back from the
        autotuner's persisted cache for ``device``'s backend (the card
        unless ``"cpu"``) via
        :func:`repro_torch.kernels.autotune.tile_readback`, then derives
        the pool geometry — ``blocks = ceil(cap / page_size)``,
        ``n_pages = pool_slots * blocks + 1`` (+1: the scratch page).

        ``page_size``/``segment_len`` override the readback (recorded as
        ``explicit``); ``page_size_cap`` bounds a tuned page size by a
        geometric constraint (recorded as ``capped`` when it bites).
        ``pool_slots`` sizes the pool for fewer whole lifetimes than
        ``slots`` (oversubscription).  Extra keyword args pass through to
        :class:`PagedCacheConfig` (``prefill_bucket``, ``growth_pages``,
        ``retain_pages``, ...) and are recorded as ``explicit``.
        """
        from repro_torch.kernels import autotune

        cap = max_prompt_len + max_new_tokens + 1
        adt = getattr(cfg, "adt", None) or "float32"
        prov: dict[str, str] = {}
        if page_size is None:
            prob = autotune.flash_decode_paged_problem(
                slots, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cap, adt)
            tile, src = autotune.tile_readback("flash_decode_paged", prob,
                                               cache_path=cache_path,
                                               device=device)
            page_size, prov["page_size"] = int(tile["page_size"]), src
        else:
            page_size, prov["page_size"] = int(page_size), "explicit"
        if page_size_cap is not None and page_size > page_size_cap:
            page_size, prov["page_size"] = int(page_size_cap), "capped"
        if segment_len is None:
            prob = autotune.paged_segment_problem(
                slots, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cap,
                page_size, adt)
            tile, src = autotune.tile_readback("paged_segment", prob,
                                               cache_path=cache_path,
                                               device=device)
            segment_len, prov["segment_len"] = int(tile["segment_len"]), src
        else:
            segment_len, prov["segment_len"] = int(segment_len), "explicit"
        blocks = -(-cap // page_size)
        pool = slots if pool_slots is None else pool_slots
        cache = PagedCacheConfig(page_size=page_size,
                                 n_pages=pool * blocks + 1,
                                 max_slots=slots, max_blocks=blocks,
                                 segment_len=segment_len,
                                 **cache_overrides)
        for k in cache_overrides:
            prov[k] = "explicit"
        prov["durability"] = "default" if durability is None else "explicit"
        prov["observability"] = \
            "default" if observability is None else "explicit"
        return cls(arch=str(getattr(cfg, "name", "")), cache=cache,
                   prefill_mode=prefill_mode, cache_dtype=cache_dtype,
                   tenants=tuple(tenants or ()), n_replicas=n_replicas,
                   health=health if health is not None else HealthPolicy(),
                   durability=(durability if durability is not None
                               else DurabilityPolicy()),
                   observability=(observability
                                  if observability is not None
                                  else ObservabilityPolicy()),
                   max_prompt_len=max_prompt_len,
                   max_new_tokens=max_new_tokens, provenance=prov)

    # -------------------------------------------------------- (de)serialize
    def to_dict(self) -> dict[str, Any]:
        """JSON-safe dict; the deployable artifact the SERVE task
        emits."""
        return {
            "arch": self.arch,
            "cache": self.cache.to_dict(),
            "prefill_mode": self.prefill_mode,
            "cache_dtype": self.cache_dtype,
            "tenants": [dataclasses.asdict(t) for t in self.tenants],
            "n_replicas": self.n_replicas,
            "health": dataclasses.asdict(self.health),
            "durability": dataclasses.asdict(self.durability),
            "observability": {
                **dataclasses.asdict(self.observability),
                "histogram_buckets":
                    list(self.observability.histogram_buckets)},
            "max_prompt_len": self.max_prompt_len,
            "max_new_tokens": self.max_new_tokens,
            "provenance": dict(self.provenance),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ServingPlan":
        """Inverse of :meth:`to_dict` under PagedCacheConfig's
        checkpoint-compat contract, applied recursively: unknown keys
        are dropped and missing ones take their defaults at every level
        (plan, cache, tenants, health)."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if isinstance(kw.get("cache"), dict):
            kw["cache"] = PagedCacheConfig.from_dict(kw["cache"])
        if "tenants" in kw:
            kw["tenants"] = tuple(
                _filtered(TenantConfig, t) if isinstance(t, dict) else t
                for t in kw["tenants"])
        if isinstance(kw.get("health"), dict):
            kw["health"] = _filtered(HealthPolicy, kw["health"])
        if isinstance(kw.get("durability"), dict):
            kw["durability"] = _filtered(DurabilityPolicy,
                                         kw["durability"])
        if isinstance(kw.get("observability"), dict):
            kw["observability"] = _filtered(ObservabilityPolicy,
                                            kw["observability"])
        if "provenance" in kw:
            kw["provenance"] = dict(kw["provenance"])
        return cls(**kw)
