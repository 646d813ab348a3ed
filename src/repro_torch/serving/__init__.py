"""Serving subsystem: paged KV-cache pool + continuous-batching engine
under a quota-aware preemptive resource manager (PyTorch port).

- paged_cache: page pool, refcounted free-list allocator, block tables
  and the prefix-sharing trie (PrefixCache).
- resources / scheduler: growth-on-demand paging, host-swap preemption,
  per-tenant budgets with deficit-round-robin admission.
- engine: batched ragged admission prefill + fixed-length decode
  segments over the paged pool, host swap-out and one-scatter restore.
- faults / recovery: seeded fault injection and request-level
  self-healing (checkpoints, quarantine, retries, dead letters).
- plan: the ServingPlan deployment artifact.
- observe: metrics registry, request-lifecycle tracer, exporters.

Not ported yet: the cluster, the write-ahead journal, traffic replay and
the autotuner readbacks (``preferred_page_size``,
``preferred_segment_len``, ``ServingPlan.resolve``).
"""

from repro_torch.serving.paged_cache import (AllocatorError, PageAllocator,
                                             PagedCacheConfig, PrefixCache,
                                             PrefixMatch, TRASH_PAGE,
                                             init_paged_cache,
                                             supports_paging)
from repro_torch.serving.plan import (DurabilityPolicy, HealthPolicy,
                                      ObservabilityPolicy, ServingPlan)
from repro_torch.serving.observe import (MetricsRegistry, NULL_METRIC,
                                         Observability, Tracer,
                                         exponential_buckets,
                                         render_summary)
from repro_torch.serving.faults import (ENGINE_SITES, FAULT_SITES,
                                        PROCESS_SITES, REPLICA_SITES,
                                        FaultPlan, FaultSpec, InjectedFault,
                                        ProcessCrashed)
from repro_torch.serving.recovery import (EngineStalledError,
                                          RecoveryManager, RecoveryPolicy,
                                          RequestFailed, diagnostic_snapshot)
from repro_torch.serving.resources import (DEFAULT_TENANT, ResourceManager,
                                           SwapState, TenantConfig)
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           Request)
from repro_torch.serving.engine import (EngineRun, PagedServingEngine,
                                        warmup)

__all__ = [
    "AllocatorError", "PageAllocator", "PagedCacheConfig", "PrefixCache",
    "PrefixMatch", "TRASH_PAGE", "init_paged_cache", "supports_paging",
    "DurabilityPolicy", "HealthPolicy", "ObservabilityPolicy",
    "ServingPlan",
    "MetricsRegistry", "NULL_METRIC", "Observability", "Tracer",
    "exponential_buckets", "render_summary",
    "ENGINE_SITES", "FAULT_SITES", "PROCESS_SITES", "REPLICA_SITES",
    "FaultPlan", "FaultSpec", "InjectedFault", "ProcessCrashed",
    "EngineStalledError", "RecoveryManager", "RecoveryPolicy",
    "RequestFailed", "diagnostic_snapshot",
    "DEFAULT_TENANT", "ResourceManager", "SwapState", "TenantConfig",
    "ContinuousBatchingScheduler", "Request",
    "EngineRun", "PagedServingEngine", "warmup",
]
