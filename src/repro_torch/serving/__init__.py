"""Serving subsystem: paged KV-cache pool + continuous-batching engine
under a quota-aware preemptive resource manager (PyTorch port).

- paged_cache: page pool, refcounted free-list allocator, block tables
  and the prefix-sharing trie (PrefixCache); the tuned page size and
  segment cadence read back from the autotuner
  (``preferred_page_size``, ``preferred_segment_len``).
- resources / scheduler: growth-on-demand paging, host-swap preemption,
  per-tenant budgets with deficit-round-robin admission.
- engine: batched ragged admission prefill + fixed-length decode
  segments over the paged pool, host swap-out and one-scatter restore,
  and the write-ahead journal's hooks in the boundary protocol.
- faults / recovery: seeded fault injection and request-level
  self-healing (checkpoints, quarantine, retries, dead letters).
- cluster: N EngineRun replicas of one engine behind a prefix-affinity
  FrontDoor, a boundary-heartbeat health model, failover through
  verified host swap images, drain/rejoin, typed ReplicaLost dead
  letters and per-replica journals.
- plan: the ServingPlan deployment artifact and ``ServingPlan.resolve``,
  the provenance-tracked readback of the tuned knobs.
- journal: the CRC-framed write-ahead request journal (JournalWriter),
  torn-tail-tolerant replay (replay_journal) and crash-restart recovery
  (RestartRecovery), with the process-level fault sites.
- traffic: seeded TrafficProfile workloads and the replay scorer the
  SERVE design-flow task (tasks/serve.py) searches plans with.
- observe: metrics registry, request-lifecycle tracer, exporters.
"""

from repro_torch.serving.paged_cache import (AllocatorError, PageAllocator,
                                             PagedCacheConfig, PrefixCache,
                                             PrefixMatch, TRASH_PAGE,
                                             init_paged_cache,
                                             preferred_page_size,
                                             preferred_segment_len,
                                             supports_paging)
from repro_torch.serving.plan import (DurabilityPolicy, HealthPolicy,
                                      ObservabilityPolicy, ServingPlan)
from repro_torch.serving.observe import (MetricsRegistry, NULL_METRIC,
                                         Observability, Tracer,
                                         exponential_buckets,
                                         render_summary)
from repro_torch.serving.traffic import (TrafficProfile, make_replay_scorer,
                                         replay)
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
from repro_torch.serving.cluster import (FrontDoor, Replica, ReplicaLost,
                                         ServingCluster)
from repro_torch.serving.journal import (JOURNAL_VERSION, JournalError,
                                         JournalReplay, JournalWriter,
                                         ReplayedRequest, RestartRecovery,
                                         read_records, replay_journal)

__all__ = [
    "AllocatorError", "PageAllocator", "PagedCacheConfig", "PrefixCache",
    "PrefixMatch", "TRASH_PAGE", "init_paged_cache", "supports_paging",
    "preferred_page_size", "preferred_segment_len",
    "DurabilityPolicy", "HealthPolicy", "ObservabilityPolicy",
    "ServingPlan",
    "MetricsRegistry", "NULL_METRIC", "Observability", "Tracer",
    "exponential_buckets", "render_summary",
    "TrafficProfile", "make_replay_scorer", "replay",
    "ENGINE_SITES", "FAULT_SITES", "PROCESS_SITES", "REPLICA_SITES",
    "FaultPlan", "FaultSpec", "InjectedFault", "ProcessCrashed",
    "EngineStalledError", "RecoveryManager", "RecoveryPolicy",
    "RequestFailed", "diagnostic_snapshot",
    "DEFAULT_TENANT", "ResourceManager", "SwapState", "TenantConfig",
    "ContinuousBatchingScheduler", "Request",
    "EngineRun", "PagedServingEngine", "warmup",
    "FrontDoor", "Replica", "ReplicaLost", "ServingCluster",
    "JOURNAL_VERSION", "JournalError", "JournalReplay", "JournalWriter",
    "ReplayedRequest", "RestartRecovery", "read_records",
    "replay_journal",
]
