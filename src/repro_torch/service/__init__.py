"""The community service (port of ``repro/service/``):

* :mod:`repro_torch.service.buckets`   — static ``(n_cap, m_cap)`` size
  buckets, bucket admission and the dense/sort scan crossover;
* :mod:`repro_torch.service.engine`    — the batched engine: detections and
  warm updates of a same-bucket batch, one graph after another;
* :mod:`repro_torch.service.admission` — the front door:
  :class:`ServiceConfig`, bounded per-tenant queues (:class:`QueueFull`)
  and weighted deficit-round-robin batch composition;
* :mod:`repro_torch.service.frontend`  — the futures front end:
  :class:`ServiceFrontend` (the one sync core) and
  :class:`AsyncCommunityService` (an asyncio dispatcher task; submissions
  return awaitable :class:`DetectionFuture`\\ s);
* :mod:`repro_torch.service.store`     — per-graph partitions with
  versioned invalidation, LRU/TTL eviction and the warm update path;
* :mod:`repro_torch.service.service`   — :class:`CommunityService`, the
  thin synchronous pump adapter over the front end;
* :mod:`repro_torch.service.metrics`   — latency/throughput metrics with
  per-tenant breakdowns, mirrored to the :mod:`repro_torch.telemetry` hub;
* :mod:`repro_torch.service.replay`    — the open-loop load-replay
  harness: heavy-tailed sizes, tenant skew, update/detect mixes at a
  configured arrival rate; rate sweeps locate the saturation knee.

Every front end runs on CUDA unless it is given ``device="cpu"``, and
raises when there is no card.  With
``ServiceConfig(timeline_enabled=True)`` every store commit becomes a
snapshot with persistent community ids and lifecycle events
(:mod:`repro_torch.timeline`); ``ServiceConfig`` also installs the
resilience layer (:mod:`repro_torch.resilience`: fault plan, retry,
breaker, degraded tiers, automatic checkpoints).
"""
from repro_torch.core.dynamic import CapacityError, GraphUpdate
from repro_torch.resilience import (
    BreakerConfig, BreakerOpen, DeadlineExceeded, DegradedResult,
    FaultPlan, FaultSpec, RetryPolicy,
)
from repro_torch.service.admission import (
    AdmissionController, DEFAULT_TENANT, PendingRequest, QueueFull,
    ServiceConfig,
)
from repro_torch.service.buckets import (
    DEFAULT_BUCKETS, DEFAULT_DENSE_MIN_DENSITY, Bucket,
    calibrated_min_density, choose_bucket, choose_scan,
)
from repro_torch.service.engine import (
    BatchedLouvainEngine, DetectResult, DispatchInfo, UpdateResult,
)
from repro_torch.service.frontend import (
    AsyncCommunityService, DetectionFuture, ServiceFrontend,
)
from repro_torch.service.metrics import ServiceMetrics, TenantMetrics
from repro_torch.service.replay import ReplayConfig, run_replay, sweep_rates
from repro_torch.service.service import CommunityService
from repro_torch.service.store import (
    CapacityExceeded, OptionsMismatch, ResultStore, StoreEntry, UpdatePlan,
)
from repro_torch.timeline import (
    LifecycleEvent, TimelineManager, WindowedIngest,
)

__all__ = [
    "AdmissionController",
    "AsyncCommunityService",
    "BatchedLouvainEngine",
    "BreakerConfig",
    "BreakerOpen",
    "Bucket",
    "CapacityError",
    "CapacityExceeded",
    "CommunityService",
    "DEFAULT_BUCKETS",
    "DEFAULT_DENSE_MIN_DENSITY",
    "DEFAULT_TENANT",
    "DeadlineExceeded",
    "DegradedResult",
    "DetectResult",
    "DetectionFuture",
    "DispatchInfo",
    "FaultPlan",
    "FaultSpec",
    "GraphUpdate",
    "LifecycleEvent",
    "OptionsMismatch",
    "PendingRequest",
    "QueueFull",
    "ReplayConfig",
    "ResultStore",
    "RetryPolicy",
    "ServiceConfig",
    "ServiceFrontend",
    "ServiceMetrics",
    "StoreEntry",
    "TenantMetrics",
    "TimelineManager",
    "UpdatePlan",
    "UpdateResult",
    "WindowedIngest",
    "calibrated_min_density",
    "choose_bucket",
    "choose_scan",
    "run_replay",
    "sweep_rates",
]
