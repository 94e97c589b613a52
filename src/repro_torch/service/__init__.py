"""The community service's batch layer (port of ``repro/service/``):

* :mod:`repro_torch.service.buckets`   — static ``(n_cap, m_cap)`` size
  buckets, bucket admission and the dense/sort scan crossover;
* :mod:`repro_torch.service.engine`    — the batched engine: detections and
  warm updates of a same-bucket batch, one graph after another;
* :mod:`repro_torch.service.admission` — bounded per-tenant queues (:class:`QueueFull`) and weighted deficit-round-robin
  batch composition;
* :mod:`repro_torch.service.store`     — per-graph partitions with
  versioned invalidation, LRU/TTL eviction and the warm update path;
* :mod:`repro_torch.service.metrics`   — latency/throughput metrics with
  per-tenant breakdowns, mirrored to the :mod:`repro_torch.telemetry` hub.

The front end and ``ServiceConfig``, which only the front end reads, the
sync service and the replay harness, and the resilience and timeline
packages they use, come later (ROADMAP queue A, items 10 and 11).
"""
from repro_torch.core.dynamic import CapacityError, GraphUpdate
from repro_torch.service.admission import (
    AdmissionController, DEFAULT_TENANT, PendingRequest, QueueFull,
)
from repro_torch.service.buckets import (
    DEFAULT_BUCKETS, DEFAULT_DENSE_MIN_DENSITY, Bucket,
    calibrated_min_density, choose_bucket, choose_scan,
)
from repro_torch.service.engine import (
    BatchedLouvainEngine, DetectResult, DispatchInfo, UpdateResult,
)
from repro_torch.service.metrics import ServiceMetrics, TenantMetrics
from repro_torch.service.store import (
    CapacityExceeded, OptionsMismatch, ResultStore, StoreEntry, UpdatePlan,
)

__all__ = [
    "AdmissionController",
    "BatchedLouvainEngine",
    "Bucket",
    "CapacityError",
    "CapacityExceeded",
    "DEFAULT_BUCKETS",
    "DEFAULT_DENSE_MIN_DENSITY",
    "DEFAULT_TENANT",
    "DetectResult",
    "DispatchInfo",
    "GraphUpdate",
    "OptionsMismatch",
    "PendingRequest",
    "QueueFull",
    "ResultStore",
    "ServiceMetrics",
    "StoreEntry",
    "TenantMetrics",
    "UpdatePlan",
    "UpdateResult",
    "calibrated_min_density",
    "choose_bucket",
    "choose_scan",
]
