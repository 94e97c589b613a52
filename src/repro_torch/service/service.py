"""Synchronous adapter over the futures front end (port of
``repro/service/service.py``).

``CommunityService`` keeps the pump-model API (``submit_detect`` ->
req id, ``submit_update`` -> bool, ``pump()``/``drain()``) as a
thin facade over :class:`repro_torch.service.frontend.ServiceFrontend` — the
same admission control, DRR fairness, monotonic request ids, store
eviction, and metrics the async front end uses.  One code path, no
behavior fork.

Migration (sync pump -> futures):

    # before                              # after
    svc.submit_detect(gid, g)             fut = await svc.submit_detect(
    svc.pump(); svc.drain()                   gid, g, tenant="alice")
    entry = svc.result(gid)               entry = await fut

New code should use
:class:`repro_torch.service.frontend.AsyncCommunityService`; this adapter
exists so embedders without an event loop keep a one-thread,
caller-pumped service.  The adapter inherits the front end's per-tenant
queue bound: callers that submit more than ``max_pending_per_tenant``
requests without pumping see
:class:`repro_torch.service.admission.QueueFull` instead of unbounded
memory growth.

It runs on CUDA unless given ``device="cpu"`` (``device=None`` raises
when there is no card).  ``sub_batch`` is the engine's tile width, as in
the reference.  The reference's ``dense_max_nv`` keyword has no
counterpart: the dense crossover is ``DetectOptions(dense_max_nv=...)``
inside ``config=ServiceConfig(detect=...)``, and passing it is Python's
own ``TypeError``.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.api import DetectOptions
from repro_torch.core.louvain import LouvainConfig
from repro_torch.graph.container import Graph
from repro_torch.service.admission import (
    DEFAULT_TENANT, QueueFull, ServiceConfig,
)
from repro_torch.service.buckets import Bucket, DEFAULT_BUCKETS
from repro_torch.service.frontend import DetectionFuture, ServiceFrontend
from repro_torch.service.metrics import ServiceMetrics, percentile  # re-export


class CommunityService:
    """Thin sync facade: every call funnels into ServiceFrontend."""

    def __init__(self, cfg: LouvainConfig = LouvainConfig(), *,
                 config: Optional[ServiceConfig] = None,
                 buckets: Sequence[Bucket] = DEFAULT_BUCKETS,
                 batch_size: int = 32, max_delay_s: float = 0.05,
                 sub_batch: Optional[int] = None,
                 clock=None, device=None):
        """Either pass a full ``config=ServiceConfig(...)`` or the plain
        keywords (which build one); ``config`` wins when both are given.
        ``device`` is where the service runs (``None`` = CUDA)."""
        if config is None:
            config = ServiceConfig(
                detect=DetectOptions(louvain=cfg), buckets=tuple(buckets),
                batch_size=batch_size, max_delay_s=max_delay_s,
                sub_batch=sub_batch)
        self.frontend = ServiceFrontend(config, clock=clock, device=device)

    # -- delegation --------------------------------------------------------
    @property
    def config(self) -> ServiceConfig:
        return self.frontend.config

    @property
    def engine(self):
        return self.frontend.engine

    @property
    def store(self):
        return self.frontend.store

    @property
    def metrics(self) -> ServiceMetrics:
        return self.frontend.metrics

    @property
    def admission(self):
        return self.frontend.admission

    @property
    def telemetry(self):
        return self.frontend.telemetry

    @property
    def clock(self):
        return self.frontend.clock

    def close(self):
        """Stop the telemetry exporter/sinks (no-op when none attached)."""
        self.frontend.close()

    # -- request entry points ---------------------------------------------
    def submit_detect(self, graph_id: str, graph: Graph, *,
                      tenant: str = DEFAULT_TENANT, priority: int = 0,
                      deadline_s: Optional[float] = None,
                      algorithm: Optional[str] = None) -> str:
        """Queue a detection request; returns the (monotonic) request id.
        ``algorithm`` pins a portfolio tier ('fast' | 'standard' |
        'max-quality'); None resolves through the config's tier rules.
        Raises :class:`QueueFull` at the tenant's queue bound."""
        fut = self.frontend.submit_detect(
            graph_id, graph, tenant=tenant, priority=priority,
            deadline_s=deadline_s, algorithm=algorithm)
        return fut.req_id

    def submit_update(self, graph_id: str, updates, *,
                      tenant: str = DEFAULT_TENANT) -> bool:
        """Route an edge batch of signed weight-deltas to the warm path.

        Immediate with ``update_batch_size == 1`` (the default); queued
        for the batched warm path otherwise (``pump``/``drain``
        dispatches it).  Returns True if routed warm; False if the entry
        had to be re-bucketed immediately (a fresh detect request was
        queued with the updated edge set).  Raises KeyError for unknown
        graph ids.
        """
        return self.frontend.submit_update(
            graph_id, updates, tenant=tenant).kind == "update"

    def detect(self, graph_id: str, graph: Graph, *,
               tenant: str = DEFAULT_TENANT,
               algorithm: Optional[str] = None) -> DetectionFuture:
        """Futures variant of ``submit_detect`` for sync callers that want
        the handle; pump/drain still drives dispatch."""
        return self.frontend.submit_detect(graph_id, graph, tenant=tenant,
                                           algorithm=algorithm)

    # -- dispatch ---------------------------------------------------------
    def pump(self, *, force: bool = False) -> int:
        """Dispatch every ready batch; returns the number of served
        detect requests."""
        return self.frontend.dispatch(force=force)

    def drain(self) -> int:
        """Flush every queue regardless of batch fill / deadlines."""
        return self.frontend.drain()

    def result(self, graph_id: str):
        return self.frontend.result(graph_id)

    def pending(self, tenant: Optional[str] = None) -> int:
        return self.frontend.pending(tenant)

    # -- temporal tracking (requires ServiceConfig(timeline_enabled=True))
    @property
    def timelines(self):
        return self.frontend.timelines

    def ingest_window(self, graph_id: str, events, *,
                      t: Optional[float] = None,
                      tenant: str = DEFAULT_TENANT) -> DetectionFuture:
        """Fold one window of external-id graph events into one snapshot
        (see :meth:`repro_torch.service.frontend.ServiceFrontend.
        ingest_window`;
        the sync adapter pumps a re-bucketed window itself)."""
        return self.frontend.ingest_window(graph_id, events, t=t,
                                           tenant=tenant, wait=True)

    def membership_at(self, graph_id: str, external: int,
                      t: Optional[float] = None) -> Optional[int]:
        return self.frontend.membership_at(graph_id, external, t)

    def community_timeline(self, community_id: int):
        return self.frontend.community_timeline(community_id)

    def lifecycle_events(self, graph_id: Optional[str] = None, *,
                         kind: Optional[str] = None):
        return self.frontend.lifecycle_events(graph_id, kind=kind)

    def timeline_snapshots(self, graph_id: str):
        return self.frontend.timeline_snapshots(graph_id)

    def subscribe_lifecycle(self, fn):
        return self.frontend.subscribe_lifecycle(fn)

    def unsubscribe_lifecycle(self, fn) -> bool:
        return self.frontend.unsubscribe_lifecycle(fn)
