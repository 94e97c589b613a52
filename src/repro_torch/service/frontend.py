"""Futures-based service front end: tenants, admission, dispatch (port of
``repro/service/frontend.py``).

Two layers, ONE code path:

* :class:`ServiceFrontend` — the synchronous core.  ``submit_detect`` /
  ``submit_update`` take a tenant id plus optional priority/deadline and
  return a :class:`DetectionFuture`; ``collect()`` composes ready bucket
  batches by weighted DRR (:mod:`repro_torch.service.admission`);
  ``execute()`` runs the batched engine, writes the store, and resolves
  futures.  Everything the sync adapter
  (:class:`repro_torch.service.service.CommunityService`) and the async
  front end do funnels through these methods — there is no behavior fork
  between the two.

  Updates are fully dynamic in edges AND vertices
  (:class:`repro_torch.core.dynamic.GraphUpdate`: signed weight-deltas,
  deletions free capacity, vertex removals compact ids, additions claim
  padding slots) and, with ``ServiceConfig.update_batch_size > 1``, are
  **batched like detections**: submissions queue per bucket, compose into
  batches (full, stale past ``update_max_delay_s``, or forced), fold
  same-graph batches in submit order (batch-wise, so deletion clamping
  and vertex-id remaps behave exactly as if each batch had been applied
  immediately), and dispatch through the engine's batched warm path
  (:meth:`repro_torch.service.engine.BatchedLouvainEngine.update_batch`,
  each graph through the immediate path's ``warm_update``) — identical
  partitions to the immediate per-call path.  Updates never count against
  the tenant queue bound (like the rebucket continuation, a queued update
  references store state that a drop would strand).
* :class:`AsyncCommunityService` — the asyncio front end: a dispatcher
  task wakes on submissions (or a poll tick for deadline/max-delay
  flushes), offloads engine/update compute to a single-worker executor so
  the event loop keeps accepting traffic, and implements backpressure as
  either ``QueueFull`` rejection (``block=False``) or await-until-slot
  (``block=True``).

Where it runs: each front end resolves one device at construction
(``device=None`` means CUDA, and raises when there is none; pass
``device="cpu"`` for the CPU) and hands it to the engine and the store,
which hands it on to the degraded tier's ``lpa_result``.  A submitted
graph is moved there once (:meth:`Graph.to`), and a graph the front end
rebuilds (the re-bucketing fallback) stays on the device of the graph it
came from.  Nothing falls back to the CPU.

Thread discipline: admission is internally locked; all device compute and
store writes run on the one compute thread (the caller's for the sync
core, the single-worker executor's for the async front end), whose
current CUDA stream is the device's default stream, so every kernel the
service launches is ordered on that one stream.  The auto-checkpointer's
thread reads only entries the store has committed (under the store's
lock), and its copies to the host queue on that same default stream,
behind the work that produced the entry.  Futures are
``concurrent.futures``-backed so resolution is thread-safe and awaitable
from any running loop.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import itertools
import threading
import time
from collections import OrderedDict
from functools import partial
from typing import Dict, List, Optional, Tuple

from repro_torch.core.dynamic import (
    GraphUpdate, as_update, check_vertex_ids, directed_deltas,
    merge_edge_deltas, rebuild_with_vertex_ops,
)
from repro_torch.device import resolve_device
from repro_torch.graph.container import Graph, from_coo
from repro_torch.resilience.autockpt import AutoCheckpointer
from repro_torch.resilience.breaker import BreakerOpen
from repro_torch.resilience.faults import FaultySink
from repro_torch.resilience.manager import ResilienceManager
from repro_torch.resilience.policy import DeadlineExceeded
from repro_torch.service.admission import (
    DEFAULT_TENANT, AdmissionController, PendingRequest, QueueFull,
    ServiceConfig,
)
from repro_torch.service.buckets import Bucket, admit, live_edges
from repro_torch.service.engine import BatchedLouvainEngine, DispatchInfo
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.store import (
    CapacityExceeded, OptionsMismatch, ResultStore,
)
from repro_torch.telemetry.prometheus import MetricsExporter
from repro_torch.telemetry.sinks import InMemorySink, JsonlSink, Telemetry
from repro_torch.telemetry.spans import RequestTrace
from repro_torch.timeline.tracker import (
    TimelineConfig, TimelineManager, translate_window,
)


class DetectionFuture:
    """Awaitable handle for a submitted request.

    Wraps a :class:`concurrent.futures.Future` so one object serves both
    worlds: ``result()`` blocks a sync caller, ``await fut`` suspends a
    coroutine on any running loop, and the dispatcher resolves it from
    whatever thread ran the engine.  Resolves to the
    :class:`repro_torch.service.store.StoreEntry` written for the request (or
    raises the engine's exception).  ``kind`` is ``"detect"`` for queued
    detections (including re-bucketed updates) and ``"update"`` for
    warm-path updates, which resolve immediately.

    ``trace`` is the request's
    :class:`repro_torch.telemetry.spans.RequestTrace`
    (trace id == request id): per-phase spans accumulate as the request
    moves through the service and the completed trace is broadcast to
    the telemetry sinks at resolve time.
    """

    __slots__ = ("req_id", "tenant", "graph_id", "kind", "t_submit",
                 "trace", "_fut")

    def __init__(self, req_id: str, tenant: str, graph_id: str, kind: str,
                 t_submit: float, trace: Optional[RequestTrace] = None):
        self.req_id = req_id
        self.tenant = tenant
        self.graph_id = graph_id
        self.kind = kind
        self.t_submit = t_submit
        self.trace = trace
        self._fut: concurrent.futures.Future = concurrent.futures.Future()

    # caller side
    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: Optional[float] = None):
        return self._fut.result(timeout)

    def exception(self, timeout: Optional[float] = None):
        return self._fut.exception(timeout)

    def add_done_callback(self, fn):
        self._fut.add_done_callback(lambda _: fn(self))

    def __await__(self):
        return asyncio.wrap_future(self._fut).__await__()

    # dispatcher side
    def set_result(self, entry):
        self._fut.set_result(entry)

    def set_exception(self, exc: BaseException):
        self._fut.set_exception(exc)

    def cancel(self) -> bool:
        return self._fut.cancel()

    def __repr__(self):
        state = "done" if self.done() else "pending"
        return (f"DetectionFuture({self.req_id!r}, tenant={self.tenant!r}, "
                f"kind={self.kind}, {state})")


@dataclasses.dataclass
class UpdateRequest:
    """A queued warm-update awaiting batched dispatch (the batch is
    folded with same-graph predecessors, in submit order, at compose
    time)."""

    graph_id: str
    tenant: str
    upd: GraphUpdate             # vertex ops + signed edge weight-deltas
    t_submit: float
    future: DetectionFuture


# ("detect", bucket, [PendingRequest]) or ("update", bucket, [UpdateRequest])
Batch = Tuple[str, Bucket, list]


class ServiceFrontend:
    """The synchronous core every service entry point funnels through."""

    def __init__(self, config: Optional[ServiceConfig] = None, *, clock=None,
                 device=None):
        self.config = config or ServiceConfig()
        c = self.config
        # resolved before any thread or socket starts: no CUDA and no
        # device= raises here
        self.device = resolve_device(device)
        self.clock = clock or time.perf_counter
        # telemetry hub + built-in sinks per config; the hub exists even
        # disabled (emission early-outs on the empty sink tuple)
        self.telemetry = Telemetry()
        self.mem_sink: Optional[InMemorySink] = None
        self.exporter: Optional[MetricsExporter] = None
        if c.telemetry_enabled:
            self.mem_sink = self.telemetry.register(InMemorySink())
        if c.telemetry_jsonl:
            self.telemetry.register(JsonlSink(c.telemetry_jsonl))
        if c.exporter_port is not None:
            self.exporter = MetricsExporter(self.mem_sink,
                                            port=c.exporter_port)
        self.engine = BatchedLouvainEngine(
            options=c.detect, sub_batch=c.sub_batch,
            telemetry=self.telemetry, profile_dir=c.profile_dir,
            faults=c.fault_plan, algorithms=c.serve_algorithms,
            device=self.device)
        self.admission = AdmissionController(
            c.buckets, batch_size=c.batch_size, max_delay_s=c.max_delay_s,
            max_pending_per_tenant=c.max_pending_per_tenant,
            weights=dict(c.tenant_weights), clock=self.clock)
        # temporal tracking: the TimelineManager observes every store
        # commit (fresh detects, warm updates, compaction flushes) through
        # the on_commit hook — one snapshot per committed partition
        self.timelines: Optional[TimelineManager] = None
        if c.timeline_enabled:
            self.timelines = TimelineManager(
                TimelineConfig(
                    jaccard_min=c.timeline_jaccard_min,
                    weight_by_degree=c.timeline_weight_by_degree,
                    max_snapshots=c.timeline_max_snapshots,
                    max_events=c.timeline_max_events,
                    max_rows=c.timeline_max_rows,
                    max_communities=c.timeline_max_communities),
                telemetry=self.telemetry)
        self.store = ResultStore(
            options=c.detect,
            max_entries=c.store_max_entries, ttl_s=c.store_ttl_s,
            clock=self.clock,
            compact_window=c.compact_window,
            on_commit=(self._on_store_commit
                       if (c.timeline_enabled or c.autockpt_dir is not None)
                       else None),
            on_evict=(self._on_store_evict
                      if c.autockpt_dir is not None else None),
            device=self.device)
        self.metrics = ServiceMetrics(telemetry=self.telemetry)
        # resilience: fault plan / retry policy / breaker board / degraded
        # tier behind one manager with zero-overhead fast paths when off
        self.resilience = ResilienceManager(
            c, telemetry=self.telemetry, metrics=self.metrics,
            clock=self.clock)
        if c.fault_plan is not None and \
                "telemetry.sink" in c.fault_plan.seams:
            self.telemetry.register(FaultySink(c.fault_plan))
        # automatic checkpointing + startup recovery (ROADMAP carried
        # item): recover the newest readable snapshot BEFORE the
        # background thread starts writing new ones
        self.autockpt: Optional[AutoCheckpointer] = None
        self.restored_step: Optional[int] = None
        if c.autockpt_dir is not None:
            self.autockpt = AutoCheckpointer(
                self, ckpt_dir=c.autockpt_dir,
                period_s=c.autockpt_period_s,
                dirty_threshold=c.autockpt_dirty,
                keep=c.autockpt_keep, writeback=c.autockpt_writeback,
                faults=c.fault_plan, telemetry=self.telemetry)
            if c.autockpt_recover:
                self.restored_step = self.autockpt.recover()
            self.autockpt.start()
        # monotonic request ids: never reuses after a dispatch (the old
        # n_detect + pending() scheme collided once requests were served)
        self._seq = itertools.count()
        # queued warm updates per bucket (update_batch_size > 1); guarded
        # by its own lock — the async path submits from the event loop
        # while the compute thread collects
        self._updates: Dict[Bucket, List[UpdateRequest]] = {}
        self._upd_lock = threading.Lock()

    # -- request entry points ---------------------------------------------
    def submit_detect(self, graph_id: str, graph: Graph, *,
                      tenant: str = DEFAULT_TENANT, priority: int = 0,
                      deadline_s: Optional[float] = None,
                      algorithm: Optional[str] = None,
                      count_reject: bool = True,
                      exempt_bound: bool = False) -> DetectionFuture:
        """Queue a detection; returns a future resolving to the store
        entry.  Raises ValueError when no bucket fits and
        :class:`QueueFull` at the tenant's bound (counted per tenant
        unless ``count_reject=False`` — the async await-until-slot path
        retries, and a blocked-then-served request is not a rejection).
        ``algorithm`` pins the request to a portfolio tier; when None the
        tier resolves through :meth:`ServiceConfig.tier_for` (tenant pin,
        then deadline auto-select, then the config default).
        ``exempt_bound`` is for internal continuations that must not be
        droppable (see :meth:`submit_update`'s rebucket path)."""
        t0 = self.clock()
        # resolve the quality tier up front: the tier is part of the
        # request's batching identity (requests only compose with same-
        # tier peers) and is stamped on the trace + the store entry
        tier = self.config.tier_for(tenant=tenant, deadline_s=deadline_s,
                                    algorithm=algorithm)
        # an already-expired deadline fails fast at the front door: the
        # work's future could never be used, so don't repad or queue it
        if deadline_s is not None and float(deadline_s) <= 0.0:
            self.metrics.deadline_reject(tenant)
            raise DeadlineExceeded(
                f"deadline_s={deadline_s} already expired at submit for "
                f"{graph_id!r}")
        # advisory bound pre-check: the authoritative (locked) check is in
        # admission.submit, but overload is exactly when rejections fire,
        # and a rejected request should not pay the bucket repad first
        if (not exempt_bound and self.admission.pending(tenant)
                >= self.config.max_pending_per_tenant):
            if count_reject:
                self.metrics.reject(tenant)
            raise QueueFull(
                f"tenant {tenant!r} is at its pending bound "
                f"({self.config.max_pending_per_tenant})")
        rid = f"d{next(self._seq)}-{graph_id}"
        trace = RequestTrace(rid, tenant=tenant, kind="detect",
                             clock=self.clock)
        t_r0 = self.clock()
        padded, bucket = admit(graph.to(self.device), self.config.buckets)
        t_r1 = self.clock()
        trace.mark("submit", t0, t_r0)
        trace.mark("repad", t_r0, t_r1)
        fut = DetectionFuture(rid, tenant, graph_id, "detect", t0,
                              trace=trace)
        req = PendingRequest(
            req_id=fut.req_id, tenant=tenant, graph_id=graph_id,
            graph=padded, bucket=bucket, priority=priority, t_submit=t0,
            deadline=None if deadline_s is None else t0 + float(deadline_s),
            algorithm=tier, future=fut)
        try:
            with trace.span("admission"):
                self.admission.submit(req, exempt_bound=exempt_bound)
        except QueueFull:
            if count_reject:
                self.metrics.reject(tenant)
            raise
        return fut

    def submit_update(self, graph_id: str, updates, *,
                      tenant: str = DEFAULT_TENANT) -> DetectionFuture:
        """Route an update batch to the warm path.

        ``updates``: a :class:`repro_torch.core.dynamic.GraphUpdate` — vertex
        removals/additions plus signed edge weight-deltas — or a bare
        ``(u, v, dw)`` tuple (edges only).  With
        ``update_batch_size == 1`` (default) the update is applied
        immediately: returns an already-resolved ``kind="update"`` future,
        or — when the update overflows its bucket (edge slots or vertex
        capacity) — the pending ``kind="detect"`` future of the
        re-bucketed request.  With ``update_batch_size > 1`` the update
        is queued for the batched warm path and the returned
        ``kind="update"`` future resolves at dispatch (a dispatch-time
        overflow chains the future to the re-bucketed detect).  Raises
        KeyError for unknown (or evicted/expired) graph ids and
        ValueError for statically-malformed batches.
        """
        t0 = self.clock()
        rid = f"u{next(self._seq)}-{graph_id}"
        trace = RequestTrace(rid, tenant=tenant, kind="update",
                             clock=self.clock)
        upd = as_update(updates)     # static validation at the front door
        entry = self.store.get(graph_id)
        if entry is None:
            raise KeyError(f"no stored partition for {graph_id!r}")
        trace.mark("submit", t0, self.clock())
        if self.config.update_batch_size > 1:
            fut = DetectionFuture(rid, tenant, graph_id, "update", t0,
                                  trace=trace)
            with self._upd_lock:
                self._updates.setdefault(entry.bucket, []).append(
                    UpdateRequest(graph_id=graph_id, tenant=tenant,
                                  upd=upd, t_submit=t0, future=fut))
            return fut
        n_del0 = self.store.n_deletions
        n_va0 = self.store.n_vertex_added
        n_vr0 = self.store.n_vertex_removed
        try:
            new = self.store.apply_update(graph_id, upd, trace=trace)
        except CapacityExceeded as ce:
            # Deferred compaction keeps the entry on a capacity overflow
            # (the store did NOT invalidate): a re-bucketing rebuild would
            # replay tombstone-space ids against a compacted graph, so the
            # overflow is surfaced instead — flush_compaction + retry, or
            # grow the bucket ladder.  A cross-tier OptionsMismatch is
            # different: the store DID invalidate (before any fold), so
            # the re-detect continuation is the only way forward.
            if self.config.compact_window and \
                    not isinstance(ce, OptionsMismatch):
                raise
            # rebuild the updated graph at full precision and re-detect.
            # The old entry is already invalidated, so this continuation
            # is exempt from the tenant queue bound: a QueueFull here
            # would lose the graph's result with nothing queued to
            # replace it.
            g = _graph_with_updates(entry.graph, [upd])
            if self.timelines is not None:
                # let the timeline track external ids THROUGH the rebuild:
                # the fresh detect's commit carries no UpdatePlan, so the
                # composed old->new map is registered out of band
                self.timelines.register_rebucket(
                    graph_id, [upd], int(entry.graph.n_nodes))
            self.metrics.n_rebucketed += 1
            return self.submit_detect(graph_id, g, tenant=tenant,
                                      exempt_bound=True)
        now = self.clock()
        self.metrics.observe("update", now - t0, now, tenant=tenant)
        self.metrics.edges_processed += float(live_edges(new.graph))
        self.metrics.n_deletions += self.store.n_deletions - n_del0
        self.metrics.n_vertex_added += self.store.n_vertex_added - n_va0
        self.metrics.n_vertex_removed += (self.store.n_vertex_removed
                                          - n_vr0)
        fut = DetectionFuture(rid, tenant, graph_id, "update", t0,
                              trace=trace)
        trace.mark("resolve", now, self.clock())
        self.telemetry.trace(trace)
        fut.set_result(new)
        return fut

    # -- temporal tracking -------------------------------------------------
    def _on_store_commit(self, graph_id: str, entry, plan) -> None:
        """ResultStore commit hook (fires outside the store lock):
        timelines snapshot the partition, the auto-checkpointer counts it
        toward the dirty threshold."""
        if self.timelines is not None:
            self.timelines.observe_commit(graph_id, entry, plan)
        ck = getattr(self, "autockpt", None)
        if ck is not None:
            ck.note_commit(graph_id)

    def _on_store_evict(self, graph_id: str, entry) -> None:
        """ResultStore LRU-eviction hook: buffer the still-warm entry for
        write-back into the next automatic snapshot."""
        ck = getattr(self, "autockpt", None)
        if ck is not None:
            ck.note_evicted(graph_id, entry)

    def _require_timelines(self) -> TimelineManager:
        if self.timelines is None:
            raise RuntimeError(
                "temporal tracking is disabled; construct the service with "
                "ServiceConfig(timeline_enabled=True)")
        return self.timelines

    def ingest_window(self, graph_id: str, events, *, t: Optional[float] =
                      None, tenant: str = DEFAULT_TENANT,
                      wait: bool = True) -> DetectionFuture:
        """Fold one window of external-id graph events into ONE warm
        update -> ONE snapshot.

        ``events``: :class:`repro_torch.data.streams.GraphEvent` records
        (any iterable; set-semantics vertex folding, net-delta edge folding
        — see :func:`repro_torch.timeline.translate_window`).  ``t``
        stamps the snapshot with the window-end event time (wall clock
        otherwise).
        Requires ``timeline_enabled`` and ``update_batch_size == 1`` (a
        wider update batch would fold several windows into one snapshot).

        Returns the update's future.  When the window overflows into a
        re-bucketed detect (``compact_window == 0`` only), ``wait=True``
        pumps the dispatcher until it resolves — callers that run their
        own dispatcher (the async service) pass ``wait=False`` and await
        the future instead.
        """
        tl = self._require_timelines()
        if self.config.update_batch_size != 1:
            raise RuntimeError(
                "ingest_window requires update_batch_size == 1 so each "
                "window commits as its own snapshot; got "
                f"{self.config.update_batch_size}")
        t0 = self.clock()
        entry = self.store.get(graph_id)
        if entry is None:
            raise KeyError(f"no stored partition for {graph_id!r} — "
                           "submit_detect the base graph first")
        idmap = tl.ensure_track(graph_id, int(entry.graph.n_nodes))
        upd, stats = translate_window(
            events, idmap=idmap, entry=entry,
            compact_window=self.config.compact_window)
        if self.telemetry.enabled:
            self.telemetry.counter("stream_events_ingested",
                                   stats["n_events"])
            dropped = stats["dropped_edges"] + stats["dropped_vertices"]
            if dropped:
                self.telemetry.counter("stream_events_dropped", dropped)
        tl.set_time(graph_id, t)
        if stats["adds_ext"]:
            tl.register_pending_adds(graph_id, stats["adds_ext"])
        fut = self.submit_update(graph_id, upd, tenant=tenant)
        # stream lag: window close -> snapshot committed (both clocks
        # ours, so the histogram is monotone even under event-time t)
        fut.add_done_callback(
            lambda _f: self.telemetry.observe(
                "stream_lag_seconds", max(self.clock() - t0, 0.0)))
        if wait and fut.kind == "detect":
            while not fut.done():
                if self.dispatch(force=True) == 0 and not fut.done():
                    time.sleep(1e-3)    # another dispatcher owns the batch
        return fut

    def membership_at(self, graph_id: str, external: int,
                      t: Optional[float] = None) -> Optional[int]:
        """Persistent community id of an external vertex at snapshot time
        ``t`` (latest when None); None if unknown/retired at ``t``."""
        return self._require_timelines().membership_at(graph_id, external, t)

    def community_timeline(self, community_id: int):
        """The :class:`repro_torch.timeline.store.CommunityTimeline` row for a
        persistent community id (None when unknown/truncated)."""
        return self._require_timelines().timeline(community_id)

    def lifecycle_events(self, graph_id: Optional[str] = None, *,
                         kind: Optional[str] = None):
        return self._require_timelines().lifecycle_events(graph_id,
                                                          kind=kind)

    def timeline_snapshots(self, graph_id: str):
        return self._require_timelines().snapshots(graph_id)

    def timeline_communities(self, graph_id: Optional[str] = None, *,
                             alive_only: bool = False):
        return self._require_timelines().communities(
            graph_id, alive_only=alive_only)

    def external_ids(self, graph_id: str):
        return self._require_timelines().external_ids(graph_id)

    def subscribe_lifecycle(self, fn):
        """Register ``fn(events: List[LifecycleEvent])``, called after
        each snapshot that produced lifecycle events (compute thread;
        exceptions are swallowed + counted)."""
        return self._require_timelines().subscribe(fn)

    def unsubscribe_lifecycle(self, fn) -> bool:
        return self._require_timelines().unsubscribe(fn)

    def set_snapshot_time(self, graph_id: str, t: Optional[float]):
        """Stamp the next commit's snapshot with event-time ``t`` (for
        callers driving submit_update/submit_detect directly instead of
        :meth:`ingest_window`)."""
        self._require_timelines().set_time(graph_id, t)

    # -- dispatch ---------------------------------------------------------
    def collect(self, *, force: bool = False) -> List[Batch]:
        """Compose every ready group batch — a group is (bucket, tier),
        so each composed batch is homogeneous in its quality tier and
        weighted DRR still arbitrates tenants within it — plus every
        ready warm-update batch; loops until no group is ready, so a
        backlog drains in batch-size-wide slices."""
        batches: List[Batch] = []
        if self.telemetry.enabled:
            for t in self.admission.tenants():
                self.telemetry.gauge("tenant_queue_depth",
                                     self.admission.pending(t),
                                     {"tenant": t})
        while True:
            got = 0
            for bucket, alg in self.admission.ready_groups(self.clock(),
                                                           force=force):
                t_c0 = self.clock()
                reqs = self.admission.compose(bucket, algorithm=alg)
                t_c1 = self.clock()
                if reqs:
                    for r in reqs:
                        tr = r.future.trace if r.future is not None else None
                        if tr is not None:
                            tr.mark("queue-wait", _t_enqueued(tr, r.t_submit),
                                    t_c0)
                            tr.mark("drr-compose", t_c0, t_c1)
                    batches.append(("detect", bucket, reqs))
                    got += len(reqs)
            if not got:
                break
        batches.extend(self._collect_updates(force=force))
        return batches

    def _collect_updates(self, *, force: bool = False) -> List[Batch]:
        """Pop ready per-bucket update batches: full
        (``update_batch_size``), stale (oldest waited past
        ``update_max_delay_s``), or anything under ``force``."""
        size = self.config.update_batch_size
        if size <= 1:
            return []
        max_delay = (self.config.update_max_delay_s
                     if self.config.update_max_delay_s is not None
                     else self.config.max_delay_s)
        now = self.clock()
        batches: List[Batch] = []
        with self._upd_lock:
            for bucket, q in list(self._updates.items()):
                while q and (force or len(q) >= size
                             or now - q[0].t_submit >= max_delay):
                    batches.append(("update", bucket, q[:size]))
                    del q[:size]
                if not q:
                    del self._updates[bucket]
        t_pop = self.clock()
        for _, _, ureqs in batches:
            for r in ureqs:
                tr = r.future.trace
                if tr is not None:
                    tr.mark("queue-wait", _t_enqueued(tr, r.t_submit), now)
                    tr.mark("drr-compose", now, t_pop)
        return batches

    def execute(self, batches: List[Batch]) -> int:
        """Run composed batches through the engine, store results, resolve
        futures.  An engine failure fails that batch's futures (counted)
        and the remaining batches still run — the dispatcher survives.
        With resilience configured, failures route through retry /
        split-in-half / breaker / degraded-tier handling first (see
        :meth:`_execute_detects`)."""
        served = 0
        for kind, bucket, reqs in batches:
            if kind == "update":
                served += self._execute_updates(bucket, reqs)
            else:
                served += self._execute_detects(bucket, reqs)
        return served

    # Compose-time deadline slack: a request's own deadline is what FORCES
    # the flush that dispatches it, so at compose time ``now`` is always a
    # poll tick or two past the deadline — that request must still be
    # served.  Only requests overdue by more than this grace (they sat in
    # queue while other batches dispatched) fast-fail.
    DEADLINE_COMPOSE_GRACE_S = 0.25

    def _expire_overdue(self, reqs):
        """Compose-time deadline check: fail futures whose deadline has
        long passed instead of dispatching work nobody can use.  A small
        grace window exempts the deadline-triggered flush itself."""
        now = self.clock()
        live = []
        for r in reqs:
            if (r.deadline is not None
                    and now >= r.deadline + self.DEADLINE_COMPOSE_GRACE_S):
                self.metrics.deadline_reject(r.tenant)
                r.future.set_exception(DeadlineExceeded(
                    f"{r.req_id}: deadline passed "
                    f"{now - r.deadline:.4f}s before dispatch"))
            else:
                live.append(r)
        return live

    def _batch_deadline(self, reqs) -> Optional[float]:
        """Absolute retry bound for a batch: the latest member deadline
        (while any member could still use the result, retrying is worth
        it); None when any member is deadline-less."""
        deadlines = [r.deadline for r in reqs]
        if any(d is None for d in deadlines):
            return None
        return max(deadlines)

    def _shed(self, bucket: Bucket, reqs, exc: BaseException) -> int:
        """Final failure handling for detect requests: serve the degraded
        tier to opted-in tenants, fail the rest with ``exc``."""
        served = 0
        now = self.clock()
        for r in reqs:
            dr = self.resilience.degraded(
                r.graph_id, r.graph, self.store, now=now, tenant=r.tenant)
            if dr is None:
                self.metrics.fail(r.tenant)
                r.future.set_exception(exc)
                continue
            self.metrics.observe("detect", now - r.t_submit, now,
                                 tenant=r.tenant)
            tr = r.future.trace if r.future is not None else None
            if tr is not None:
                tr.mark("resolve", now, self.clock())
                self.telemetry.trace(tr)
            r.future.set_result(dr)
            served += 1
        return served

    def _detect_failed(self, bucket: Bucket, reqs,
                       exc: BaseException) -> int:
        """A batch dispatch failed after retries.  With resilience on,
        split it in half and re-run each half independently — a single
        poison graph ends up failing (or degrading) alone instead of
        poisoning its whole composed batch's futures."""
        if len(reqs) > 1 and self.resilience.enabled:
            self.resilience.note_split()
            mid = len(reqs) // 2
            return (self._execute_detects(bucket, reqs[:mid])
                    + self._execute_detects(bucket, reqs[mid:]))
        return self._shed(bucket, reqs, exc)

    def _execute_detects(self, bucket: Bucket, reqs) -> int:
        """Dispatch one composed detect batch with the full resilience
        stack: expired-deadline fast-fail, breaker shed, retried dispatch
        (watchdog-bounded), split-in-half on failure, per-request store
        commit under the commit seam, degraded-tier fallback."""
        reqs = self._expire_overdue(reqs)
        if not reqs:
            return 0
        res_mgr = self.resilience
        # composed batches are tier-homogeneous (admission groups by
        # (bucket, tier)), so the whole batch dispatches on one algorithm
        alg = reqs[0].algorithm
        if not res_mgr.allow(bucket):
            return self._shed(bucket, reqs, BreakerOpen(
                f"bucket {bucket.n_cap}x{bucket.m_cap} breaker is open"))
        try:
            results = res_mgr.dispatch(
                "detect", bucket,
                lambda: self.engine.detect_batch(
                    [r.graph for r in reqs], algorithm=alg,
                    fault_ids=[r.graph_id for r in reqs]),
                deadline=self._batch_deadline(reqs))
        except Exception as e:
            return self._detect_failed(bucket, reqs, e)
        served = 0
        info = self.engine.last_detect_info
        now = self.clock()
        for req, res in zip(reqs, results):
            tr = req.future.trace if req.future is not None else None
            if tr is not None and info is not None:
                _mark_engine_spans(tr, info)
            t_s0 = self.clock()
            try:
                entry = res_mgr.commit(partial(
                    self.store.put,
                    req.graph_id, req.graph, res.C,
                    n_communities=res.n_communities,
                    n_disconnected=res.n_disconnected, q=res.q,
                    algorithm=alg,
                ))
            except Exception as e:
                # commit failed after retries: this one request degrades
                # (stale = the previous committed entry) or fails alone
                served += self._shed(bucket, [req], e)
                continue
            t_s1 = self.clock()
            self.metrics.observe("detect", now - req.t_submit, now,
                                 tenant=req.tenant)
            self.metrics.edges_processed += float(live_edges(req.graph))
            if self.telemetry.enabled:
                self.telemetry.counter(
                    "detect_served_tier", 1,
                    {"tier": alg, "tenant": req.tenant})
            if tr is not None:
                tr.mark("store-commit", t_s0, t_s1)
                # resolve closes the trace just before the future
                # lands so a woken caller always sees a full span set
                tr.mark("resolve", t_s1, self.clock())
                self.telemetry.trace(tr)
            req.future.set_result(entry)
            served += 1
        return served

    def _execute_updates(self, bucket: Bucket, ureqs) -> int:
        """Dispatch one composed update batch through the batched warm
        path: fold same-graph batches in submit order (one prepared plan
        per graph, batch-wise — identical semantics to applying each
        immediately), run the engine per bucket, commit entries, resolve
        every queued future with its graph's refreshed entry."""
        by_gid: "OrderedDict[str, List[UpdateRequest]]" = OrderedDict()
        for r in ureqs:
            by_gid.setdefault(r.graph_id, []).append(r)
        plans, plan_reqs = [], []
        for gid, rs in by_gid.items():
            batches = [r.upd for r in rs]
            entry = self.store.get(gid)
            try:
                if entry is None:   # evicted/expired since submit
                    raise KeyError(gid)
                t_p0 = self.clock()
                plans.append(self.store.prepare_update_seq(gid, batches))
                t_p1 = self.clock()
                for r in rs:
                    if r.future.trace is not None:
                        r.future.trace.mark("repad", t_p0, t_p1)
                plan_reqs.append(rs)
            except CapacityExceeded as ce:
                # same continuation as the immediate path: re-detect the
                # merged graph, exempt from the tenant bound, and chain
                # the queued futures to the re-bucketed detect.  The
                # rebuild itself can fail (e.g. a later batch references
                # ids past the rebuilt vertex set) — that must fail these
                # futures, not the whole dispatch.  Under deferred
                # compaction there is no rebuild (the entry survived; see
                # submit_update): the overflow fails these futures —
                # except a cross-tier OptionsMismatch, whose entry the
                # store already invalidated (re-detect is the only path).
                if self.config.compact_window and \
                        not isinstance(ce, OptionsMismatch):
                    for r in rs:
                        self.metrics.fail(r.tenant)
                        r.future.set_exception(ce)
                    continue
                try:
                    g = _graph_with_updates(entry.graph, batches)
                    if self.timelines is not None:
                        self.timelines.register_rebucket(
                            gid, batches, int(entry.graph.n_nodes))
                    self.metrics.n_rebucketed += 1
                    fut2 = self.submit_detect(gid, g, tenant=rs[0].tenant,
                                              exempt_bound=True)
                except Exception as e:
                    for r in rs:
                        self.metrics.fail(r.tenant)
                        r.future.set_exception(e)
                else:
                    for r in rs:
                        _chain(fut2, r.future)
            except Exception as e:      # malformed batch, evicted entry, ..
                for r in rs:
                    self.metrics.fail(r.tenant)
                    r.future.set_exception(e)
        # group by the plans' CURRENT bucket: an interleaved re-detect can
        # have re-bucketed a graph since its update was queued, and one
        # stale-bucket plan must not fail the whole engine batch
        groups: "OrderedDict[Bucket, List[int]]" = OrderedDict()
        for i, p in enumerate(plans):
            groups.setdefault(p.bucket, []).append(i)
        served = 0
        for grp_bucket, idxs in groups.items():
            try:
                results = self.resilience.dispatch(
                    "update", grp_bucket,
                    lambda idxs=idxs: self.engine.update_batch(
                        [(plans[i].graph, plans[i].C_prev,
                          plans[i].touched) for i in idxs],
                        fault_ids=[plans[i].graph_id for i in idxs]))
            except Exception as e:
                for i in idxs:
                    for r in plan_reqs[i]:
                        self.metrics.fail(r.tenant)
                        r.future.set_exception(e)
                continue
            # count the batch BEFORE resolving futures: a caller woken by
            # its future must already see n_update_batches reflect the
            # dispatch that served it (the old post-loop increment raced)
            self.metrics.n_update_batches += 1
            self.metrics.n_updates_batched += len(idxs)
            info = self.engine.last_update_info
            now = self.clock()
            for i, res in zip(idxs, results):
                plan = plans[i]
                t_s0 = self.clock()
                try:
                    entry = self.resilience.commit(partial(
                        self.store.commit_update,
                        plan, C=res.C, n_communities=res.n_communities,
                        n_disconnected=res.n_disconnected, q=res.q))
                except Exception as e:
                    # a failed commit fails THIS plan's futures only; the
                    # rest of the batch still resolves
                    for r in plan_reqs[i]:
                        self.metrics.fail(r.tenant)
                        r.future.set_exception(e)
                    continue
                t_s1 = self.clock()
                if entry is None:
                    # the entry moved on (evicted/re-detected) while the
                    # batch computed; the stale write was dropped — fail
                    # the futures rather than hand out resurrected state
                    for r in plan_reqs[i]:
                        self.metrics.fail(r.tenant)
                        r.future.set_exception(KeyError(
                            f"{plan.graph_id!r}: entry superseded while "
                            "the update batch ran"))
                    continue
                self.metrics.edges_processed += float(live_edges(plan.graph))
                self.metrics.n_deletions += plan.n_deleted
                self.metrics.n_vertex_added += plan.n_added
                self.metrics.n_vertex_removed += plan.n_removed
                for r in plan_reqs[i]:
                    self.metrics.observe("update", now - r.t_submit, now,
                                         tenant=r.tenant)
                    tr = r.future.trace
                    if tr is not None:
                        if info is not None:
                            _mark_engine_spans(tr, info)
                        tr.mark("store-commit", t_s0, t_s1)
                        tr.mark("resolve", t_s1, self.clock())
                        self.telemetry.trace(tr)
                    r.future.set_result(entry)
                    served += 1
        return served

    def dispatch(self, *, force: bool = False) -> int:
        """Collect + execute every ready batch; returns served count."""
        return self.execute(self.collect(force=force))

    def drain(self) -> int:
        """Flush every queue regardless of batch fill / deadlines."""
        served = 0
        while self.admission.pending() or self.pending_updates():
            served += self.dispatch(force=True)
        return served

    # -- introspection -----------------------------------------------------
    def result(self, graph_id: str):
        return self.store.get(graph_id)

    def pending(self, tenant: Optional[str] = None) -> int:
        return self.admission.pending(tenant)

    def pending_updates(self) -> int:
        """Queued (not yet dispatched) warm updates across buckets."""
        with self._upd_lock:
            return sum(len(q) for q in self._updates.values())

    def evict_updates(self) -> List[UpdateRequest]:
        """Pop every queued update (service shutdown) so the caller can
        cancel the attached futures."""
        with self._upd_lock:
            out = [r for q in self._updates.values() for r in q]
            self._updates.clear()
            return out

    def close(self):
        """Shut down the background side: stop the auto-checkpointer
        (taking one final flush snapshot), stop the exporter's HTTP
        thread and close every registered sink (flushes the JSONL log).
        The serving structures stay usable — this only detaches
        observers."""
        if self.autockpt is not None:
            self.autockpt.close()
        if self.exporter is not None:
            self.exporter.close()
            self.exporter = None
        self.telemetry.close()


class AsyncCommunityService:
    """Asyncio front end: dispatcher task + executor-offloaded compute.

    Usage::

        async with AsyncCommunityService(ServiceConfig(...)) as svc:
            fut = await svc.submit_detect("g", graph, tenant="alice",
                                          priority=1, deadline_s=0.1)
            entry = await fut

    Backpressure: with ``block=True`` (default) a submission against a
    full tenant queue awaits a freed slot; with ``block=False`` it raises
    :class:`QueueFull` immediately (the rejection is counted per tenant).
    The dispatcher wakes on every submission and on a poll tick
    (``poll_s``, default ``max_delay_s / 4``) that bounds how late a
    deadline/max-delay flush can fire.
    """

    def __init__(self, config: Optional[ServiceConfig] = None, *,
                 clock=None, poll_s: Optional[float] = None, device=None):
        self.frontend = ServiceFrontend(config, clock=clock, device=device)
        cfg = self.frontend.config
        self._poll_s = (poll_s if poll_s is not None
                        else max(cfg.max_delay_s / 4, 1e-3))
        self._compute = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="community-svc")
        self._work: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self._inflight = 0
        self._slot_waiters: List[asyncio.Future] = []

    # -- delegation --------------------------------------------------------
    @property
    def config(self) -> ServiceConfig:
        return self.frontend.config

    @property
    def engine(self) -> BatchedLouvainEngine:
        return self.frontend.engine

    @property
    def store(self) -> ResultStore:
        return self.frontend.store

    @property
    def metrics(self) -> ServiceMetrics:
        return self.frontend.metrics

    @property
    def telemetry(self) -> Telemetry:
        return self.frontend.telemetry

    def result(self, graph_id: str):
        return self.frontend.result(graph_id)

    def pending(self, tenant: Optional[str] = None) -> int:
        return self.frontend.pending(tenant)

    # temporal-tracking queries are host-side dict/array lookups under the
    # manager lock — cheap enough to run on the event loop directly
    @property
    def timelines(self) -> Optional[TimelineManager]:
        return self.frontend.timelines

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

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "AsyncCommunityService":
        if self._task is None:
            loop = asyncio.get_running_loop()
            self._work = asyncio.Event()
            self._running = True
            self._task = loop.create_task(self._dispatch_loop())
        return self

    async def __aenter__(self) -> "AsyncCommunityService":
        return await self.start()

    async def __aexit__(self, *exc):
        await self.close(drain=all(e is None for e in exc))

    async def close(self, *, drain: bool = True):
        if self._task is not None:
            if drain:
                await self.drain()
            self._running = False
            self._work.set()
            await self._task
            self._task = None
        # nothing may be left awaiting a dispatcher that no longer runs:
        # cancel every future still queued (empty set after a drain)
        for req in self.frontend.admission.evict_all():
            if req.future is not None:
                req.future.cancel()
        for ureq in self.frontend.evict_updates():
            ureq.future.cancel()
        for w in self._slot_waiters:
            if not w.done():
                w.cancel()
        self._slot_waiters.clear()
        self._compute.shutdown(wait=True)
        self.frontend.close()

    # -- dispatcher --------------------------------------------------------
    async def _execute(self, batches) -> int:
        loop = asyncio.get_running_loop()
        self._inflight += 1
        try:
            return await loop.run_in_executor(
                self._compute, self.frontend.execute, batches)
        finally:
            self._inflight -= 1
            self._wake_slot_waiters()

    async def _dispatch_loop(self):
        while self._running:
            batches = self.frontend.collect()
            if batches:
                await self._execute(batches)
                continue
            try:
                await asyncio.wait_for(self._work.wait(),
                                       timeout=self._poll_s)
            except asyncio.TimeoutError:
                pass
            self._work.clear()

    def _wake_slot_waiters(self):
        waiters, self._slot_waiters = self._slot_waiters, []
        for w in waiters:
            if not w.done():
                w.set_result(None)

    # -- request entry points ----------------------------------------------
    async def submit_detect(self, graph_id: str, graph: Graph, *,
                            tenant: str = DEFAULT_TENANT, priority: int = 0,
                            deadline_s: Optional[float] = None,
                            algorithm: Optional[str] = None,
                            block: bool = True) -> DetectionFuture:
        loop = asyncio.get_running_loop()
        while True:
            try:
                fut = self.frontend.submit_detect(
                    graph_id, graph, tenant=tenant, priority=priority,
                    deadline_s=deadline_s, algorithm=algorithm,
                    count_reject=not block)
            except QueueFull:
                if not block:
                    raise
                waiter = loop.create_future()
                self._slot_waiters.append(waiter)
                self._work.set()            # nudge the dispatcher
                await waiter
                continue
            self._work.set()
            return fut

    async def submit_update(self, graph_id: str, updates, *,
                            tenant: str = DEFAULT_TENANT) -> DetectionFuture:
        loop = asyncio.get_running_loop()
        fut = await loop.run_in_executor(
            self._compute,
            partial(self.frontend.submit_update, graph_id, updates,
                    tenant=tenant))
        self._work.set()     # a rebucketed update enqueued a detect
        return fut

    async def ingest_window(self, graph_id: str, events, *,
                            t: Optional[float] = None,
                            tenant: str = DEFAULT_TENANT) -> DetectionFuture:
        """Async :meth:`ServiceFrontend.ingest_window`: the translate +
        warm compute runs on the executor; a re-bucketed window resolves
        through this service's own dispatcher (``wait=False`` — pumping
        on the compute thread would deadlock the single-worker
        executor)."""
        loop = asyncio.get_running_loop()
        fut = await loop.run_in_executor(
            self._compute,
            partial(self.frontend.ingest_window, graph_id, list(events),
                    t=t, tenant=tenant, wait=False))
        self._work.set()
        return fut

    async def drain(self) -> int:
        """Force-flush everything queued and wait for in-flight batches."""
        served = 0
        while True:
            batches = self.frontend.collect(force=True)
            if batches:
                served += await self._execute(batches)
            elif (self._inflight or self.frontend.pending()
                  or self.frontend.pending_updates()):
                await asyncio.sleep(self._poll_s / 4)
            else:
                break
        return served


def _t_enqueued(trace: RequestTrace, fallback: float) -> float:
    """When a request entered its queue: the end of the last span marked
    at submit time (admission for detects, submit for queued updates)."""
    return trace.spans[-1].t_end if trace.spans else fallback


def _mark_engine_spans(trace: RequestTrace, info: DispatchInfo):
    """Stamp one dispatch's batch-level phases onto a member request's
    trace: compile (the key's first dispatch, which loads the kernels;
    an empty interval on a hit), engine-dispatch (host prep + the loop
    over the batch), device-sync (the labels copied to the host).  Every
    request in the batch shares these intervals."""
    hit = info.compile_hit
    trace.mark("compile", info.t_call0,
               info.t_call0 if hit else info.t_call1,
               hit="true" if hit else "false")
    trace.mark("engine-dispatch", info.t_start,
               info.t_call1 if hit else info.t_call0)
    trace.mark("device-sync", info.t_call1, info.t_sync)


def _graph_with_updates(g: Graph, batches) -> Graph:
    """Rebuild a plain (unpadded-capacity) graph with update batches
    folded in, in order — the re-bucketing fallback when updates overflow
    a bucket.  Same batch-wise semantics as the in-place path (per-batch
    deletion clamping, per-batch vertex remaps, post-rewrite edge-id
    validation), without a capacity ceiling, on ``g``'s device."""
    for upd in map(as_update, batches):
        if upd.has_vertex_ops:
            g = rebuild_with_vertex_ops(g, add=upd.add, remove=upd.remove)
        if upd.has_edges:
            check_vertex_ids(upd.u, upd.v, int(g.n_nodes))
            src, dst, ww = merge_edge_deltas(
                g, *directed_deltas(upd.u, upd.v, upd.dw))
            g = from_coo(int(g.n_nodes), src, dst, ww, device=g.device)
    return g


def _chain(src_fut: DetectionFuture, dst_fut: DetectionFuture):
    """Resolve ``dst_fut`` with ``src_fut``'s outcome when it lands (a
    queued update whose dispatch re-bucketed into a detect)."""
    def _copy(f: DetectionFuture):
        try:
            exc = f.exception()
        except concurrent.futures.CancelledError:
            # service shutdown cancelled the chained detect; a cancelled
            # Future RAISES from exception(), and letting that escape
            # the callback would leave dst_fut pending forever
            dst_fut.cancel()
            return
        if exc is not None:
            dst_fut.set_exception(exc)
        else:
            dst_fut.set_result(f.result())
    src_fut.add_done_callback(_copy)
