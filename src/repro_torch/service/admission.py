"""Admission control: the service front door (port of
``repro/service/admission.py``; host Python, the reference's order of picks
exactly).

Three pieces:

* :class:`ServiceConfig` — every service-layer knob in one dataclass
  (engine, dispatch, admission, store eviction, telemetry, timelines,
  resilience, tiers), read by the front end
  (:mod:`repro_torch.service.frontend`).
* bounded per-tenant queues — each tenant may hold at most
  ``max_pending_per_tenant`` undispatched requests across all buckets;
  overflow raises :class:`QueueFull` (explicit backpressure: the sync path
  rejects, the async front end awaits a slot).
* :class:`AdmissionController` — composes per-bucket batches with
  **weighted deficit round robin** across tenants, so a tenant flooding
  its queue cannot starve light tenants: every compose cycle credits each
  active tenant ``weight`` units of deficit and takes requests only
  against accumulated credit.  Within a tenant, higher ``priority``
  dispatches first (FIFO inside a priority level); a request ``deadline``
  forces its bucket to flush even before ``max_delay_s``.

The controller is clock-injected and thread-safe: the async front end
submits re-bucketed updates from its compute thread while the event loop
collects batches.

The port's ``ServiceConfig`` has the reference's fields, defaults and
validation messages (``sub_batch``, the engine's tile width, included),
less the reference's deprecated flat detection keywords (``louvain``,
``dense_max_nv``, ``dense_small_nv``, ``dense_min_density``,
``seg_impl``, ``seg_block_m``) and their read-back properties: passing any of them is Python's own ``TypeError``, and callers
pass ``detect=DetectOptions(...)``.  Where the service runs is not a
field: the front end takes a ``device`` keyword.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.api import DetectOptions
from repro_torch.core.portfolio import contract_for
from repro_torch.graph.container import Graph
from repro_torch.service.buckets import Bucket, DEFAULT_BUCKETS

# a DRR composition group: same-bucket, same-tier requests batch together
Group = Tuple[Bucket, str]


DEFAULT_TENANT = "default"


class QueueFull(Exception):
    """A tenant's queue is at its bound: reject (sync) or await a slot
    (async front end with ``block=True``)."""


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """All service-layer configuration in one place.

    Engine/dispatch:
      detect:      the :class:`repro_torch.core.DetectOptions` record —
                   default tier, algorithm config (``detect.louvain``),
                   scan strategy and dense crossover.  Engine and store
                   keys derive from this one hashable record
                   (:meth:`DetectOptions.cache_key`).
      buckets:     static (n_cap, m_cap) admission ladder (sorted).
      batch_size:  dispatch width per bucket batch.
      max_delay_s: tail-latency bound — a bucket flushes a partial batch
                   once its oldest request has waited this long.
      sub_batch:   engine tile width; None = device-keyed auto (1 on the
                   CPU, 8 on CUDA).

    Warm updates (edge weight-deltas AND vertex additions/removals — one
    :class:`repro_torch.core.dynamic.GraphUpdate` batch type):
      update_batch_size: >1 queues update batches per bucket and
                   dispatches them through the engine's batched warm path
                   (:meth:`BatchedLouvainEngine.update_batch`, the update
                   analogue of detect batching); 1 (default) keeps the
                   immediate per-call path.  Both paths share the host-side
                   prepare fold, so vertex-id compaction and deletion
                   clamping are identical either way.
      update_max_delay_s: flush bound for a partial update batch; None
                   inherits ``max_delay_s``.

    Admission:
      max_pending_per_tenant: queue bound per tenant (backpressure).
      tenant_weights: (tenant, weight) pairs for DRR fairness; unlisted
                      tenants weigh 1.0.

    Store eviction:
      store_max_entries: LRU cap on resident entries (None = unbounded).
      store_ttl_s:       entry time-to-live (None = no expiry).

    Telemetry (:mod:`repro_torch.telemetry`):
      telemetry_enabled: attach the in-memory aggregation sink (per-phase
                   span histograms, algorithm counters, queue-depth gauges
                   — what the exporter scrapes).  False leaves the hub
                   empty: request traces still populate
                   ``DetectionFuture.trace``, but no sink work runs on the
                   serving path.
      telemetry_jsonl: path for a JSONL event-log sink (None = off).
      exporter_port: serve Prometheus text format on
                   ``http://127.0.0.1:<port>/metrics`` (0 = ephemeral
                   port, read it off ``frontend.exporter.port``; None =
                   no HTTP thread).  Requires ``telemetry_enabled``.
      profile_dir: trace every engine dispatch with ``torch.profiler``
                   into this directory (TensorBoard format; expensive,
                   None = off).

    Temporal tracking (:mod:`repro_torch.timeline`):
      timeline_enabled: attach a :class:`repro_torch.timeline.tracker.
                   TimelineManager` to the store's commit hook — every
                   committed partition becomes a snapshot with persistent
                   community ids + lifecycle events, queryable via
                   ``membership_at``/``community_timeline``/
                   ``lifecycle_events`` and fed by ``ingest_window``.
      timeline_jaccard_min: weighted-Jaccard floor for the
                   snapshot-to-snapshot matcher (below it communities
                   never relate).
      timeline_weight_by_degree: weight matcher member sets by weighted
                   degree instead of uniformly.
      timeline_max_snapshots / timeline_max_events / timeline_max_rows /
      timeline_max_communities: bounded-memory timeline retention
                   (per-graph snapshot deque, global lifecycle log,
                   per-community row deque, tracked-community cap).
      compact_window: > 0 defers vertex-removal compaction in the store —
                   removals tombstone immediately (results stay correct)
                   and the O(m log m) remap is paid once per
                   ``compact_window`` removals (see
                   :class:`repro_torch.service.store.ResultStore`).  With
                   deferral on, a capacity overflow is surfaced to the
                   caller instead of triggering the re-bucketing rebuild.
                   0 = immediate compaction.
    """

    detect: DetectOptions = dataclasses.field(default_factory=DetectOptions)
    buckets: Tuple[Bucket, ...] = DEFAULT_BUCKETS
    batch_size: int = 32
    max_delay_s: float = 0.05
    sub_batch: Optional[int] = None
    update_batch_size: int = 1
    update_max_delay_s: Optional[float] = None
    max_pending_per_tenant: int = 64
    tenant_weights: Tuple[Tuple[str, float], ...] = ()
    store_max_entries: Optional[int] = None
    store_ttl_s: Optional[float] = None
    telemetry_enabled: bool = True
    telemetry_jsonl: Optional[str] = None
    exporter_port: Optional[int] = None
    profile_dir: Optional[str] = None
    timeline_enabled: bool = False
    timeline_jaccard_min: float = 0.1
    timeline_weight_by_degree: bool = False
    timeline_max_snapshots: int = 64
    timeline_max_events: int = 4096
    timeline_max_rows: int = 256
    timeline_max_communities: int = 4096
    compact_window: int = 0
    # Resilience (:mod:`repro_torch.resilience`) — all off by default, so
    # an unconfigured service runs the plain code paths:
    #   fault_plan:      deterministic chaos injected at the real seams
    #                    (engine dispatch raise/hang, store commit,
    #                    checkpoint IO, telemetry sink, transient
    #                    capacity); None = no injection.
    #   retry:           RetryPolicy wrapped around engine dispatch and
    #                    store commits (attempts, backoff + jitter,
    #                    watchdog timeout, wall-clock budget honoring
    #                    admission deadlines); None = single attempt,
    #                    no watchdog thread.
    #   breaker:         per-bucket circuit BreakerConfig; an OPEN bucket
    #                    sheds to the degraded tier (or fails fast).
    #   degrade_enabled: serve stale/LPA degraded results (flagged, NOT
    #                    carrying the zero-disconnected guarantee) when a
    #                    batch exhausts retries or its breaker is open.
    #   degrade_modes:   order of degraded tiers to try ("stale", "lpa").
    #   degrade_tenants: tenants opted in (None = all tenants).
    #   autockpt_dir:    enable background automatic checkpointing into
    #                    this directory (periodic + dirty-threshold
    #                    snapshots, evicted-warm write-back, startup
    #                    recovery); None = caller-driven only.
    fault_plan: Optional[object] = None
    retry: Optional[object] = None
    breaker: Optional[object] = None
    degrade_enabled: bool = False
    degrade_modes: Tuple[str, ...] = ("stale", "lpa")
    degrade_tenants: Optional[Tuple[str, ...]] = None
    autockpt_dir: Optional[str] = None
    autockpt_period_s: float = 30.0
    autockpt_dirty: int = 0
    autockpt_keep: int = 3
    autockpt_writeback: int = 64
    autockpt_recover: bool = True
    # SLO tiers (core/portfolio.py) — which portfolio tier serves a
    # request.  Per-request ``algorithm=`` wins; else the tenant's
    # declared tier (``tenant_tiers``); else, when the request carries a
    # deadline, the first ``deadline_tiers`` (tier, bound_s) pair with
    # deadline <= bound (pairs sorted ascending: tight deadlines buy the
    # cheap tier); else ``detect.algorithm``.  ``warm()`` dispatches one
    # filler graph for every tier reachable through this config
    # (``serve_algorithms``).
    tenant_tiers: Tuple[Tuple[str, str], ...] = ()
    deadline_tiers: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.update_batch_size < 1:
            raise ValueError(f"update_batch_size must be >= 1, got "
                             f"{self.update_batch_size}")
        if self.max_pending_per_tenant < 1:
            raise ValueError("max_pending_per_tenant must be >= 1, got "
                             f"{self.max_pending_per_tenant}")
        for tenant, weight in self.tenant_weights:
            if weight <= 0:
                raise ValueError(
                    f"tenant {tenant!r} weight must be > 0, got {weight}")
        if self.exporter_port is not None and not self.telemetry_enabled:
            raise ValueError("exporter_port requires telemetry_enabled "
                             "(the exporter scrapes the in-memory sink)")
        if self.compact_window < 0:
            raise ValueError(
                f"compact_window must be >= 0, got {self.compact_window}")
        if not (0.0 < self.timeline_jaccard_min <= 1.0):
            raise ValueError("timeline_jaccard_min must be in (0, 1], got "
                             f"{self.timeline_jaccard_min}")
        for knob in ("timeline_max_snapshots", "timeline_max_events",
                     "timeline_max_rows", "timeline_max_communities"):
            if getattr(self, knob) < 1:
                raise ValueError(
                    f"{knob} must be >= 1, got {getattr(self, knob)}")
        bad = [m for m in self.degrade_modes if m not in ("stale", "lpa")]
        if bad:
            raise ValueError(
                f"degrade_modes must be drawn from ('stale', 'lpa'), got "
                f"{bad}")
        if not self.degrade_modes:
            raise ValueError("degrade_modes must not be empty")
        if self.autockpt_period_s <= 0:
            raise ValueError(
                f"autockpt_period_s must be > 0, got {self.autockpt_period_s}")
        if self.autockpt_dirty < 0:
            raise ValueError(
                f"autockpt_dirty must be >= 0, got {self.autockpt_dirty}")
        if self.autockpt_keep < 1:
            raise ValueError(
                f"autockpt_keep must be >= 1, got {self.autockpt_keep}")
        if self.autockpt_writeback < 0:
            raise ValueError(
                f"autockpt_writeback must be >= 0, got "
                f"{self.autockpt_writeback}")
        for tenant, tier in self.tenant_tiers:
            contract_for(tier)  # raises on unknown tier names
        prev = 0.0
        for tier, bound in self.deadline_tiers:
            contract_for(tier)
            if bound <= prev:
                raise ValueError(
                    "deadline_tiers bounds must be > 0 and strictly "
                    f"ascending, got {self.deadline_tiers}")
            prev = bound
        object.__setattr__(self, "buckets", tuple(sorted(self.buckets)))

    # -- tier selection ----------------------------------------------------
    def tier_for(self, tenant: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 algorithm: Optional[str] = None) -> str:
        """Resolve the portfolio tier for one request: explicit
        ``algorithm`` > tenant pin > deadline auto-select > default."""
        if algorithm is not None:
            contract_for(algorithm)
            return algorithm
        for t, tier in self.tenant_tiers:
            if t == tenant:
                return tier
        if deadline_s is not None:
            for tier, bound in self.deadline_tiers:
                if deadline_s <= bound:
                    return tier
        return self.detect.algorithm

    @property
    def serve_algorithms(self) -> Tuple[str, ...]:
        """Every tier reachable through this config (ordered, deduped) —
        what the engine warms at ``warm()``."""
        tiers = [self.detect.algorithm]
        tiers += [tier for _, tier in self.tenant_tiers]
        tiers += [tier for tier, _ in self.deadline_tiers]
        return tuple(dict.fromkeys(tiers))


@dataclasses.dataclass
class PendingRequest:
    """A bucketed detect request waiting for dispatch."""

    req_id: str
    tenant: str
    graph_id: str
    graph: Graph                 # bucket-padded
    bucket: Bucket
    priority: int                # higher dispatches earlier within tenant
    t_submit: float
    deadline: Optional[float]    # absolute clock time forcing a flush
    algorithm: str = "standard"  # portfolio tier (batches compose per tier)
    future: object = None        # DetectionFuture (set by the frontend)

    @property
    def group(self) -> Group:
        return (self.bucket, self.algorithm)


class AdmissionController:
    """Bounded per-tenant queues + weighted-DRR batch composition.

    Batches compose per :data:`Group` — (bucket, algorithm tier) — so a
    dispatch is always homogeneous in both shape and dispatch key: the
    engine keys one dispatch per (bucket, tier, scan)."""

    def __init__(self, buckets=DEFAULT_BUCKETS, *, batch_size: int = 32,
                 max_delay_s: float = 0.05, max_pending_per_tenant: int = 64,
                 weights: Optional[Dict[str, float]] = None,
                 clock: Optional[Callable[[], float]] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.buckets = tuple(sorted(buckets))
        self.batch_size = int(batch_size)
        self.max_delay_s = float(max_delay_s)
        self.max_pending_per_tenant = int(max_pending_per_tenant)
        self.clock = clock or time.perf_counter
        self._weights: Dict[str, float] = dict(weights or {})
        # (bucket, tier) -> tenant -> heap of (-priority, seq, req);
        # groups materialize lazily (3 tiers x ladder is the ceiling)
        self._queues: Dict[Group, Dict[str, list]] = {}
        self._pending_by_tenant: Dict[str, int] = {}
        self._deficit: Dict[Tuple[Group, str], float] = {}
        self._rr: Dict[Group, int] = {}
        self._order: List[str] = []       # stable first-seen tenant order
        self._known = set()               # O(1) membership for _order
        self._seq = itertools.count()     # FIFO tiebreak within a priority
        self._lock = threading.Lock()

    # -- weights ----------------------------------------------------------
    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    def set_weight(self, tenant: str, weight: float):
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        self._weights[tenant] = float(weight)

    # -- queueing ---------------------------------------------------------
    def submit(self, req: PendingRequest, *, exempt_bound: bool = False):
        """Enqueue; raises :class:`QueueFull` at the tenant's bound.

        ``exempt_bound`` admits past the bound but still counts toward it
        — for internal continuations (a re-bucketed update whose store
        entry is already invalidated) that must not be droppable.
        """
        with self._lock:
            n = self._pending_by_tenant.get(req.tenant, 0)
            if n >= self.max_pending_per_tenant and not exempt_bound:
                raise QueueFull(
                    f"tenant {req.tenant!r} has {n} pending requests "
                    f"(bound {self.max_pending_per_tenant})")
            if req.tenant not in self._known:
                self._known.add(req.tenant)
                self._order.append(req.tenant)
            if req.bucket not in self.buckets:
                raise ValueError(f"unknown bucket {req.bucket}")
            q = self._queues.setdefault(req.group, {}).setdefault(
                req.tenant, [])
            heapq.heappush(q, (-req.priority, next(self._seq), req))
            self._pending_by_tenant[req.tenant] = n + 1

    def pending(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is not None:
                return self._pending_by_tenant.get(tenant, 0)
            return sum(self._pending_by_tenant.values())

    def tenants(self) -> List[str]:
        with self._lock:
            return list(self._order)

    # -- dispatch decisions -----------------------------------------------
    def _group_ready(self, group: Group, now: float, force: bool) -> bool:
        """Caller holds the lock."""
        reqs = [item[2] for q in self._queues.get(group, {}).values()
                for item in q]
        if not reqs:
            return False
        if force or len(reqs) >= self.batch_size:
            return True
        t_oldest = min(r.t_submit for r in reqs)
        d_min = min((r.deadline for r in reqs
                     if r.deadline is not None), default=None)
        return (now - t_oldest >= self.max_delay_s
                or (d_min is not None and now >= d_min))

    def ready_groups(self, now: Optional[float] = None, *,
                     force: bool = False) -> List[Group]:
        """(bucket, tier) groups with a full batch, a stale oldest
        request, a passed deadline, or anything at all under ``force``."""
        now = self.clock() if now is None else now
        with self._lock:
            return [g for g in sorted(self._queues)
                    if self._group_ready(g, now, force)]

    def ready_buckets(self, now: Optional[float] = None, *,
                      force: bool = False) -> List[Bucket]:
        """Buckets with at least one ready (bucket, tier) group — the
        pre-tier spelling; batch composition is per group either way."""
        seen: List[Bucket] = []
        for b, _ in self.ready_groups(now, force=force):
            if b not in seen:
                seen.append(b)
        return seen

    def _pick_group(self, bucket: Bucket) -> Optional[Group]:
        """The bucket's nonempty group holding the oldest queued request
        (caller holds the lock) — legacy compose(bucket) entry."""
        best, best_t = None, None
        for g, queues in self._queues.items():
            if g[0] != bucket:
                continue
            ts = [item[2].t_submit for q in queues.values() for item in q]
            if ts and (best_t is None or min(ts) < best_t):
                best, best_t = g, min(ts)
        return best

    def compose(self, bucket: Bucket, *, algorithm: Optional[str] = None,
                max_n: Optional[int] = None) -> List[PendingRequest]:
        """Pop up to ``max_n`` requests for one (bucket, tier) group by
        weighted DRR.  ``algorithm=None`` serves the bucket's group with
        the oldest queued request — batches stay single-tier either way.

        Each cycle over tenants with queued work credits ``weight(t)``
        deficit and serves requests against it; an emptied queue forfeits
        its remaining credit (no banking while idle), so a returning
        heavy tenant cannot burst past its share.
        """
        max_n = self.batch_size if max_n is None else max_n
        batch: List[PendingRequest] = []
        with self._lock:
            if algorithm is None:
                group = self._pick_group(bucket)
                if group is None:
                    return batch
            else:
                group = (bucket, algorithm)
            queues = self._queues.get(group, {})
            if self._order:
                start = self._rr.get(group, 0) % len(self._order)
                self._rr[group] = start + 1
                order = (self._order[start:] + self._order[:start])
            else:
                order = []
            while len(batch) < max_n:
                if not any(queues.get(t) for t in order):
                    break
                for t in order:
                    q = queues.get(t)
                    if not q:
                        continue
                    key = (group, t)
                    self._deficit[key] = (self._deficit.get(key, 0.0)
                                          + self.weight(t))
                    while q and self._deficit[key] >= 1.0 and len(batch) < max_n:
                        _, _, req = heapq.heappop(q)
                        self._deficit[key] -= 1.0
                        self._pending_by_tenant[req.tenant] -= 1
                        batch.append(req)
                    if not q:
                        self._deficit[key] = 0.0
                        del queues[t]
                        if self._pending_by_tenant.get(t, 0) == 0:
                            self._prune_idle(t)
                    if len(batch) >= max_n:
                        break
        return batch

    def evict_all(self) -> List[PendingRequest]:
        """Pop every queued request (service shutdown) so the caller can
        fail or cancel the attached futures — nothing may be left
        awaiting a dispatcher that no longer runs."""
        with self._lock:
            out: List[PendingRequest] = []
            for queues in self._queues.values():
                for q in queues.values():
                    out.extend(item[2] for item in q)
            self._queues.clear()
            self._pending_by_tenant.clear()
            self._deficit.clear()
            self._order.clear()
            self._known.clear()
            return out

    def _prune_idle(self, tenant: str):
        """Drop an idle tenant's bookkeeping (caller holds the lock).

        DRR never banks deficit while idle, so a returning tenant starts
        fresh anyway — pruning keeps per-submit and per-compose cost
        independent of how many tenants have EVER submitted (the service
        targets per-user tenant ids, so that set only grows)."""
        self._known.discard(tenant)
        try:
            self._order.remove(tenant)
        except ValueError:
            pass
        self._pending_by_tenant.pop(tenant, None)
        for g in list(self._queues):
            self._deficit.pop((g, tenant), None)
            self._queues[g].pop(tenant, None)
