"""Admission control: the service front door (port of
``repro/service/admission.py``; host Python, the reference's order of picks
exactly).

Two pieces:

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

The reference's ``ServiceConfig`` is not here: its only reader is the
front end (ROADMAP A.11), and it comes with it.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.graph.container import Graph
from repro_torch.service.buckets import Bucket, DEFAULT_BUCKETS

# a DRR composition group: same-bucket, same-tier requests batch together
Group = Tuple[Bucket, str]


DEFAULT_TENANT = "default"


class QueueFull(Exception):
    """A tenant's queue is at its bound: reject (sync) or await a slot
    (async front end with ``block=True``)."""


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
