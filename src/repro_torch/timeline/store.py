"""Bounded-memory timeline store: snapshots, community rows, events (port
of ``repro/timeline/store.py``).

Three retention domains, each bounded independently of the
:class:`repro_torch.service.store.ResultStore` (whose LRU/TTL eviction governs
*compute* residency, not history — see the frontend's retention note):

* per graph, a deque of the last ``max_snapshots`` full membership
  snapshots ``(t, sorted external ids, persistent community ids)`` —
  what :meth:`membership_at` answers from;
* per persistent community, a row deque capped at ``max_rows``
  (size/weight trajectory) plus birth/death times;
* one global lifecycle-event deque capped at ``max_events``.

Everything is host-side numpy + plain dicts; reads and writes are
serialized by the owning :class:`repro_torch.timeline.tracker.
TimelineManager`'s lock.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.timeline.matcher import LifecycleEvent, Members


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One committed window: full membership in external-id space."""

    t: float
    ext: np.ndarray          # int64[k] external vertex ids, sorted
    cid: np.ndarray          # int64[k] persistent community id per vertex
    n_communities: int
    n_disconnected: int

    def membership(self, external: int) -> Optional[int]:
        i = int(np.searchsorted(self.ext, int(external)))
        if i < self.ext.size and int(self.ext[i]) == int(external):
            return int(self.cid[i])
        return None


@dataclasses.dataclass
class CommunityTimeline:
    """One persistent community's recorded trajectory."""

    cid: int
    graph_id: str
    born_t: float
    dead_t: Optional[float] = None
    parents: Tuple[int, ...] = ()
    origin: str = "birth"            # birth | split | seed
    # (t, size, weight) rows, newest last, capped by the store
    rows: Deque[Tuple[float, int, float]] = dataclasses.field(
        default_factory=deque)

    @property
    def alive(self) -> bool:
        return self.dead_t is None

    @property
    def last_size(self) -> int:
        return self.rows[-1][1] if self.rows else 0


class TimelineStore:
    def __init__(self, *, max_snapshots: int = 64, max_events: int = 4096,
                 max_rows: int = 256, max_communities: int = 4096):
        for name, v in (("max_snapshots", max_snapshots),
                        ("max_events", max_events),
                        ("max_rows", max_rows),
                        ("max_communities", max_communities)):
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        self.max_snapshots = int(max_snapshots)
        self.max_events = int(max_events)
        self.max_rows = int(max_rows)
        self.max_communities = int(max_communities)
        self._snaps: Dict[str, Deque[Snapshot]] = {}
        self._times: Dict[str, List[float]] = {}    # mirror for bisect
        self._comms: "OrderedDict[int, CommunityTimeline]" = OrderedDict()
        self._events: Deque[LifecycleEvent] = deque(maxlen=self.max_events)
        self.n_snapshots = 0
        self.n_events = 0
        self.n_truncated_communities = 0

    # -- writes ------------------------------------------------------------
    def record_snapshot(self, graph_id: str, t: float,
                        members: Sequence[Tuple[int, Members]],
                        events: Sequence[LifecycleEvent], *,
                        n_disconnected: int = 0):
        """Append one window: ``members`` is (persistent id, member map)
        per community; ``events`` the matcher's lifecycle decisions."""
        ext_all, cid_all = [], []
        for cid, mem in members:
            ext_all.extend(mem.keys())
            cid_all.extend([cid] * len(mem))
        ext = np.asarray(ext_all, np.int64)
        cid = np.asarray(cid_all, np.int64)
        order = np.argsort(ext, kind="stable")
        snap = Snapshot(t=float(t), ext=ext[order], cid=cid[order],
                        n_communities=len(members),
                        n_disconnected=int(n_disconnected))
        dq = self._snaps.setdefault(
            graph_id, deque(maxlen=self.max_snapshots))
        dq.append(snap)
        self._times[graph_id] = [s.t for s in dq]
        self.n_snapshots += 1

        for cid_, mem in members:
            tl = self._comms.get(cid_)
            if tl is None:
                tl = self._new_timeline(cid_, graph_id, t)
            tl.rows.append((float(t), len(mem),
                            float(sum(mem.values()))))
            while len(tl.rows) > self.max_rows:
                tl.rows.popleft()
            self._comms.move_to_end(cid_)
        for ev in events:
            self._events.append(ev)
            self.n_events += 1
            tl = self._comms.get(ev.community)
            if ev.kind in ("birth", "split"):
                if tl is None:
                    tl = self._new_timeline(ev.community, graph_id, ev.t)
                tl.parents = ev.parents
                tl.origin = ev.kind
                tl.born_t = ev.t
            elif ev.kind == "death" and tl is not None:
                tl.dead_t = ev.t
        self._cap_communities()

    def _cap_communities(self):
        """Cap resident community timelines: dead first, then oldest.

        The reference evicts one victim a loop iteration, each scanning
        the dict from the front for a dead timeline, which is quadratic
        when every community is alive, as at a first snapshot (ROADMAP
        C.9).  Evicting never changes whether a timeline is alive, so its
        victims are the first ``excess`` of: the dead timelines in dict
        order, then the alive ones in dict order.  One pass computes that
        same list."""
        excess = len(self._comms) - self.max_communities
        if excess <= 0:
            return
        victims = [k for k, v in self._comms.items() if not v.alive][:excess]
        if len(victims) < excess:
            alive = (k for k, v in self._comms.items() if v.alive)
            victims += itertools.islice(alive, excess - len(victims))
        for k in victims:
            del self._comms[k]
        self.n_truncated_communities += excess

    def _new_timeline(self, cid: int, graph_id: str,
                      t: float) -> CommunityTimeline:
        tl = CommunityTimeline(cid=cid, graph_id=graph_id, born_t=float(t))
        self._comms[cid] = tl
        return tl

    # -- reads -------------------------------------------------------------
    def snapshot_at(self, graph_id: str,
                    t: Optional[float] = None) -> Optional[Snapshot]:
        """Latest snapshot with ``t_snap <= t`` (None = latest overall)."""
        dq = self._snaps.get(graph_id)
        if not dq:
            return None
        if t is None:
            return dq[-1]
        times = self._times.get(graph_id, [])
        i = bisect.bisect_right(times, float(t)) - 1
        return dq[i] if i >= 0 else None

    def membership_at(self, graph_id: str, external: int,
                      t: Optional[float] = None) -> Optional[int]:
        """Persistent community id of a vertex as of time ``t`` (None =
        now); None when the vertex is unknown at that time or the window
        fell off the retention horizon."""
        snap = self.snapshot_at(graph_id, t)
        return None if snap is None else snap.membership(external)

    def snapshots(self, graph_id: str) -> List[Snapshot]:
        return list(self._snaps.get(graph_id, ()))

    def timeline(self, community_id: int) -> Optional[CommunityTimeline]:
        return self._comms.get(int(community_id))

    def communities(self, graph_id: Optional[str] = None, *,
                    alive_only: bool = False) -> List[CommunityTimeline]:
        out = []
        for tl in self._comms.values():
            if graph_id is not None and tl.graph_id != graph_id:
                continue
            if alive_only and not tl.alive:
                continue
            out.append(tl)
        return out

    def lifecycle_events(self, graph_id: Optional[str] = None, *,
                         kind: Optional[str] = None
                         ) -> List[LifecycleEvent]:
        return [e for e in self._events
                if (graph_id is None or e.graph_id == graph_id)
                and (kind is None or e.kind == kind)]

    def drop_graph(self, graph_id: str) -> int:
        """Explicit retention control: forget a graph's snapshots,
        community rows and events.  This — not ResultStore eviction — is
        the ONLY way timeline history goes away besides the bounded
        deques rolling over."""
        n = len(self._snaps.pop(graph_id, ()))
        self._times.pop(graph_id, None)
        for cid in [c for c, tl in self._comms.items()
                    if tl.graph_id == graph_id]:
            del self._comms[cid]
        self._events = deque(
            (e for e in self._events if e.graph_id != graph_id),
            maxlen=self.max_events)
        return n
