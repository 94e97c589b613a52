"""Temporal community tracking: the service-side timeline manager (port of
``repro/timeline/tracker.py``).

:class:`TimelineManager` turns the service's store commits into a
community *timeline*.  It hangs off the :class:`repro_torch.service.store.
ResultStore` commit hook (``on_commit``), so every path that refreshes
an entry — fresh detects, immediate warm updates, the batched update
path, deferred-compaction flushes — lands here exactly once, with the
:class:`~repro_torch.service.store.UpdatePlan` that produced it:

1. the plan's ``id_map`` (and deferred tombstones) fold into the
   graph's :class:`repro_torch.timeline.idmap.ExternalIdMap`, so vertices
   keep their external ids across arbitrarily many compactions;
2. the committed membership is regrouped into external-id member sets
   (deferred tombstones excluded), on the host: the entry's graph may lie
   on the card, and is read once;
3. the weighted-Jaccard matcher (:mod:`repro_torch.timeline.matcher`)
   assigns persistent community ids against the previous snapshot and
   emits lifecycle events;
4. the snapshot, community rows and events land in the bounded
   :class:`repro_torch.timeline.store.TimelineStore`, subscribers are
   notified, and telemetry counters/histograms tick.

Timeline retention is governed HERE (``TimelineConfig`` bounds), never
by ResultStore eviction: an LRU/TTL-evicted compute entry keeps its
history queryable until :meth:`TimelineManager.drop_graph` or the
bounded deques roll over.

:func:`translate_window` + :class:`WindowedIngest` are the ingestion
side: they fold a window of external-id graph events — any records with
``t``, ``kind``, ``u``, ``v`` and ``w``, such as
:class:`repro_torch.data.streams.GraphEvent` or the reference's — into
ONE :class:`repro_torch.core.dynamic.GraphUpdate` in the service's
internal id space, mirroring the compaction contract (and the store's
deferred-compaction flush rule) deterministically so client and service
never need an id handshake.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dynamic import GraphUpdate, _host_array
from repro_torch.timeline.idmap import ExternalIdMap, compose_batch_maps
from repro_torch.timeline.matcher import (
    LifecycleEvent, Members, match_snapshots,
)
from repro_torch.timeline.store import (
    CommunityTimeline, Snapshot, TimelineStore,
)


@dataclasses.dataclass(frozen=True)
class TimelineConfig:
    """Matcher + retention knobs (mirrored from the service's config)."""

    jaccard_min: float = 0.1
    weight_by_degree: bool = False
    max_snapshots: int = 64
    max_events: int = 4096
    max_rows: int = 256
    max_communities: int = 4096

    def __post_init__(self):
        if not (0.0 < self.jaccard_min <= 1.0):
            raise ValueError(
                f"jaccard_min must be in (0, 1], got {self.jaccard_min}")


class _Track:
    """Per-graph tracking state (guarded by the manager lock)."""

    __slots__ = ("idmap", "prev", "dead")

    def __init__(self, idmap: ExternalIdMap):
        self.idmap = idmap
        self.prev: Dict[int, Members] = {}   # persistent id -> members
        self.dead: set = set()               # deferred tombstone internals


class TimelineManager:
    """Thread-safe: commits arrive on the compute thread, queries and
    subscriptions from anywhere."""

    def __init__(self, config: Optional[TimelineConfig] = None, *,
                 telemetry=None, clock=None):
        import time
        self.config = config or TimelineConfig()
        self.telemetry = telemetry
        self.clock = clock or time.time
        self.store = TimelineStore(
            max_snapshots=self.config.max_snapshots,
            max_events=self.config.max_events,
            max_rows=self.config.max_rows,
            max_communities=self.config.max_communities)
        self._lock = threading.RLock()
        self._graphs: Dict[str, _Track] = {}
        self._times: Dict[str, float] = {}        # pending snapshot stamps
        self._pending_maps: Dict[str, Tuple[np.ndarray, int]] = {}
        self._pending_adds: Dict[str, List[int]] = {}
        self._next_cid = 0
        self._subs: List[Callable[[List[LifecycleEvent]], None]] = []
        self.n_snapshots = 0
        self.n_lifecycle = 0
        self.n_idmap_resets = 0
        self.n_binding_mismatches = 0
        self.n_subscriber_errors = 0

    # -- ingestion-side hints ---------------------------------------------
    def set_time(self, graph_id: str, t: Optional[float]):
        """Stamp the NEXT commit for ``graph_id`` with event-time ``t``
        (the window end).  Unstamped commits use wall-clock time."""
        with self._lock:
            if t is None:
                self._times.pop(graph_id, None)
            else:
                self._times[graph_id] = float(t)

    def ensure_track(self, graph_id: str, n: int) -> ExternalIdMap:
        """The graph's live :class:`ExternalIdMap`, creating identity
        tracking over ``[0, n)`` on first sight (the ingest side needs
        the map to translate a window BEFORE the first commit it
        observes)."""
        with self._lock:
            trk = self._graphs.get(graph_id)
            if trk is None:
                trk = _Track(ExternalIdMap(int(n)))
                self._graphs[graph_id] = trk
            return trk.idmap

    def register_pending_adds(self, graph_id: str, externals: Sequence[int]):
        """Bind client-chosen external ids to the vertex-addition slots of
        the next commit, in claim order."""
        with self._lock:
            self._pending_adds[graph_id] = [int(e) for e in externals]

    def register_rebucket(self, graph_id: str, batches, n_nodes: int):
        """A capacity overflow re-routed ``batches`` into a fresh detect
        (the front end's rebucket
        continuation).  Record the composed old->new id map so the
        detect's commit extends the external-id history instead of
        resetting it."""
        id_map, n_final = compose_batch_maps(int(n_nodes), batches)
        with self._lock:
            self._pending_maps[graph_id] = (id_map, n_final)

    # -- the commit hook ---------------------------------------------------
    def observe_commit(self, graph_id: str, entry, plan) -> None:
        """ResultStore ``on_commit``: fold the remap, match communities,
        record the snapshot.  ``plan`` is None for fresh detect puts."""
        events: List[LifecycleEvent] = []
        with self._lock:
            t = self._times.pop(graph_id, None)
            if t is None:
                t = float(self.clock())
            pending_adds = self._pending_adds.pop(graph_id, None)
            n = int(entry.graph.n_nodes)
            trk = self._fold_idmap(graph_id, entry, plan, n, pending_adds)
            new_members = self._extract_members(entry, trk, n)
            labels = sorted(new_members)
            member_list = [new_members[lab] for lab in labels]
            assigned, events = match_snapshots(
                trk.prev, member_list, t=t, graph_id=graph_id,
                jaccard_min=self.config.jaccard_min,
                next_id=self._mint, on_overlap=self._observe_overlap)
            trk.prev = {assigned[i]: member_list[i]
                        for i in range(len(member_list))}
            self.store.record_snapshot(
                graph_id, t, list(zip(assigned, member_list)), events,
                n_disconnected=int(entry.n_disconnected))
            self.n_snapshots += 1
            self.n_lifecycle += len(events)
        if self.telemetry is not None:
            self.telemetry.counter("timeline_snapshots", 1)
            kinds: Dict[str, int] = {}
            for ev in events:
                kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
            for kind, k in kinds.items():
                self.telemetry.counter("timeline_events", k,
                                       {"kind": kind})
        if events:
            for fn in list(self._subs):
                try:
                    fn(events)
                except Exception:
                    self.n_subscriber_errors += 1

    def _fold_idmap(self, graph_id: str, entry, plan, n: int,
                    pending_adds: Optional[List[int]]) -> _Track:
        trk = self._graphs.get(graph_id)
        if plan is None:
            pending = self._pending_maps.pop(graph_id, None)
            if trk is None:
                trk = _Track(ExternalIdMap(n))
                self._graphs[graph_id] = trk
            elif pending is not None:
                id_map, n_final = pending
                if n_final != n:
                    # the rebucket rebuild diverged from what we composed
                    # (shouldn't happen); reset rather than corrupt
                    self.n_idmap_resets += 1
                    trk.idmap = ExternalIdMap(n)
                else:
                    self._apply_map(trk, id_map, n, pending_adds)
                trk.dead.clear()
            elif trk.idmap.n_slots == n and not trk.dead:
                pass   # same vertex set re-detected (edge-overflow rebucket)
            else:
                # the client replaced the graph wholesale: externals from
                # the old life are unrecoverable, start a fresh id space
                self.n_idmap_resets += 1
                trk.idmap = ExternalIdMap(n)
                trk.dead.clear()
            return trk
        if trk is None:                      # update before any detect seen
            trk = _Track(ExternalIdMap(n))
            self._graphs[graph_id] = trk
            return trk
        self._apply_map(trk, plan.id_map, n, pending_adds)
        deferred_removed = getattr(plan, "deferred_removed", None)
        if deferred_removed is not None and len(deferred_removed):
            trk.idmap.retire_internal(np.asarray(deferred_removed))
        deferred_after = getattr(entry, "deferred", None)
        trk.dead = (set(np.asarray(deferred_after).tolist())
                    if deferred_after is not None else set())
        return trk

    def _apply_map(self, trk: _Track, id_map, n: int,
                   pending_adds: Optional[List[int]]):
        if id_map is None and trk.idmap.n_slots == n and not pending_adds:
            return
        fresh, _ = trk.idmap.apply(id_map, n, fresh_ids=pending_adds)
        if pending_adds and fresh != list(pending_adds):
            self.n_binding_mismatches += 1

    def _extract_members(self, entry, trk: _Track,
                         n: int) -> Dict[int, Members]:
        """The committed membership as external-id member sets, each in
        increasing internal id (the reference's insertion order, which
        fixes the order its sums of weights fold in).  The entry's arrays
        may lie on a device: they are read to the host once."""
        if trk.idmap.n_slots != n:
            # defensive resync (a commit observed without its remap, e.g.
            # a hook registered mid-life); grow/shrink via identity
            self.n_idmap_resets += 1
            trk.idmap.apply(None, n)
        ext = trk.idmap.externals()
        C = _host_array(entry.C)[:n]
        if self.config.weight_by_degree:
            # numpy's float64 fold on host copies, as the reference folds
            # (a device index_add_ has no fixed order)
            g = entry.graph
            src, w = _host_array(g.src), _host_array(g.w)
            sel = src < g.n_cap
            deg = np.bincount(src[sel], weights=w[sel], minlength=n)[:n]
            weight = np.maximum(deg, 1.0)
        else:
            weight = np.ones(n)
        live = np.flatnonzero(ext >= 0)      # deferred tombstones excluded
        idx = live[np.argsort(C[live], kind="stable")]
        lab = C[idx]
        cuts = (np.flatnonzero(lab[1:] != lab[:-1]) + 1).tolist()
        labs, exts, ws = lab.tolist(), ext[idx].tolist(), weight[idx].tolist()
        return {labs[a]: dict(zip(exts[a:b], ws[a:b]))
                for a, b in zip([0] + cuts, cuts + [len(labs)]) if a < b}

    def _mint(self) -> int:
        cid = self._next_cid
        self._next_cid += 1
        return cid

    def _observe_overlap(self, j: float):
        if self.telemetry is not None:
            self.telemetry.observe("matcher_overlap", j)

    # -- queries -----------------------------------------------------------
    def membership_at(self, graph_id: str, external: int,
                      t: Optional[float] = None) -> Optional[int]:
        with self._lock:
            return self.store.membership_at(graph_id, external, t)

    def timeline(self, community_id: int) -> Optional[CommunityTimeline]:
        with self._lock:
            return self.store.timeline(community_id)

    def communities(self, graph_id: Optional[str] = None, *,
                    alive_only: bool = False) -> List[CommunityTimeline]:
        with self._lock:
            return self.store.communities(graph_id, alive_only=alive_only)

    def lifecycle_events(self, graph_id: Optional[str] = None, *,
                         kind: Optional[str] = None) -> List[LifecycleEvent]:
        with self._lock:
            return self.store.lifecycle_events(graph_id, kind=kind)

    def snapshots(self, graph_id: str) -> List[Snapshot]:
        with self._lock:
            return self.store.snapshots(graph_id)

    def external_ids(self, graph_id: str) -> Optional[np.ndarray]:
        with self._lock:
            trk = self._graphs.get(graph_id)
            return None if trk is None else trk.idmap.externals()

    def internal_of(self, graph_id: str, external: int) -> Optional[int]:
        with self._lock:
            trk = self._graphs.get(graph_id)
            return None if trk is None else trk.idmap.internal_of(external)

    def subscribe(self, fn: Callable[[List[LifecycleEvent]], None]
                  ) -> Callable[[List[LifecycleEvent]], None]:
        with self._lock:
            self._subs.append(fn)
        return fn

    def unsubscribe(self, fn) -> bool:
        with self._lock:
            try:
                self._subs.remove(fn)
                return True
            except ValueError:
                return False

    def drop_graph(self, graph_id: str) -> int:
        """The ONE retention control for timeline history (ResultStore
        eviction intentionally does not reach here)."""
        with self._lock:
            self._graphs.pop(graph_id, None)
            self._times.pop(graph_id, None)
            self._pending_maps.pop(graph_id, None)
            self._pending_adds.pop(graph_id, None)
            return self.store.drop_graph(graph_id)

    # -- checkpointing ------------------------------------------------------
    def state(self) -> Tuple[Dict[str, np.ndarray], dict]:
        """Snapshot every durable tracking structure.

        Returns ``(arrays, meta)``: bulky state (id maps, snapshot
        membership, matcher prev-sets, community rows) as a flat dict of
        numpy arrays, everything else JSON-able in ``meta`` — the split
        :func:`repro_torch.checkpoint.store.save_checkpoint` wants.  Transient
        per-commit hints (pending snapshot stamps, pending add bindings,
        rebucket maps) are deliberately NOT captured: checkpoint at a
        quiescent point (no in-flight window).
        """
        with self._lock:
            arrays: Dict[str, np.ndarray] = {}
            gids = sorted(self._graphs)
            meta: dict = {
                "graphs": gids,
                "next_cid": int(self._next_cid),
                "counters": dict(
                    n_snapshots=int(self.n_snapshots),
                    n_lifecycle=int(self.n_lifecycle),
                    n_idmap_resets=int(self.n_idmap_resets),
                    n_binding_mismatches=int(self.n_binding_mismatches),
                    n_subscriber_errors=int(self.n_subscriber_errors)),
                "idmap_next": {},
            }
            for gi, gid in enumerate(gids):
                trk = self._graphs[gid]
                ext, nxt, retired = trk.idmap.state()
                arrays[f"g{gi}.idmap_ext"] = ext
                arrays[f"g{gi}.idmap_retired"] = retired
                meta["idmap_next"][gid] = int(nxt)
                arrays[f"g{gi}.dead"] = np.asarray(
                    sorted(trk.dead), np.int64)
                pid, pext, pw = [], [], []
                for p in sorted(trk.prev):
                    for e, w in trk.prev[p].items():
                        pid.append(p)
                        pext.append(e)
                        pw.append(w)
                arrays[f"g{gi}.prev_pid"] = np.asarray(pid, np.int64)
                arrays[f"g{gi}.prev_ext"] = np.asarray(pext, np.int64)
                arrays[f"g{gi}.prev_w"] = np.asarray(pw, np.float64)
            st = self.store
            meta["store_counters"] = dict(
                n_snapshots=int(st.n_snapshots),
                n_events=int(st.n_events),
                n_truncated_communities=int(st.n_truncated_communities))
            sgids = sorted(st._snaps)
            meta["snap_graphs"] = sgids
            meta["snap_meta"] = {}
            for si, gid in enumerate(sgids):
                rows = []
                for j, s in enumerate(st._snaps[gid]):
                    arrays[f"s{si}.{j}.ext"] = np.asarray(s.ext, np.int64)
                    arrays[f"s{si}.{j}.cid"] = np.asarray(s.cid, np.int64)
                    rows.append(dict(t=float(s.t),
                                     n_communities=int(s.n_communities),
                                     n_disconnected=int(s.n_disconnected)))
                meta["snap_meta"][gid] = rows
            comms = []
            for ci, (cid, tl) in enumerate(st._comms.items()):
                comms.append(dict(
                    cid=int(cid), graph_id=tl.graph_id,
                    born_t=float(tl.born_t),
                    dead_t=(None if tl.dead_t is None else float(tl.dead_t)),
                    parents=[int(p) for p in tl.parents],
                    origin=tl.origin))
                arrays[f"c{ci}.rows"] = np.asarray(
                    [list(r) for r in tl.rows], np.float64).reshape(-1, 3)
            meta["communities"] = comms
            meta["events"] = [dict(
                kind=e.kind, t=float(e.t), graph_id=e.graph_id,
                community=int(e.community),
                parents=[int(p) for p in e.parents],
                overlap=float(e.overlap), size=int(e.size))
                for e in st._events]
            return arrays, meta

    def load_state(self, arrays: Dict[str, np.ndarray], meta: dict):
        """Replace ALL tracking state with a :meth:`state` snapshot (the
        restore half — wipe-and-load, not a merge)."""
        from collections import deque

        with self._lock:
            self._graphs.clear()
            self._times.clear()
            self._pending_maps.clear()
            self._pending_adds.clear()
            self._next_cid = int(meta["next_cid"])
            for k, v in meta["counters"].items():
                setattr(self, k, int(v))
            for gi, gid in enumerate(meta["graphs"]):
                trk = _Track(ExternalIdMap.from_state(
                    arrays[f"g{gi}.idmap_ext"],
                    meta["idmap_next"][gid],
                    arrays[f"g{gi}.idmap_retired"]))
                trk.dead = set(
                    int(x) for x in arrays[f"g{gi}.dead"].tolist())
                prev: Dict[int, Members] = {}
                for p, e, w in zip(arrays[f"g{gi}.prev_pid"].tolist(),
                                   arrays[f"g{gi}.prev_ext"].tolist(),
                                   arrays[f"g{gi}.prev_w"].tolist()):
                    prev.setdefault(int(p), {})[int(e)] = float(w)
                trk.prev = prev
                self._graphs[gid] = trk
            st = self.store
            for k, v in meta["store_counters"].items():
                setattr(st, k, int(v))
            st._snaps.clear()
            st._times.clear()
            for si, gid in enumerate(meta["snap_graphs"]):
                dq = deque(maxlen=st.max_snapshots)
                for j, row in enumerate(meta["snap_meta"][gid]):
                    dq.append(Snapshot(
                        t=float(row["t"]),
                        ext=np.asarray(arrays[f"s{si}.{j}.ext"], np.int64),
                        cid=np.asarray(arrays[f"s{si}.{j}.cid"], np.int64),
                        n_communities=int(row["n_communities"]),
                        n_disconnected=int(row["n_disconnected"])))
                st._snaps[gid] = dq
                st._times[gid] = [s.t for s in dq]
            st._comms.clear()
            for ci, cm in enumerate(meta["communities"]):
                rows = arrays[f"c{ci}.rows"]
                st._comms[int(cm["cid"])] = CommunityTimeline(
                    cid=int(cm["cid"]), graph_id=cm["graph_id"],
                    born_t=float(cm["born_t"]),
                    dead_t=(None if cm["dead_t"] is None
                            else float(cm["dead_t"])),
                    parents=tuple(int(p) for p in cm["parents"]),
                    origin=cm["origin"],
                    rows=deque(
                        [(float(r[0]), int(r[1]), float(r[2]))
                         for r in rows.tolist()]))
            st._events = deque(
                (LifecycleEvent(
                    kind=e["kind"], t=float(e["t"]),
                    graph_id=e["graph_id"], community=int(e["community"]),
                    parents=tuple(int(p) for p in e["parents"]),
                    overlap=float(e["overlap"]), size=int(e["size"]))
                 for e in meta["events"]),
                maxlen=st.max_events)


def translate_window(events, *, idmap: ExternalIdMap, entry,
                     compact_window: int = 0
                     ) -> Tuple[GraphUpdate, dict]:
    """Fold one window of external-id events into ONE internal-id
    :class:`GraphUpdate`, mirroring the service's id contract.

    Window folding is set-semantics for vertex ops (a vertex added then
    removed inside the window cancels, with its edges) and net-delta
    semantics for edges (an edge added then deleted nets to nothing).
    Edge endpoints referencing a vertex removed in the same window — or
    never known — are dropped and counted.

    The translation mirrors :func:`repro_torch.core.dynamic.
    apply_vertex_updates`' compaction contract exactly: with
    ``compact_window == 0`` removals shift surviving internals down and
    additions claim ``[n', n'+add)``; with deferral on, ids do NOT
    shift, additions claim ``[n, n+add)``, and the store's
    flush-at-fold-start rule (pending >= window, or additions would
    overflow ``n_cap``) is re-derived here so predicted ids match the
    post-flush space.

    Returns ``(update, stats)``; ``stats['adds_ext']`` lists the client
    externals for the claimed slots in order (feed it to
    :meth:`TimelineManager.register_pending_adds`).
    """
    events = list(events)
    adds: List[int] = []
    removes: List[int] = []
    removed_ext: set = set()
    cancelled: set = set()
    edges: "Dict[Tuple[int, int], float]" = {}
    edge_order: List[Tuple[int, int]] = []
    dropped_vertices = dropped_edges = 0
    add_set: set = set()
    for ev in events:
        kind = ev.kind
        if kind == "vertex_add":
            e = int(ev.u)
            if e in add_set or e in idmap or idmap.is_retired(e):
                dropped_vertices += 1
                continue
            adds.append(e)
            add_set.add(e)
        elif kind == "vertex_del":
            e = int(ev.u)
            if e in add_set:
                add_set.discard(e)
                adds.remove(e)
                cancelled.add(e)
            elif e not in removed_ext and idmap.internal_of(e) is not None:
                removes.append(e)
                removed_ext.add(e)
            else:
                dropped_vertices += 1
        elif kind in ("edge_add", "edge_delta", "edge_del"):
            a, b = int(ev.u), int(ev.v)
            key = (a, b) if a <= b else (b, a)
            dw = float(ev.w) if kind != "edge_del" else -float(ev.w)
            if key not in edges:
                edge_order.append(key)
                edges[key] = 0.0
            edges[key] += dw
        else:
            raise ValueError(f"unknown graph event kind {kind!r}")

    n = int(entry.graph.n_nodes)
    n_cap = int(entry.graph.n_cap)
    deferred = getattr(entry, "deferred", None)
    dead = (np.asarray(deferred, np.int64)
            if deferred is not None else np.empty(0, np.int64))
    defer = int(compact_window) > 0
    # mirror ResultStore's flush-at-fold-start rule exactly (including
    # knob-off with leftover tombstones, e.g. after a checkpoint restore
    # under a different compact_window)
    flush = bool(dead.size
                 and (not defer or dead.size >= int(compact_window)
                      or n + len(adds) > n_cap))
    shift = None
    if flush:
        alive = np.ones(n, bool)
        alive[dead] = False
        shift = np.cumsum(alive) - 1          # pre-flush id -> post-flush
        n -= int(dead.size)

    def current(i: int) -> int:
        return int(shift[i]) if shift is not None else int(i)

    r_int = sorted(current(idmap.internal_of(e)) for e in removes)
    if defer:
        base = n
        rs = None
    else:
        base = n - len(r_int)
        rs = r_int
    add_idx = {e: base + k for k, e in enumerate(adds)}

    u_out, v_out, w_out = [], [], []
    for key in edge_order:
        dw = edges[key]
        if dw == 0.0:
            continue
        ids = []
        ok = True
        for e in key:
            if e in removed_ext or e in cancelled:
                ok = False
                break
            if e in add_idx:
                ids.append(add_idx[e])
                continue
            i = idmap.internal_of(e)
            if i is None:
                ok = False
                break
            i = current(i)
            if rs is not None:
                i -= bisect.bisect_left(rs, i)
            ids.append(i)
        if not ok:
            dropped_edges += 1
            continue
        u_out.append(ids[0])
        v_out.append(ids[1])
        w_out.append(dw)

    upd = GraphUpdate(
        u=np.asarray(u_out, np.int32), v=np.asarray(v_out, np.int32),
        dw=np.asarray(w_out, np.float32), add=len(adds),
        remove=np.asarray(r_int, np.int64))
    stats = dict(
        n_events=len(events),
        adds_ext=list(adds), n_removed=len(r_int),
        n_edges=len(u_out), dropped_edges=dropped_edges,
        dropped_vertices=dropped_vertices, flush_predicted=flush)
    return upd, stats


class WindowedIngest:
    """Time-window batcher over a front end's ``ingest_window(graph_id,
    events, t=, tenant=)`` (any object with that method, such as
    :class:`repro_torch.service.frontend.ServiceFrontend`).

    Feed it a nondecreasing-``t`` stream of graph events; whenever an
    event crosses the current window boundary the buffered window commits
    as one snapshot (empty windows commit too — a quiet window is still a
    window, and its snapshot is all continuations).  The front end must
    commit one update batch a window — coarser update batching would fold
    several windows into one snapshot.
    """

    def __init__(self, frontend, graph_id: str, *, window: float,
                 t0: float = 0.0, tenant: Optional[str] = None):
        if window <= 0:
            raise ValueError(f"window must be > 0, got {window}")
        self.frontend = frontend
        self.graph_id = graph_id
        self.window = float(window)
        self.tenant = tenant
        self._end = float(t0) + self.window
        self._buf: List = []
        self.n_windows = 0
        self.n_events = 0

    def ingest(self, event) -> List:
        """Buffer one event; returns the futures of any windows its
        timestamp closed (usually empty or one)."""
        out = []
        while float(event.t) >= self._end:
            out.append(self._commit())
        self._buf.append(event)
        self.n_events += 1
        return out

    def flush(self):
        """Commit the current (partial) window; returns its future."""
        return self._commit()

    def _commit(self):
        events, self._buf = self._buf, []
        t = self._end
        self._end += self.window
        self.n_windows += 1
        kw = {} if self.tenant is None else {"tenant": self.tenant}
        return self.frontend.ingest_window(self.graph_id, events, t=t, **kw)
