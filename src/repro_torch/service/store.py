"""Incremental result store (port of ``repro/service/store.py``):
partitions + stats per graph, with versioned invalidation, a fully-dynamic
delta-screening update path, and LRU/TTL eviction.

The store keeps, per graph id, the bucket-padded graph, its current dense
membership, detection stats, and a monotonically increasing version.
Updates do NOT trigger a full recompute: they route through the
delta-screening warm start
(:func:`repro_torch.core.dynamic.warm_update`), which perturbs only the
neighborhood of the touched region and re-runs the split so the
no-disconnected-communities guarantee survives updates.  An update
batch is a :class:`repro_torch.core.dynamic.GraphUpdate` (or a legacy
``(u, v, dw)`` tuple = edges only): **vertex ops first** — removals
delete every incident edge, tombstone the id and compact it away (the
order-preserving remap of :func:`repro_torch.core.dynamic.
apply_vertex_updates`), additions claim padding slots and grow
``n_nodes`` — then **signed edge weight-deltas**: positive deltas add
weight / insert edges, negative deltas decrease weight, and an edge
driven to ``<= 0`` is deleted (its capacity slot is compacted back into
the padding pool for reuse).  Edge endpoint ids are bounds-checked
against the post-rewrite ``n_nodes`` before any state is touched; ids in
``[n_nodes, n_cap)`` are legal only once claimed through the
vertex-addition path.  If an update overflows the bucket's edge capacity
— or vertex additions overflow ``n_cap`` — the entry is invalidated and
the caller falls back to a fresh detect request (re-bucketing).

The update path is split in two so the service can batch it:

* :meth:`ResultStore.prepare_update` — host-side: validate, apply the COO
  rewrite, build the touched mask; returns an :class:`UpdatePlan`.
* :meth:`ResultStore.commit_update` — write the refreshed entry from the
  warm-path outputs.

:meth:`ResultStore.apply_update` composes the two around one
:func:`repro_torch.core.dynamic.warm_update` call on the store's device
(the immediate path); the batched path runs the same function for each
graph of a batch
(:meth:`repro_torch.service.engine.BatchedLouvainEngine.update_batch`)
between the same prepare/commit, so both produce identical partitions.

Where arrays live: the store keeps each graph where the caller's put or
:func:`~repro_torch.core.dynamic.prepare_graph_update` leaves it (the host
fold reads it once and writes it back to its device), the memberships as
numpy on the host, and runs the warm update on ``device`` (``None`` =
CUDA; raises when CUDA is absent).

Deferred compaction: ``compact_window > 0`` turns vertex removals
into *tombstones* — incident edges are deleted immediately (results are
correct right away: a tombstone is an edgeless own-label singleton that
cannot affect modularity or connectivity) but the O(m log m) remap/COO
rewrite is paid once per window, at fold start, when the pending set
reaches ``compact_window`` or additions would overflow ``n_cap`` (or
explicitly via :meth:`ResultStore.flush_compaction`).  Until the flush,
``n_communities`` is inflated by one per tombstone
(:attr:`StoreEntry.n_live_communities` subtracts them) and internal ids
do NOT shift; the flush publishes the composed remap through the commit
hook so a timeline tracker (``repro/timeline/``) keeps external
ids stable.  ``compact_window == 0`` (default) keeps the exact
immediate-compaction semantics.

Eviction:

* ``max_entries`` caps residency with LRU order — ``get``/``apply_update``
  refresh recency, ``put`` evicts the least-recently-used entry past the
  cap (``n_evicted``).
* ``ttl_s`` expires entries at read time relative to their last ``put``
  (``n_expired``).

Version counters intentionally survive eviction (they are one int per
graph id ever seen) so a re-detected graph keeps monotone versions.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.api import DetectOptions
from repro_torch.core.dynamic import (
    CapacityError, GraphUpdate, HostGraph, _host_array, apply_edge_updates,
    apply_vertex_updates, as_update, check_vertex_ids, directed_deltas,
    gross_deleted, prepare_graph_update, tombstone_vertices, touched_mask,
    warm_update,
)
from repro_torch.device import resolve_device
from repro_torch.graph.container import Graph
from repro_torch.service.buckets import Bucket, bucket_of


def _empty_ids() -> np.ndarray:
    return np.empty(0, np.int64)


@dataclasses.dataclass
class StoreEntry:
    graph: Graph
    C: np.ndarray                  # int32[nv] dense membership
    bucket: Bucket
    version: int
    n_communities: int
    n_disconnected: int
    q: float
    t_stored: float = 0.0          # clock time of the last put (TTL basis)
    # deferred-compaction tombstones: internal ids removed from the graph
    # (edgeless own-label singletons) but not yet compacted away; sorted.
    # Each inflates n_communities by one until the flush subtracts it.
    deferred: np.ndarray = dataclasses.field(default_factory=_empty_ids)
    # producing portfolio tier + the full options identity it was computed
    # under (DetectOptions.result_key).  The warm path checks the key and
    # refuses to continue a partition produced under a different tier or
    # backend configuration (see OptionsMismatch) — silently refining a
    # fast-tier partition with the standard warm path would hand out a
    # result whose QualityContract lies about its provenance.
    algorithm: str = "standard"
    cache_key: Optional[tuple] = None

    @property
    def n_live_communities(self) -> int:
        """Community count net of deferred-tombstone singletons."""
        return int(self.n_communities) - int(self.deferred.size)


@dataclasses.dataclass
class UpdatePlan:
    """A prepared (host-side) warm update awaiting device compute."""

    graph_id: str
    graph: Graph                   # bucket-padded, rewrites already applied
    C_prev: np.ndarray             # int32[nv] membership before the update
    touched: np.ndarray            # bool[nv] screening seed
    bucket: Bucket
    scan: str                      # dense/sort choice for this bucket
    n_deleted: int                 # directed entries removed by the batch
    version: int = 0               # entry version the plan was prepared from
    n_added: int = 0               # vertices claimed from padding slots
    n_removed: int = 0             # vertices tombstoned + compacted away
    # composed old->new vertex id map across the folded batches (None when
    # no batch carried vertex ops; -1 marks removed ids)
    id_map: Optional[np.ndarray] = None
    # deferred-compaction bookkeeping: ids tombstoned by THIS plan (in the
    # plan's post-flush id space), the tombstone set the committed entry
    # will carry, and how many old tombstones the fold's flush compacted
    deferred_removed: Optional[np.ndarray] = None
    deferred_after: Optional[np.ndarray] = None
    n_flushed: int = 0

    def __post_init__(self):
        if self.deferred_removed is None:
            self.deferred_removed = _empty_ids()
        if self.deferred_after is None:
            self.deferred_after = _empty_ids()


class CapacityExceeded(Exception):
    """Update does not fit the entry's bucket (edge slots or vertex
    capacity); re-bucket + recompute."""


class OptionsMismatch(CapacityExceeded):
    """The stored partition was produced under a different options
    identity (portfolio tier / backend key) than the store's warm path
    runs under.  Warm-updating it would cross tiers, so the entry is
    invalidated and the caller must re-detect the updated graph — the
    same continuation as a capacity overflow, hence the subclassing."""


class ResultStore:
    def __init__(self, *, options: Optional[DetectOptions] = None,
                 max_entries: Optional[int] = None,
                 ttl_s: Optional[float] = None, clock=None,
                 compact_window: int = 0, on_commit=None, on_evict=None,
                 device=None):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        if compact_window < 0:
            raise ValueError(
                f"compact_window must be >= 0, got {compact_window}")
        self._entries: "OrderedDict[str, StoreEntry]" = OrderedDict()
        # versions survive invalidation AND eviction so they stay monotone
        # per graph id across rebucket/evict -> fresh detect -> put
        self._versions: Dict[str, int] = {}
        # LRU made get() a writer (move_to_end / TTL expiry), and the async
        # front end reads results on the event loop while the compute
        # thread puts — every OrderedDict mutation takes this lock
        self._lock = threading.RLock()
        # one DetectOptions record carries the scan crossover for warm
        # updates (the engine's batched path carries its own copy of the
        # same choice)
        self.device = resolve_device(device)
        self.options = options if options is not None else DetectOptions()
        self.max_entries = max_entries
        self.ttl_s = ttl_s
        self.clock = clock or time.perf_counter
        # deferred compaction: with compact_window > 0 vertex removals are
        # tombstoned (no remap) and the compaction is paid once per window
        # of removals — at fold start when the pending set reaches the
        # window, when additions would overflow n_cap, or explicitly via
        # flush_compaction().  0 = immediate semantics (the default).
        self.compact_window = int(compact_window)
        # commit hook: called as on_commit(graph_id, entry, plan) OUTSIDE
        # the store lock after every put that publishes fresh results —
        # plan is None for fresh detect puts, the UpdatePlan for warm
        # commits, and a synthetic flush plan for flush_compaction().
        # Exceptions are swallowed + counted (the store must not die for
        # a subscriber).
        self.on_commit = on_commit
        # eviction hook: called as on_evict(graph_id, entry) for entries
        # dropped by LRU pressure (still-warm state the auto-checkpointer
        # writes back into snapshots).  TTL expiries do NOT fire it —
        # an expired entry aged out on purpose.  Fired right after the
        # evicting put's lock scope; on the commit_update -> put nesting
        # the outer RLock is still held, so the hook must not call back
        # into the store.  Exceptions are swallowed + counted.
        self.on_evict = on_evict
        self.n_warm_updates = 0
        self.n_invalidations = 0
        self.n_evicted = 0
        self.n_expired = 0
        self.n_deletions = 0          # directed entries removed by updates
        self.n_vertex_added = 0       # vertices claimed via updates
        self.n_vertex_removed = 0     # vertices tombstoned via updates
        # commits dropped because the entry moved on (evicted/invalidated/
        # re-detected) between prepare_update and commit_update
        self.n_stale_commits = 0
        self.n_deferred_removed = 0   # vertices tombstoned awaiting flush
        self.n_compaction_flushes = 0
        self.n_commit_hook_errors = 0
        self.last_hook_error: Optional[str] = None
        # (bucket, tau, max_iters, scan) of each warm update run so far: a
        # trace's "compile" span is the first run of a key (no executable
        # stands behind it; the first run loads the kernels)
        self._warm_keys: set = set()

    def _fire(self, graph_id: str, entry: StoreEntry,
              plan: Optional["UpdatePlan"]) -> None:
        """Run the commit hook outside the lock; never let it raise."""
        if self.on_commit is None:
            return
        try:
            self.on_commit(graph_id, entry, plan)
        except Exception as e:          # noqa: BLE001 — subscriber fault
            self.n_commit_hook_errors += 1
            self.last_hook_error = repr(e)

    # -- basic CRUD -------------------------------------------------------
    def put(self, graph_id: str, graph: Graph, C: np.ndarray, *,
            n_communities: int, n_disconnected: int, q: float,
            algorithm: Optional[str] = None, deferred=None,
            _notify: bool = True) -> StoreEntry:
        alg = self.options.algorithm if algorithm is None else algorithm
        evicted = []
        with self._lock:
            version = self._versions.get(graph_id, 0) + 1
            self._versions[graph_id] = version
            entry = StoreEntry(
                graph=graph, C=_host_array(C), bucket=bucket_of(graph),
                version=version,
                n_communities=n_communities, n_disconnected=n_disconnected,
                q=q, t_stored=self.clock(),
                deferred=np.sort(np.asarray(
                    deferred if deferred is not None else (), np.int64)),
                algorithm=alg,
                cache_key=self.options.result_key(algorithm=alg),
            )
            self._entries[graph_id] = entry
            self._entries.move_to_end(graph_id)
            if self.max_entries is not None:
                while len(self._entries) > self.max_entries:
                    evicted.append(self._entries.popitem(last=False))
                    self.n_evicted += 1
        if self.on_evict is not None:
            for gid_e, entry_e in evicted:
                try:
                    self.on_evict(gid_e, entry_e)
                except Exception as e:  # noqa: BLE001 — subscriber fault
                    self.n_commit_hook_errors += 1
                    self.last_hook_error = repr(e)
        # a direct put IS a fresh-detect publish; warm commits route the
        # plan through commit_update's own _fire (also outside the lock)
        if _notify:
            self._fire(graph_id, entry, None)
        return entry

    def restore_entry(self, graph_id: str, graph: Graph, C: np.ndarray, *,
                      n_communities: int, n_disconnected: int, q: float,
                      version: int, algorithm: Optional[str] = None,
                      deferred=None) -> StoreEntry:
        """Checkpoint-restore write: land an entry at an exact version
        WITHOUT firing the commit hook (timeline state is restored
        separately — re-observing the restore would double-count)."""
        with self._lock:
            self._versions[graph_id] = int(version) - 1
            return self.put(
                graph_id, graph, C, n_communities=n_communities,
                n_disconnected=n_disconnected, q=q, algorithm=algorithm,
                deferred=deferred, _notify=False)

    def get(self, graph_id: str) -> Optional[StoreEntry]:
        with self._lock:
            entry = self._entries.get(graph_id)
            if entry is None:
                return None
            if (self.ttl_s is not None
                    and self.clock() - entry.t_stored > self.ttl_s):
                del self._entries[graph_id]
                self.n_expired += 1
                return None
            self._entries.move_to_end(graph_id)
            return entry

    def invalidate(self, graph_id: str) -> bool:
        with self._lock:
            removed = self._entries.pop(graph_id, None) is not None
            # count only actual removals: the frontend's invalidate-then-
            # resubmit path may race an eviction/expiry, and an absent id
            # must not inflate the invalidation metric
            if removed:
                self.n_invalidations += 1
            return removed

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def graph_ids(self) -> list:
        """Resident graph ids, LRU order (oldest first) — the iteration
        surface for checkpointing; does not touch recency."""
        with self._lock:
            return list(self._entries.keys())

    # -- incremental update path ------------------------------------------
    @staticmethod
    def _validate_batch(updates) -> GraphUpdate:
        upd = as_update(updates)     # shape/type/static validation
        w = upd.dw
        if w.size and not (np.isfinite(w).all() and (w != 0).all()):
            raise ValueError(
                "update weight-deltas must be finite and nonzero "
                "(positive = add, negative = decrease/delete)")
        return upd

    def prepare_update(self, graph_id: str, updates) -> UpdatePlan:
        """Host half of the warm path: validate, rewrite, screen.

        ``updates``: a :class:`repro_torch.core.dynamic.GraphUpdate` — vertex
        removals/additions (step 0) plus (u, v, dw) undirected **signed**
        weight-deltas — or a bare ``(u, v, dw)`` tuple (edges only;
        positive = add weight / insert, negative = decrease, net ``<= 0``
        = delete; deleting a missing edge is a no-op).  Edge endpoint ids
        must satisfy ``0 <= id < n_nodes`` *after* the batch's vertex
        rewrite; out-of-range ids raise ValueError before any state is
        touched.  Raises KeyError for unknown (or evicted/expired) ids,
        ValueError for malformed batches (entry untouched), and
        :class:`CapacityExceeded` when the merged edge set overflows the
        bucket's ``m_cap`` or vertex additions overflow its ``n_cap``
        (the entry is invalidated — the caller should resubmit the
        updated graph as a fresh detect request).
        """
        return self.prepare_update_seq(graph_id, [updates])

    def prepare_update_seq(self, graph_id: str, batches) -> UpdatePlan:
        """Fold several update batches (submit order) into ONE plan.

        Each batch is applied **sequentially** — per-batch deletion
        clamping and per-batch vertex id remaps, exactly as if every
        batch had been an immediate ``apply_update`` call — so the
        batched dispatch path cannot diverge from immediate semantics
        (e.g. an over-deleting batch followed by an insertion re-creates
        the edge instead of netting to a delete, and a batch after a
        removal addresses the compacted id space).  One warm compute
        covers the folded result.  Static validation covers every batch
        before the fold starts; id bounds are checked per batch against
        the evolving ``n_nodes`` (the fold is pure, so a failure anywhere
        leaves the entry untouched).  Raises as documented on
        :meth:`prepare_update`.
        """
        batches = [self._validate_batch(b) for b in batches]
        entry = self.get(graph_id)       # TTL-aware; refreshes recency
        if entry is None:
            raise KeyError(graph_id)
        # cross-tier guard: the warm path always runs the store's own
        # options identity; an entry stamped with a different key (e.g.
        # produced by the fast or max-quality tier) must NOT be continued
        # here.  Invalidate + raise so the caller re-detects the updated
        # graph — the checked-before-fold ordering leaves the entry's
        # arrays untouched.
        warm_key = self.options.result_key()
        if entry.cache_key is not None and entry.cache_key != warm_key:
            self.invalidate(graph_id)
            raise OptionsMismatch(
                f"{graph_id!r}: stored partition was produced by tier "
                f"{entry.algorithm!r} under a different options key than "
                "the warm path; re-detect instead of a cross-tier warm "
                "update")
        scan = self.options.resolved_scan(entry.graph.nv, entry.graph.m_cap,
                                          device_type=self.device.type)
        # the fold runs on the host arrays, read once; the plan's graph
        # goes back to the entry graph's device
        g = HostGraph.of(entry.graph)
        C = np.asarray(entry.C, np.int32)
        touched = np.zeros((g.nv,), bool)
        n_deleted = n_added = n_removed = n_flushed = 0
        id_map: Optional[np.ndarray] = None
        defer = self.compact_window > 0
        dead_set = set(np.asarray(entry.deferred, np.int64).tolist())
        new_dead: list = []
        # flush-at-fold-start rule (mirrored by translate_window): pay the
        # pending compaction before this fold when the tombstone set hit
        # the window, when additions would overflow n_cap, or when the
        # knob is off but tombstones linger (config change across restore)
        total_add = sum(int(b.add) for b in batches)
        if dead_set and (not defer
                         or len(dead_set) >= self.compact_window
                         or int(g.n_nodes) + total_add > int(g.n_cap)):
            flush_ids = np.asarray(sorted(dead_set), np.int64)
            g, C, touched, finfo = apply_vertex_updates(
                g, C, remove=flush_ids, touched=touched)
            id_map = finfo["perm"]
            n_flushed = int(flush_ids.size)
            dead_set = set()
            # flushed ids were already counted into n_removed when they
            # were tombstoned — the flush itself moves no metric
        try:
            for upd in batches:
                if defer:
                    g, C, touched, info = self._fold_deferred_batch(
                        g, C, upd, touched, dead_set, new_dead)
                else:
                    g, C, touched, info = prepare_graph_update(
                        g, C, upd, touched=touched)
                n_deleted += info["n_deleted"]
                n_added += info["n_added"]
                n_removed += info["n_removed"]
                perm = info["perm"]
                if perm is not None:
                    id_map = (perm if id_map is None else np.where(
                        id_map >= 0, perm[np.clip(id_map, 0, None)], -1))
        except CapacityError as e:
            # immediate mode: the entry cannot absorb the update — drop it
            # and let the caller re-bucket via a fresh detect.  Deferred
            # mode keeps the entry (the frontend refuses the re-bucketing
            # rebuild there — see ServiceFrontend — so invalidating would
            # orphan the graph; the caller can flush_compaction + retry).
            if not defer:
                self.invalidate(graph_id)
            raise CapacityExceeded(str(e)) from e
        return UpdatePlan(
            graph_id=graph_id, graph=g.to_graph(entry.graph.device),
            C_prev=np.asarray(C, np.int32),
            touched=touched,
            bucket=entry.bucket, scan=scan,
            n_deleted=n_deleted,
            version=entry.version,
            n_added=n_added, n_removed=n_removed, id_map=id_map,
            deferred_removed=np.asarray(sorted(new_dead), np.int64),
            deferred_after=np.asarray(sorted(dead_set), np.int64),
            n_flushed=n_flushed,
        )

    def _fold_deferred_batch(self, g: HostGraph, C, upd: GraphUpdate, touched,
                             dead_set: set, new_dead: list):
        """One batch under deferred compaction: tombstone removals (no
        remap), then additions, then edge deltas.  Mirrors
        :func:`repro_torch.core.dynamic.prepare_graph_update`'s validate-first
        contract; additionally rejects re-removal of a tombstoned id and
        edges addressing one (ValueError, entry untouched)."""
        n = int(g.n_nodes)
        rem = np.asarray(upd.remove, np.int64).ravel()
        if rem.size:
            if int(rem.max()) >= n or int(rem.min()) < 0:
                raise ValueError(
                    f"remove ids must be in [0, n_nodes={n}); got range "
                    f"[{int(rem.min())}, {int(rem.max())}]")
            clash = dead_set.intersection(rem.tolist())
            if clash:
                raise ValueError(
                    "remove ids already tombstoned (awaiting compaction): "
                    f"{sorted(clash)[:8]}")
        if upd.has_edges:
            # ids do NOT shift under deferral: additions claim [n, n+add)
            check_vertex_ids(upd.u, upd.v, n + int(upd.add))
            bad = dead_set.union(rem.tolist())
            if bad:
                bad_ids = np.asarray(sorted(bad), np.int64)
                hit = (np.isin(np.asarray(upd.u, np.int64), bad_ids)
                       | np.isin(np.asarray(upd.v, np.int64), bad_ids))
                if hit.any():
                    ends = (set(np.asarray(upd.u)[hit].tolist())
                            | set(np.asarray(upd.v)[hit].tolist()))
                    raise ValueError(
                        "edge endpoints reference tombstoned vertex ids: "
                        f"{sorted(ends & bad)[:8]}")
        out = dict(n_deleted=0, n_added=0, n_removed=0, perm=None)
        if rem.size:
            g, C, touched, info = tombstone_vertices(
                g, C, rem, touched=touched)
            out["n_deleted"] += info["n_deleted"]
            out["n_removed"] += info["n_removed"]
            dead_set.update(int(i) for i in rem)
            new_dead.extend(int(i) for i in rem)
        if upd.add:
            g, C, touched, info = apply_vertex_updates(
                g, C, add=int(upd.add), touched=touched)
            out["n_added"] += info["n_added"]
            # the perm is the identity prefix (pure growth) — nothing to
            # compose into the plan's id_map
        if upd.has_edges:
            g_old = g
            g = apply_edge_updates(
                g, *directed_deltas(upd.u, upd.v, upd.dw))
            out["n_deleted"] += gross_deleted(g_old, g)
            touched = touched | touched_mask(g.nv, upd.u, upd.v)
        return g, C, touched, out

    def commit_update(self, plan: UpdatePlan, *, C, n_communities: int,
                      n_disconnected: int, q: float) -> Optional[StoreEntry]:
        """Write the warm-path outputs back as the refreshed entry.

        The write is guarded on the version captured at prepare time: if
        the entry was evicted, invalidated or re-detected while the warm
        compute ran, committing would resurrect stale state, so the write
        is dropped instead (counted in ``n_stale_commits``) and ``None``
        is returned.
        """
        with self._lock:
            cur = self._entries.get(plan.graph_id)
            if cur is None or cur.version != plan.version:
                self.n_stale_commits += 1
                return None
            self.n_warm_updates += 1
            self.n_deletions += plan.n_deleted
            self.n_vertex_added += plan.n_added
            self.n_vertex_removed += plan.n_removed
            self.n_deferred_removed += int(plan.deferred_removed.size)
            if plan.n_flushed:
                self.n_compaction_flushes += 1
            entry = self.put(
                plan.graph_id, plan.graph, np.asarray(C),
                n_communities=n_communities, n_disconnected=n_disconnected,
                q=q, algorithm=cur.algorithm, deferred=plan.deferred_after,
                _notify=False,
            )
        self._fire(plan.graph_id, entry, plan)
        return entry

    def flush_compaction(self, graph_id: str) -> StoreEntry:
        """Pay the deferred compaction NOW (host-only, no warm compute).

        The tombstones are edgeless own-label singletons, so compacting
        them cannot change the partition of the survivors, modularity, or
        connectivity — only the id space (survivors shift down per the
        compaction contract) and the community count (each tombstone was
        an inflating singleton).  Publishes a fresh version and fires the
        commit hook with a synthetic flush :class:`UpdatePlan` carrying
        the remap in ``id_map`` so external ids survive.  No-op (entry
        returned unchanged, no hook) when nothing is pending; KeyError
        for unknown/evicted ids.
        """
        with self._lock:
            entry = self.get(graph_id)
            if entry is None:
                raise KeyError(graph_id)
            dead = np.asarray(entry.deferred, np.int64)
            if not dead.size:
                return entry
            g2, C2, _t, info = apply_vertex_updates(
                entry.graph, entry.C, remove=dead)
            self.n_compaction_flushes += 1
            new_entry = self.put(
                graph_id, g2, np.asarray(C2, np.int32),
                n_communities=int(entry.n_communities) - int(dead.size),
                n_disconnected=entry.n_disconnected, q=entry.q,
                algorithm=entry.algorithm, deferred=(), _notify=False)
            plan = UpdatePlan(
                graph_id=graph_id, graph=g2,
                C_prev=np.asarray(entry.C, np.int32),
                touched=np.zeros(g2.nv, bool),
                bucket=entry.bucket, scan="", n_deleted=0,
                version=entry.version, id_map=info["perm"],
                n_flushed=int(dead.size))
        self._fire(graph_id, new_entry, plan)
        return new_entry

    def apply_update(self, graph_id: str, updates, *, tau: float = 1e-3,
                     max_iters: int = 10, trace=None) -> StoreEntry:
        """Route one update batch through the warm path, immediately.

        prepare -> one :func:`repro_torch.core.dynamic.warm_update` call on
        the store's device -> commit.  The batched service path runs the
        identical compute for each graph of a batch (see module docstring);
        both produce the same partitions.  Returns the refreshed entry;
        raises as documented on :meth:`prepare_update`, plus KeyError if
        the entry moved on while the warm compute ran (stale commit
        dropped).

        ``trace``: optional :class:`repro_torch.telemetry.spans.RequestTrace`
        receiving the per-phase spans (repad = the host prepare fold,
        compile = the first run of this (bucket, tau, max_iters, scan),
        engine-dispatch, device-sync, store-commit).
        """
        if trace is None:
            plan = self.prepare_update(graph_id, updates)
        else:
            with trace.span("repad"):
                plan = self.prepare_update(graph_id, updates)
        key = (plan.bucket, float(tau), int(max_iters), plan.scan)
        hit = key in self._warm_keys
        self._warm_keys.add(key)
        dev = self.device
        t0 = self.clock()
        out = warm_update(
            plan.graph.to(dev), torch.tensor(plan.C_prev, device=dev),
            torch.tensor(plan.touched, device=dev),
            tau=tau, max_iters=max_iters, scan=plan.scan,
        )
        t1 = self.clock()
        C = out["C"].cpu().numpy()
        n_comms = out["n_communities"]
        n_disc = out["n_disconnected"]
        q = out["q"]
        t2 = self.clock()
        if trace is not None:
            trace.mark("compile", t0, t0 if hit else t1,
                       hit="true" if hit else "false")
            trace.mark("engine-dispatch", t0 if hit else t1, t1)
            trace.mark("device-sync", t1, t2)
        if trace is None:
            entry = self.commit_update(plan, C=C, n_communities=n_comms,
                                       n_disconnected=n_disc, q=q)
        else:
            with trace.span("store-commit"):
                entry = self.commit_update(plan, C=C, n_communities=n_comms,
                                           n_disconnected=n_disc, q=q)
        if entry is None:
            raise KeyError(
                f"{graph_id!r}: entry superseded while the update ran")
        return entry
