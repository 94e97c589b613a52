"""Incremental community updates for fully-dynamic graphs (delta-screening;
port of ``repro/core/dynamic.py``).

An update batch perturbs only the communities near the touched region, so
the previous partition is the warm start (Zarayeneh & Kalyanaraman's
Delta-Screening, the paper's citation [47]):

  0. vertex rewrite (:func:`apply_vertex_updates`): removed vertices lose
     every incident edge, and their ids are compacted away in one host
     pass (a surviving id shifts down by the number of removed ids below
     it: the *compaction contract*); additions claim the next free ids
     ``[n', n' + add)`` from the padding slots, and growing past ``n_cap``
     raises :class:`CapacityError`;
  1. signed edge weight-deltas on the padded COO (:func:`apply_edge_updates`):
     additions fill free slots, decreases rewrite entries, and entries
     driven to ``<= 0`` are deleted, their slots free for reuse; endpoint
     ids are in the post-rewrite id space;
  2. the screening set (:func:`affected_mask`): touched endpoints, their
     neighbours and every member of a touched community;
  3. the local move, warm-started from the previous membership with only
     the screening set awake (:func:`warm_local_move`);
  4. the split, renumber, detector and modularity (:func:`warm_update`).
     The split is what keeps the paper's guarantee through deletions of
     edges and of vertices: a community cut by a removed bridge or cut
     vertex is relabelled per connected piece.

Steps 0-1 are the reference's host folds, ported 1:1 in numpy (float64
``bincount`` included), so the rewritten graph equals the reference's bit
for bit.  They read the graph to the host once and return a
:class:`~repro_torch.graph.container.Graph` on the input's device.  Steps
2-4 run on the device; every float sum that feeds a decision folds in one
fixed order (``ops.segreduce_sorted``, ``ops.segment_sum_inorder``,
``ops.sum_inorder``), and the boolean screening and wake-ups are exact in
any order.  :func:`update_communities` runs both halves.

Of the reference's ``seg_impl`` values, :func:`warm_local_move` takes
``'auto'`` (the fused sweep) and ``'scatter'`` (the unfused one, the same
bits); ``'xla'``, ``'pallas'`` and ``block_m`` have no counterpart, since
dispatch is by device (``kernels/ops.py``).  The reference engine's
``jit(lax.map(vmap(warm_update_impl)))`` is :func:`warm_update_tile`, a
tile of dense-scan graphs as one union that runs one warm sweep loop for
all (``service/engine.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import _segments as seg
from repro_torch.core.detect import (disconnected_communities,
                                     disconnected_communities_tile)
from repro_torch.core.local_move import (SYNC_PHASES, _move_loop,
                                         dense_adjacency, local_move_tile,
                                         tile_adjacency)
from repro_torch.core.modularity import modularity, modularity_tile
from repro_torch.core.split import split_labels, split_labels_tile
from repro_torch.device import resolve_device
from repro_torch.graph.container import (Graph, from_coo, remap_coo,
                                         stack_graphs, strip_padding,
                                         union_ghosts, union_of)
from repro_torch.kernels import ops


class CapacityError(ValueError):
    """A rewrite does not fit the graph's static capacities (vertex
    additions past ``n_cap``, or a merged edge set past ``m_cap``).  Plain
    validation failures raise a bare ``ValueError``."""


@dataclasses.dataclass(frozen=True)
class HostGraph:
    """A :class:`Graph`'s arrays on the host (numpy), where the folds of
    steps 0-1 run; :meth:`of` reads a graph once, :meth:`to_graph` places
    the result on a device."""

    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    n_nodes: int
    n_cap: int
    m_cap: int

    @property
    def nv(self) -> int:
        return self.n_cap + 1

    @classmethod
    def of(cls, g) -> "HostGraph":
        if isinstance(g, HostGraph):
            return g
        src, dst, w = (t.cpu().numpy() for t in (g.src, g.dst, g.w))
        return cls(src, dst, w, int(g.n_nodes), g.n_cap, g.m_cap)

    def to_graph(self, device) -> Graph:
        return Graph(
            src=torch.from_numpy(self.src).to(device),
            dst=torch.from_numpy(self.dst).to(device),
            w=torch.from_numpy(self.w).to(device),
            n_nodes=torch.tensor(self.n_nodes, dtype=torch.int32,
                                 device=device),
            n_cap=self.n_cap, m_cap=self.m_cap)


def _like(g, h: HostGraph):
    """``h`` as the caller gave its graph: host arrays stay on the host, a
    :class:`Graph` comes back on its device."""
    return h if isinstance(g, HostGraph) else h.to_graph(g.device)


def _host_array(x, dtype=None) -> np.ndarray:
    """A numpy copy of a tensor on any device, or ``np.asarray(x)``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


# ---------------------------------------------------------------------------
# steps 0-1: host folds (numpy, 1:1 with the reference)
# ---------------------------------------------------------------------------

def merge_edge_deltas(g, new_src, new_dst, new_dw):
    """Merge directed signed weight-deltas into ``g``'s live edge set.

    Per directed pair ``(u, v)`` the batch's net delta is added to the
    existing entry's weight (parallel live entries are coalesced first),
    in float64 so that an exact add-then-delete round trip cancels to 0.0.
    Pairs whose weight ends ``<= 0`` are deleted: ``-w`` removes a
    weight-``w`` edge, and deleting a missing edge does nothing.  New
    pairs with a positive net delta are insertions.

    Returns ``(src, dst, w)`` of the merged live entries, sorted by
    ``(src, dst)`` and unpadded.
    """
    h = HostGraph.of(g)
    live = h.src < h.n_cap
    u = np.concatenate([h.src[live], np.asarray(new_src, np.int32)])
    v = np.concatenate([h.dst[live], np.asarray(new_dst, np.int32)])
    vals = np.concatenate([h.w[live].astype(np.float32),
                           np.asarray(new_dw, np.float32)])
    key = u.astype(np.int64) * (h.n_cap + 1) + v.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key, u, v, vals = key[order], u[order], v[order], vals[order]
    first = np.ones(key.shape, bool)
    first[1:] = key[1:] != key[:-1]
    run = np.cumsum(first) - 1
    w_net = np.bincount(run, weights=vals).astype(np.float32)
    keep = w_net > 0.0
    return u[first][keep], v[first][keep], w_net[keep]


def apply_edge_updates(g, new_src, new_dst, new_dw):
    """Apply directed signed weight-deltas (step 1, on the host).

    Positive deltas on new pairs take free padded slots, deltas on
    existing pairs rewrite the entry's weight, and entries driven to
    ``<= 0`` are removed, their slots back in the padding pool (the edge
    list is re-sorted, which keeps ``src`` sorted and the padding last).
    Returns a graph on ``g``'s device; raises :class:`CapacityError` if
    the merged live edge set exceeds ``m_cap``.
    """
    h = HostGraph.of(g)
    u, v, w = merge_edge_deltas(h, new_src, new_dst, new_dw)
    n_live = len(u)
    if n_live > h.m_cap:
        raise CapacityError(
            f"edge capacity exhausted ({n_live} live edges > m_cap "
            f"{h.m_cap})")
    ghost = h.n_cap
    pad = h.m_cap - n_live
    return _like(g, dataclasses.replace(
        h,
        src=np.concatenate([u, np.full(pad, ghost, np.int32)]).astype(
            np.int32),
        dst=np.concatenate([v, np.full(pad, ghost, np.int32)]).astype(
            np.int32),
        w=np.concatenate([w, np.zeros(pad, np.float32)])))


def directed_deltas(u, v, dw):
    """Expand undirected update pairs to the container convention: each
    ``u != v`` pair in both directions, self-loops once (full weight)."""
    u, v, dw = (np.asarray(x) for x in (u, v, dw))
    loops = u == v
    src = np.concatenate([u[~loops], v[~loops], u[loops]]).astype(np.int32)
    dst = np.concatenate([v[~loops], u[~loops], u[loops]]).astype(np.int32)
    ww = np.concatenate([dw[~loops], dw[~loops],
                         dw[loops]]).astype(np.float32)
    return src, dst, ww


def touched_mask(nv: int, u, v) -> np.ndarray:
    """bool[nv] host mask of the update's endpoints."""
    t = np.zeros((nv,), bool)
    t[np.asarray(u, np.int64)] = True
    t[np.asarray(v, np.int64)] = True
    return t


@dataclasses.dataclass(frozen=True)
class GraphUpdate:
    """One combined vertex and edge update batch.

    Step 0, the vertex rewrite: every id in ``remove`` loses its incident
    edges and is compacted away (order-preserving: a surviving id shifts
    down by the number of removed ids below it); then ``add`` fresh
    vertices claim the next free ids ``[n', n' + add)``.  Step 1, the edge
    deltas: ``(u, v, dw)`` undirected signed weight-deltas with endpoint
    ids in the post-rewrite id space, so a batch may wire the vertices it
    adds.  A plain ``(u, v, dw)`` tuple means an edges-only batch
    (:func:`as_update`).
    """

    u: Any = ()
    v: Any = ()
    dw: Any = ()
    add: int = 0
    remove: Any = ()

    @property
    def has_vertex_ops(self) -> bool:
        return bool(self.add) or np.asarray(self.remove).size > 0

    @property
    def has_edges(self) -> bool:
        return np.asarray(self.u).size > 0


def as_update(updates) -> GraphUpdate:
    """Coerce and validate an update batch: a :class:`GraphUpdate` or a
    ``(u, v, dw)`` tuple, returned as a ``GraphUpdate`` of numpy arrays.
    Raises ``ValueError`` for mismatched or non-1-D edge arrays, non-integer
    ids, a negative ``add``, or a ``remove`` list with duplicates or
    negative ids.  Upper id bounds depend on ``n_nodes`` and are checked
    when the batch is applied."""
    if isinstance(updates, GraphUpdate):
        u, v, dw = updates.u, updates.v, updates.dw
        add, remove = updates.add, updates.remove
    else:
        u, v, dw = updates
        add, remove = 0, ()
    u, v = np.asarray(u), np.asarray(v)
    dw = np.asarray(dw, np.float32)
    if not (u.shape == v.shape == dw.shape and u.ndim == 1):
        raise ValueError(
            f"update arrays must be equal-length 1-D, got shapes "
            f"{u.shape}, {v.shape}, {dw.shape}")
    for name, x in (("u", u), ("v", v)):
        if x.size and not np.issubdtype(x.dtype, np.integer):
            raise ValueError(
                f"edge endpoint ids ({name}) must be integers, got dtype "
                f"{x.dtype}")
    add = int(add)
    if add < 0:
        raise ValueError(f"add must be >= 0, got {add}")
    remove = np.asarray(remove)
    if remove.size and not np.issubdtype(remove.dtype, np.integer):
        raise ValueError(
            f"remove ids must be integers, got dtype {remove.dtype}")
    remove = remove.astype(np.int64).ravel()
    if remove.size:
        if int(remove.min()) < 0:
            raise ValueError("remove ids must be >= 0")
        if np.unique(remove).size != remove.size:
            raise ValueError("duplicate ids in remove")
    return GraphUpdate(u=u, v=v, dw=dw, add=add, remove=remove)


def check_vertex_ids(u, v, n_nodes: int):
    """Every edge endpoint must name a live vertex, ``0 <= id < n_nodes``;
    ids in ``[n_nodes, n_cap)`` become legal only once claimed by ``add``."""
    for name, x in (("u", u), ("v", v)):
        x = np.asarray(x)
        if not x.size:
            continue
        lo, hi = int(x.min()), int(x.max())
        if lo < 0 or hi >= n_nodes:
            raise ValueError(
                f"edge endpoint ids ({name}) must be in [0, n_nodes="
                f"{n_nodes}); got range [{lo}, {hi}]")


def _survivor_perm(n: int, remove: np.ndarray, nv: int) -> np.ndarray:
    """Order-preserving compaction map: old id -> new id over ``[0, nv)``,
    ``-1`` for tombstoned (and dead or ghost) slots."""
    alive = np.zeros(nv, bool)
    alive[:n] = True
    alive[remove] = False
    perm = np.full(nv, -1, np.int64)
    perm[np.flatnonzero(alive)] = np.arange(n - remove.size)
    return perm


def _check_remove(rem: np.ndarray, n: int) -> None:
    if int(rem.min()) < 0 or int(rem.max()) >= n:
        raise ValueError(
            f"remove ids must be in [0, n_nodes={n}); got range "
            f"[{int(rem.min())}, {int(rem.max())}]")
    if np.unique(rem).size != rem.size:
        raise ValueError("duplicate ids in remove")


def _detach(h: HostGraph, C, rem: np.ndarray, touched):
    """What removal does before any remap: the incident live edges
    (``inc``), and the touched mask grown by (a) their endpoints and (b)
    the removed vertices' whole former communities."""
    n, nv = h.n_nodes, h.nv
    t = (np.zeros(nv, bool) if touched is None
         else np.array(touched, dtype=bool, copy=True))
    dead = np.zeros(nv, bool)
    dead[rem] = True
    inc = (h.src < h.n_cap) & (dead[h.src] | dead[h.dst])
    t[h.src[inc]] = True
    t[h.dst[inc]] = True
    if C is not None and n:
        lab_dead = np.zeros(nv, bool)
        lab_dead[C[rem]] = True
        t[:n] |= lab_dead[C[:n]]
    return dead, inc, t


def apply_vertex_updates(g, C_prev, *, add: int = 0, remove=(),
                         touched=None):
    """Step 0, the vertex rewrite (host): remove and compact, then grow
    ``n_nodes`` by ``add`` within ``n_cap`` (:class:`CapacityError`
    past it).

    ``C_prev`` (or ``None``): the previous membership.  Survivors keep
    their partition, relabelled by the minimum member id in the new id
    space; new vertices are own-id singletons; dead and padding slots get
    the ghost label.  ``touched``: an accumulated screening mask in the
    old id space, carried through the remap.

    Returns ``(g_new, C_new, touched_new, info)``: the graph on ``g``'s
    device, numpy int32 labels and bool mask, and ``info`` with
    ``n_deleted`` (directed edges removed), ``n_added``, ``n_removed`` and
    ``perm`` (old id -> new id, ``-1`` at tombstones).  The touched mask
    holds the surviving endpoints of every deleted edge, every member of
    a removed vertex's former community (a removed cut vertex can
    disconnect it) and the new vertices.
    """
    h = HostGraph.of(g)
    n, nv = h.n_nodes, h.nv
    rem = np.asarray(remove, np.int64).ravel()
    add = int(add)
    if add < 0:
        raise ValueError(f"add must be >= 0, got {add}")
    if rem.size:
        _check_remove(rem, n)
    n_keep = n - rem.size
    n_new = n_keep + add
    if n_new > h.n_cap:
        raise CapacityError(
            f"vertex capacity exhausted ({n_new} vertices > n_cap "
            f"{h.n_cap})")
    C = None if C_prev is None else _host_array(C_prev)
    n_deleted = 0
    if rem.size:
        _, inc, t_old = _detach(h, C, rem, touched)
        n_deleted = int(inc.sum())
    else:
        t_old = (np.zeros(nv, bool) if touched is None
                 else np.array(touched, dtype=bool, copy=True))
    perm = _survivor_perm(n, rem, nv)
    if rem.size:
        s, d, w = remap_coo(h.src, h.dst, h.w, perm, h.n_cap, h.m_cap)
        h2 = dataclasses.replace(h, src=s, dst=d, w=w, n_nodes=n_new)
    else:
        # pure addition: the permutation is the identity and no edge moves
        h2 = dataclasses.replace(h, n_nodes=n_new)
    old_ids = np.flatnonzero(perm >= 0)
    t_new = np.zeros(nv, bool)
    t_new[:n_keep] = t_old[old_ids]
    t_new[n_keep:n_new] = True                      # the new vertices
    if C is None:
        C2 = None
    else:
        lab = C[old_ids]
        rep = np.full(nv, nv, np.int64)
        np.minimum.at(rep, lab, np.arange(n_keep))
        C2 = np.full(nv, nv - 1, np.int32)
        C2[:n_keep] = rep[lab]
        C2[n_keep:n_new] = np.arange(n_keep, n_new)  # own-id singletons
    info = dict(n_deleted=n_deleted, n_added=add, n_removed=int(rem.size),
                perm=perm)
    return _like(g, h2), C2, t_new, info


def tombstone_vertices(g, C_prev, remove, *, touched=None):
    """Deferred-compaction removal: detach ids without the remap.

    The removed ids' incident edges are deleted (slots back in the padding
    pool) and the ids stay in place as edgeless own-label singletons, so
    surviving ids do not shift and ``n_nodes`` is unchanged.  Survivors are
    relabelled by their minimum *surviving* member id.  Returns
    ``(g_new, C_new, touched_new, info)`` with the touched rules of
    :func:`apply_vertex_updates`, ``info['perm'] = None`` and
    ``info['deferred']`` the tombstoned ids.
    """
    h = HostGraph.of(g)
    n, nv = h.n_nodes, h.nv
    rem = np.asarray(remove, np.int64).ravel()
    if not rem.size:
        t = (np.zeros(nv, bool) if touched is None
             else np.array(touched, dtype=bool, copy=True))
        C = None if C_prev is None else _host_array(C_prev, np.int32).copy()
        return g, C, t, dict(n_deleted=0, n_added=0, n_removed=0,
                             perm=None, deferred=rem)
    _check_remove(rem, n)
    C = None if C_prev is None else _host_array(C_prev)
    dead, inc, t = _detach(h, C, rem, touched)
    t[rem] = False       # a tombstone has no neighbours to re-evaluate
    keep = (h.src < h.n_cap) & ~inc
    pad = h.src.size - int(keep.sum())
    ghost = np.int32(h.n_cap)
    h2 = dataclasses.replace(
        h,
        src=np.concatenate([h.src[keep],
                            np.full(pad, ghost, np.int32)]).astype(np.int32),
        dst=np.concatenate([h.dst[keep],
                            np.full(pad, ghost, np.int32)]).astype(np.int32),
        w=np.concatenate([h.w[keep], np.zeros(pad, np.float32)]).astype(
            np.float32))
    if C is None:
        C2 = None
    else:
        alive_ids = np.flatnonzero(~dead[:n])
        lab = C[alive_ids]
        rep = np.full(nv, nv, np.int64)
        np.minimum.at(rep, lab, alive_ids)
        C2 = np.full(nv, nv - 1, np.int32)
        C2[alive_ids] = rep[lab]
        C2[rem] = rem
    info = dict(n_deleted=int(inc.sum()), n_added=0, n_removed=int(rem.size),
                perm=None, deferred=rem)
    return _like(g, h2), C2, t, info


def rebuild_with_vertex_ops(g, *, add: int = 0, remove=()) -> Graph:
    """The vertex rewrite of :func:`apply_vertex_updates` without
    capacities: the result takes its natural capacities (for a caller
    that re-buckets), on ``g``'s device."""
    h = HostGraph.of(g)
    n = h.n_nodes
    rem = np.asarray(remove, np.int64).ravel()
    if rem.size and (int(rem.min()) < 0 or int(rem.max()) >= n):
        raise ValueError(f"remove ids must be in [0, n_nodes={n})")
    perm = _survivor_perm(n, rem, h.nv)
    keep = (h.src < h.n_cap) & (perm[h.src] >= 0) & (perm[h.dst] >= 0)
    n_new = n - rem.size + int(add)
    return from_coo(n_new, perm[h.src[keep]].astype(np.int32),
                    perm[h.dst[keep]].astype(np.int32), h.w[keep],
                    device=g.device)


def _sorted_unique(x: np.ndarray) -> np.ndarray:
    """``np.unique(x)`` through numpy's stable sort (timsort: linear on the
    sorted keys of a graph); numpy 2.3's ``np.unique`` hashes instead and
    took minutes on 63.5M keys."""
    x = np.sort(x, kind="stable")
    return x[np.concatenate([[True], x[1:] != x[:-1]])] if x.size else x


def gross_deleted(g_old, g_new) -> int:
    """Directed entries whose ``(src, dst)`` pair left the live set: the
    gross deletion count, which a batch that also inserts must report.

    The reference's ``np.setdiff1d(np.unique(old), new).size``, counted as
    ``|old ∪ new| - |new|`` over the unique keys: one stable sort merges
    the two sorted runs."""
    ho, hn = HostGraph.of(g_old), HostGraph.of(g_new)
    K = ho.n_cap + 1
    mo, mn = ho.src < ho.n_cap, hn.src < hn.n_cap
    old = _sorted_unique(ho.src[mo].astype(np.int64) * K + ho.dst[mo])
    new = _sorted_unique(hn.src[mn].astype(np.int64) * K + hn.dst[mn])
    union = _sorted_unique(np.concatenate([old, new]))
    return int(union.size - new.size)


def _prepare_host(h: HostGraph, C_prev, updates, touched):
    upd = as_update(updates)
    # validate the whole batch before any capacity check can fire
    n_after = h.n_nodes
    if upd.has_vertex_ops:
        rem = upd.remove
        if rem.size and int(rem.max()) >= n_after:
            raise ValueError(
                f"remove ids must be in [0, n_nodes={n_after}); got max "
                f"{int(rem.max())}")
        n_after = n_after - rem.size + upd.add
    if upd.has_edges:
        check_vertex_ids(upd.u, upd.v, n_after)
    if upd.has_vertex_ops:
        h, C, t, info = apply_vertex_updates(
            h, C_prev, add=upd.add, remove=upd.remove, touched=touched)
    else:
        C = None if C_prev is None else _host_array(C_prev)
        t = (np.zeros(h.nv, bool) if touched is None
             else np.array(touched, dtype=bool, copy=True))
        info = dict(n_deleted=0, n_added=0, n_removed=0, perm=None)
    if upd.has_edges:
        h_old = h
        h = apply_edge_updates(h, *directed_deltas(upd.u, upd.v, upd.dw))
        info["n_deleted"] += gross_deleted(h_old, h)
        t |= touched_mask(h.nv, upd.u, upd.v)
    return h, C, t, info


def prepare_graph_update(g, C_prev, updates, *, touched=None):
    """The one host fold of steps 0-1 for one update batch.

    The vertex rewrite first (when the batch has vertex ops), then the
    edge deltas, whose endpoint ids are checked against the post-rewrite
    ``n_nodes`` before the COO is touched, then the accumulated screening
    mask.  Validation precedes every capacity check, so a batch that
    raises :class:`CapacityError` is well-formed.  The graph is read to
    the host once.

    Returns ``(g, C, touched, info)``: the graph on ``g``'s device, numpy
    labels (or ``None``) and mask, and the counts of ``info``.
    """
    h, C, t, info = _prepare_host(HostGraph.of(g), C_prev, updates, touched)
    return _like(g, h), C, t, info


# ---------------------------------------------------------------------------
# steps 2-4: the device part
# ---------------------------------------------------------------------------

def _segment_any(flags, ids, nv: int) -> torch.Tensor:
    """bool[nv]: for each id, whether any of its rows is flagged.  A
    stable sort by id, then the segment-reduce kernel's int32 max (exact
    in any order)."""
    s_ids, perm = torch.sort(ids, stable=True)
    return ops.segreduce_sorted(flags[perm].to(torch.int32), s_ids, nv,
                                op="max") > 0


def affected_mask(g: Graph, C, touched) -> torch.Tensor:
    """The screening set from a touched-endpoint mask (bool[nv]).

    Marks (a) the touched endpoints, (b) their neighbours (keyed by
    ``dst``, as the reference, so any COO works) and (c) every member of a
    community holding a touched endpoint.  (c) is what covers weight
    decreases: a decreased or removed intra-community edge re-evaluates
    both endpoints' communities in full.
    """
    return affected_mask_edges(g.src, g.dst, C, touched)


def affected_mask_edges(src, dst, C, touched) -> torch.Tensor:
    """:func:`affected_mask` on bare edges, over ``C.shape[0]`` slots: a
    padded COO, or a ``GraphUnion``'s live edges with ``C`` and
    ``touched`` in its slots (each community in its own graph's slots).
    The two reductions are int32 maxes, exact in any order, and no
    segment crosses graphs, so each graph's slots get its own mask.  The
    padding rows a union drops are ``ghost -> ghost``, which flag the
    ghost only when it is touched itself."""
    n = C.shape[0]
    nbr = _segment_any(touched[src], dst, n)
    comm_touched = _segment_any(touched, C, n)
    return touched | nbr | comm_touched[C]


def affected_vertices(g: Graph, C, touched) -> torch.Tensor:
    """:func:`affected_mask` from an index list of touched vertices."""
    t = torch.zeros(g.nv, dtype=torch.bool, device=C.device)
    t[torch.as_tensor(touched, device=C.device).long()] = True
    return affected_mask(g, C, t)


def warm_local_move(src, dst, w, C_prev, two_m, active0, *, tau=1e-3,
                    max_iters: int = 10, scan: str = "sort", adj=None,
                    seg_impl: str = "auto"):
    """The local move warm-started from ``C_prev`` with the pruning mask
    seeded by the screening set ``active0``.

    Always the handshake schedule with anchored joins; a vertex stays
    awake while a neighbour moved or it is still active and wants a move.
    K is the in-order sum keyed by the sorted ``src`` (every rewrite
    re-sorts the edges) and Sigma the in-order sum of K by ``C_prev``.
    ``scan``, ``adj`` and ``seg_impl`` as in
    :func:`repro_torch.core.local_move.local_move`.  Returns ``(C, Sigma, sweeps)``: the best realized
    partition, its community weights and the sweeps run.
    """
    nv = C_prev.shape[0]
    ghost = nv - 1
    K = ops.segreduce_sorted(w, src, nv, op="sum")
    C0 = C_prev.to(torch.int32).clone()
    C0[ghost] = ghost
    Sigma0 = ops.segment_sum_inorder(K, C0, nv)
    C, Sigma, _, it = _move_loop(
        src, dst, w, C0, K, Sigma0, two_m, tau=tau, max_iters=max_iters,
        phases=SYNC_PHASES["handshake"], prune=True, active0=active0,
        warm=True, scan=scan, adj=adj, seg_impl=seg_impl)
    return C, Sigma, it


def warm_update(g: Graph, C_prev, touched, *, tau=1e-3, max_iters: int = 10,
                scan: str = "sort") -> dict:
    """One warm update on an already-rewritten graph, where it lies:
    screening, the warm local move, split, renumber, detector, modularity.

    ``scan='dense'`` builds one bool[nv, nv] adjacency shared by the warm
    sweep, the split and the detector.  Returns the reference's keys:
    ``C`` (dense int32[nv] membership), and as Python numbers
    ``n_communities``, ``n_disconnected``, ``fraction``, ``q``,
    ``iterations``, ``n_affected`` and ``split_moved``.
    """
    impl = "dense" if scan == "dense" else "coo"
    dev = g.device
    C_prev = torch.as_tensor(C_prev, device=dev)
    touched = torch.as_tensor(touched, dtype=torch.bool, device=dev)
    active0 = affected_mask(g, C_prev, touched)
    two_m = g.total_weight_2m()
    live = strip_padding(g.src, g.dst, g.w, g.ghost)
    adj = dense_adjacency(live[0], live[1], g.nv) if scan == "dense" else None
    C, _, it = warm_local_move(*live, C_prev, two_m, active0, tau=tau,
                               max_iters=max_iters, scan=scan, adj=adj)
    labels, _ = split_labels(*live, C, impl=impl, adj=adj)
    node_mask = g.node_mask()
    C_new, n_comms = seg.renumber(labels, node_mask, g.nv)
    det = disconnected_communities(*live, C_new, g.n_nodes, impl=impl,
                                   adj=adj)
    q = modularity(*live, C_new)
    return dict(
        C=C_new,
        n_communities=int(n_comms),
        n_disconnected=int(det["n_disconnected"]),
        fraction=float(det["fraction"]),
        q=float(q),
        iterations=it,
        n_affected=int(torch.sum(active0)),
        split_moved=int(torch.sum((labels != C) & node_mask)),
    )


def warm_update_tile(graphs, C_prev, touched, *, tau=1e-3,
                     max_iters: int = 10, scan: str = "dense") -> list[dict]:
    """:func:`warm_update` of ``b`` same-capacity graphs at once, the
    batched engine's tile (the reference's vmapped ``warm_update_impl``):
    one dict a graph with ``warm_update``'s keys and types, each the bits
    of ``warm_update(scan=scan)`` on its graph alone.

    ``graphs``: a list of graphs, or a :func:`stack_graphs` result;
    ``C_prev`` int32 and ``touched`` bool ``[b, nv]``.  The graphs' live
    edges form one ``GraphUnion`` with ``C_prev`` shifted into its slots;
    the screening runs there on ``C_prev`` as given, then each graph's
    ghost slot is set for the sweep and Sigma0, as ``warm_update`` does.
    2m folds each graph's padded ``w`` (``Graph.total_weight_2m``), K and
    Sigma0 are the in-order folds of the lone path over the same elements.
    On the dense scan one :func:`tile_adjacency` serves the warm
    :func:`~repro_torch.core.local_move.local_move_tile` and the split;
    the sortscan builds no ``[b, nv, nv]`` matrix: its warm sweeps sort
    the union's edges and its split is the coo ``split_labels`` on the
    union with the lone round limit (an integer fixpoint, each graph's
    own).  The detector and the modularity are coo on the union for both.
    Every per-graph count and value comes to the host in one copy at the
    end; the labels stay on the graphs' device."""
    stacked = graphs if isinstance(graphs, Graph) else stack_graphs(graphs)
    b, nv, dev = stacked.src.shape[0], stacked.nv, stacked.device
    n = b * nv
    u = union_of(stacked)
    slot = torch.arange(n, dtype=torch.int32, device=dev)
    base = slot - torch.remainder(slot, nv)
    C_u = torch.as_tensor(C_prev, device=dev).to(torch.int32).reshape(n) \
        + base
    t_u = torch.as_tensor(touched, device=dev).to(torch.bool).reshape(n)
    active0 = affected_mask_edges(u.src, u.dst, C_u, t_u)
    # 2m over each graph's padded edges, as Graph.total_weight_2m
    two_m = ops.sum_inorder_per_graph(stacked.w.reshape(-1),
                                      (stacked.m_cap,) * b)
    K = ops.segreduce_sorted(u.w, u.src, n, op="sum")
    C0 = C_u.clone()
    ghosts = union_ghosts(b, nv, dev)
    C0[ghosts.long()] = ghosts
    Sigma0 = ops.segment_sum_inorder(K, C0, n)
    adj = tile_adjacency(u.src, u.dst, b, nv) if scan == "dense" else None
    C, _, _, sweeps = local_move_tile(
        u.src, u.dst, u.w, C0, K, Sigma0, two_m, counts=u.counts, tau=tau,
        max_iters=max_iters, sync="handshake", scan=scan, adj=adj,
        active0=active0, warm=True)
    if adj is None:
        labels, _ = split_labels(u.src, u.dst, u.w, C, mode="pj",
                                 max_iters=nv)
    else:
        labels = split_labels_tile((C - base).view(b, nv), adj, mode="pj"
                                   ).view(n) + base
    node_mask = (torch.arange(nv, device=dev)[None, :]
                 < stacked.n_nodes[:, None]).view(n)
    C_new, n_comms = seg.renumber_tile(labels, node_mask, b)
    det = disconnected_communities_tile(u.src, u.dst, u.w, C_new, node_mask,
                                        b)
    q = modularity_tile(u.src, u.dst, u.w, C_new, u.counts)
    moved = ((labels != C) & node_mask).view(b, nv)
    # the per-graph numbers in one copy: int32, the floats by their bits
    host = torch.stack([
        n_comms.to(torch.int32), det["n_disconnected"].to(torch.int32),
        torch.sum(active0.view(b, nv), dim=1).to(torch.int32),
        torch.sum(moved, dim=1).to(torch.int32),
        det["fraction"].view(torch.int32), q.view(torch.int32)]).cpu().numpy()
    frac, q = host[4:].view(np.float32)
    C_local = (C_new - base).view(b, nv)
    return [dict(C=C_local[g], n_communities=int(host[0, g]),
                 n_disconnected=int(host[1, g]), fraction=float(frac[g]),
                 q=float(q[g]), iterations=int(sweeps[g]),
                 n_affected=int(host[2, g]), split_moved=int(host[3, g]))
            for g in range(b)]


def update_communities(g_old, C_prev, updates, *, tau=1e-3,
                       max_iters: int = 10, scan: str = "sort", device=None):
    """Update a partition after one batch: the host folds of steps 0-1
    (:func:`prepare_graph_update`), then :func:`warm_update` on ``device``
    (``None`` = CUDA; raises when CUDA is absent).

    ``updates``: a :class:`GraphUpdate` or a ``(u, v, dw)`` tuple of
    undirected signed weight-deltas (``-w`` deletes a weight-``w`` edge).
    ``scan``: 'sort' or 'dense' (the dense scan's warm sweep, split and
    detector; the same bits).  Returns ``(g_new, C_new, stats)``: the
    rewritten graph and the dense membership on ``device``, and the stats
    ``iterations``, ``n_communities``, ``n_affected``, ``split_moved``,
    ``n_disconnected``, ``q``, ``n_deleted``, ``n_added`` and
    ``n_removed`` as Python numbers.
    """
    dev = resolve_device(device)
    h, C_host, t, info = _prepare_host(HostGraph.of(g_old), C_prev, updates,
                                       None)
    g = h.to_graph(dev)
    out = warm_update(g, torch.from_numpy(np.asarray(C_host, np.int32)),
                      torch.from_numpy(t), tau=tau, max_iters=max_iters,
                      scan=scan)
    stats = dict(
        iterations=out["iterations"],
        n_communities=out["n_communities"],
        n_affected=out["n_affected"],
        split_moved=out["split_moved"],
        n_disconnected=out["n_disconnected"],
        q=out["q"],
        n_deleted=info["n_deleted"],
        n_added=info["n_added"],
        n_removed=info["n_removed"],
    )
    return g, out["C"], stats
