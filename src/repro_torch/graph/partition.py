"""Vertex-aligned edge partitioning (port of ``repro/graph/partition.py``).

The sharded driver (``core/distributed.py``) shards **edges by source
vertex**: every out-edge of a vertex lives on exactly one shard, so the
per-vertex reductions (community scan, label-min, K) are exact
shard-locally and only per-vertex state needs collectives.

:func:`partition_edges_by_src` computes vertex-range boundaries balancing
edge counts (greedy prefix splitting), then pads every shard to the same
edge capacity so the result stacks into one ``[n_shards, m_shard]`` array.
It is numpy on the host, and its arrays and error messages are the
reference's byte for byte.

Bit-exactness contract: the container keeps edges sorted by ``(src,
dst)``, so the contiguous per-shard slices taken here concatenate (padding
dropped, shard order) back to the exact live-edge prefix of the
single-device arrays: same edges, same order.  Every per-vertex run a
shard sees is the run the single-device sweep sees, so shard-local segment
reductions fold in the same order as their single-device twins.
:func:`reassemble_edges` materializes that round trip.

Vertex roles per shard (:func:`shard_vertex_roles`):

* *owned*    — ``v_lo <= v < v_hi``: this shard holds ALL of v's
  out-edges and is the single writer of v's per-vertex state.
* *boundary* — owned with at least one cut out-edge (a neighbor owned
  elsewhere).
* *interior* — owned with every neighbor owned here.
* *ghost*    — NOT owned but referenced as a neighbor (``dst``) by this
  shard's edges: the halo copy whose label the shard reads but never
  writes.  (Distinct from the container's padding sentinel ``n_cap``,
  which is excluded from all three sets.)
"""
from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def shard_edge_ranges(src: np.ndarray, nv: int, n_shards: int):
    """``(bounds, ranges)`` for live, sorted ``src``: the owned vertex
    ranges ``[bounds[s], bounds[s + 1])`` (int64[n_shards + 1], monotone
    from 0 to ``nv``), balanced by edge count with the reference's greedy
    prefix split, and each shard's edge range ``(e0, e1)`` in ``src``."""
    m = src.shape[0]
    counts = np.bincount(src, minlength=nv)
    prefix = np.concatenate([[0], np.cumsum(counts)])
    targets = np.linspace(0, m, n_shards + 1)
    bounds = np.searchsorted(prefix, targets, side="left")
    bounds[0], bounds[-1] = 0, nv
    bounds = np.maximum.accumulate(bounds)  # monotone vertex boundaries
    ranges = [(int(prefix[bounds[s]]), int(prefix[bounds[s + 1]]))
              for s in range(n_shards)]
    return bounds, ranges


def partition_edges_by_src(g, n_shards: int) -> dict[str, np.ndarray]:
    """Split ``g``'s edges into ``n_shards`` vertex-aligned shards.

    Returns a dict of stacked numpy arrays:
      src, dst: int32[n_shards, m_shard]  (ghost-padded)
      w:        float32[n_shards, m_shard]
      gidx:    int32[n_shards, m_shard] global edge slot of each live
               edge in the container's arrays (contiguous ranges);
               padding routes to the dump slot ``m_cap``
      v_lo, v_hi: int32[n_shards] owned vertex ranges [v_lo, v_hi)
      m_valid: int32[n_shards] live (unpadded) edge count per shard
      n_cap:   int32[] the container's padding sentinel / capacity
      m_cap:   int32[] the container's edge capacity (gidx dump slot)

    Takes a graph whose leaves are tensors (on any device) or numpy
    arrays.  Live edges are exactly ``src < n_cap``; zero-weight edges are
    kept so shard-local folds see the single-device per-vertex runs.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    src = _host(g.src)
    dst = _host(g.dst)
    w = _host(g.w)
    m_cap = src.shape[0]
    mask = src < g.n_cap
    gidx = np.nonzero(mask)[0].astype(np.int32)
    src, dst, w = src[mask], dst[mask], w[mask]
    if np.any(src[1:] < src[:-1]):
        raise ValueError("edges not sorted by src: container invariant broken")
    bounds, per_shard = shard_edge_ranges(src, g.nv, n_shards)
    m_shard = max(max(e1 - e0 for e0, e1 in per_shard), 1)

    ghost = g.n_cap
    S = np.full((n_shards, m_shard), ghost, np.int32)
    D = np.full((n_shards, m_shard), ghost, np.int32)
    W = np.zeros((n_shards, m_shard), np.float32)
    G = np.full((n_shards, m_shard), m_cap, np.int32)
    for s, (e0, e1) in enumerate(per_shard):
        k = e1 - e0
        S[s, :k] = src[e0:e1]
        D[s, :k] = dst[e0:e1]
        W[s, :k] = w[e0:e1]
        G[s, :k] = gidx[e0:e1]
    return dict(
        src=S,
        dst=D,
        w=W,
        gidx=G,
        v_lo=np.asarray(bounds[:-1], np.int32),
        v_hi=np.asarray(bounds[1:], np.int32),
        m_valid=np.asarray([e1 - e0 for e0, e1 in per_shard], np.int32),
        n_cap=np.int32(g.n_cap),
        m_cap=np.int32(m_cap),
    )


def shard_vertex_roles(parts: dict, s: int) -> dict:
    """Classify shard ``s``'s vertices (see module docstring for the roles).

    ``parts`` is :func:`partition_edges_by_src`'s dict, or any dict whose
    ``src``/``dst`` hold one array a shard (the sharded driver's unpadded
    shards).  Returns sorted unique int32 id arrays ``owned`` /
    ``interior`` / ``boundary`` / ``ghosts`` plus the halo sizes the
    telemetry reports: ``n_ghosts`` (halo copies read) and ``n_cut_edges``
    (edges whose update crosses the shard boundary each half-sweep).
    """
    n_cap = int(parts["n_cap"])
    lo, hi = int(parts["v_lo"][s]), int(parts["v_hi"][s])
    k = int(parts["m_valid"][s])
    src = np.asarray(parts["src"][s][:k])
    dst = np.asarray(parts["dst"][s][:k])
    owned = np.arange(lo, min(hi, n_cap), dtype=np.int32)
    real_nbr = dst < n_cap  # padding sentinel never counts as a neighbor
    cut = real_nbr & ((dst < lo) | (dst >= hi))
    boundary = np.unique(src[cut]).astype(np.int32)
    interior = np.setdiff1d(owned, boundary, assume_unique=True)
    ghosts = np.unique(dst[cut]).astype(np.int32)
    return dict(
        owned=owned,
        interior=interior,
        boundary=boundary,
        ghosts=ghosts,
        n_ghosts=int(ghosts.shape[0]),
        n_cut_edges=int(cut.sum()),
    )


def reassemble_edges(parts: dict):
    """Invert :func:`partition_edges_by_src`: concatenate live shard slices.

    Returns ``(src, dst, w)`` numpy arrays byte-identical to the
    partitioned graph's live-edge prefix (same edges, same order) for any
    shard count.
    """
    ks = [int(k) for k in parts["m_valid"]]
    src = np.concatenate([np.asarray(parts["src"][s][:k])
                          for s, k in enumerate(ks)])
    dst = np.concatenate([np.asarray(parts["dst"][s][:k])
                          for s, k in enumerate(ks)])
    w = np.concatenate([np.asarray(parts["w"][s][:k])
                        for s, k in enumerate(ks)])
    return src, dst, w


def shard_graph(g, n_shards: int) -> dict[str, torch.Tensor]:
    """:func:`partition_edges_by_src` as tensors where ``g`` lies, axis 0
    the shard."""
    return {k: torch.as_tensor(v, device=g.device)
            for k, v in partition_edges_by_src(g, n_shards).items()}
