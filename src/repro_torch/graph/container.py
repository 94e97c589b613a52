"""Fixed-shape graph container (port of ``repro/graph/container.py``).

Conventions, the same as the JAX package's:

* Edges are stored in **directed COO**: every undirected edge ``{u, v}`` with
  ``u != v`` appears twice, as ``(u, v, w)`` and ``(v, u, w)``.  Self-loops
  appear **once** with their full weight, so ``sum_i K_i == 2m`` and stays
  invariant under Louvain aggregation.
* Arrays are padded to capacities ``(n_cap, m_cap)``.  Padded edges point at
  the **ghost vertex** (index ``n_cap``) and carry ``w = 0``; node arrays
  have length ``nv = n_cap + 1`` so gathers through padding stay in bounds.
* Edges are sorted by ``(src, dst)``; the ghost sentinel sorts all padding
  to the tail.  Every sorted segment reduction keyed by ``src`` relies on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Graph:
    """A padded, fixed-shape, directed-COO graph on one device.

    Attributes:
      src:  int32[m_cap]  edge sources, sorted, padded with ``n_cap``.
      dst:  int32[m_cap]  edge destinations, padded with ``n_cap``.
      w:    float32[m_cap] edge weights, 0 at padding.
      n_nodes: int32[] number of real vertices.
      n_cap: vertex capacity; the ghost vertex lives at index n_cap.
      m_cap: edge capacity.
    """

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    n_nodes: torch.Tensor
    n_cap: int
    m_cap: int

    @property
    def nv(self) -> int:
        """Node-array length including the ghost slot."""
        return self.n_cap + 1

    @property
    def ghost(self) -> int:
        return self.n_cap

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "Graph":
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(
            self, src=self.src.to(device), dst=self.dst.to(device),
            w=self.w.to(device), n_nodes=self.n_nodes.to(device))

    def edge_mask(self) -> torch.Tensor:
        return self.src < self.n_cap

    def node_mask(self) -> torch.Tensor:
        return torch.arange(self.nv, device=self.device) < self.n_nodes

    def vertex_weights(self) -> torch.Tensor:
        """K_i = weighted (out-)degree, float32[nv]; the ghost gets 0.

        ``src`` is sorted, so this is one in-order sorted segment sum."""
        return ops.segreduce_sorted(self.w, self.src, self.nv, op="sum")

    def total_weight_2m(self) -> torch.Tensor:
        """2m = sum of all directed edge weights (padding contributes 0), in
        one fixed order on every device (``ops.sum_inorder``)."""
        return ops.sum_inorder(self.w)

    def __repr__(self) -> str:
        return f"Graph(n_cap={self.n_cap}, m_cap={self.m_cap})"


def strip_padding(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                  ghost: int):
    """The edge arrays without their ghost padding.

    The sorted invariant puts every padded edge (``src == ghost``) at the
    tail, so the live edges are a prefix.  The reference keeps fixed
    capacities because ``jit`` needs static shapes; eager PyTorch does not,
    and a padding tail left in the arrays is one giant ghost segment that a
    single thread of the segment-reduce kernel walks in every reduction
    keyed by ``src`` (tens of millions of rows after an aggregation).
    Results are unchanged: the ghost's own values are masked everywhere.
    """
    m = int(torch.count_nonzero(src < ghost))
    return src[:m], dst[:m], w[:m]


def _sort_coo(src: np.ndarray, dst: np.ndarray, w: np.ndarray):
    """Stable sort of the edges by ``(src, dst)``.  Non-negative ids sort
    as one packed int64 key, whose stable sort is numpy's timsort: the
    same order as ``np.lexsort((dst, src))``, and near-linear on the
    already sorted edges of a rewrite."""
    if src.size and min(src.min(), dst.min()) >= 0:
        key = (src.astype(np.int64) << 32) | dst.astype(np.int64)
        order = np.argsort(key, kind="stable")
    else:
        order = np.lexsort((dst, src))
    return src[order], dst[order], w[order]


def repad(g: Graph, n_cap: int, m_cap: int) -> Graph:
    """Re-pad a graph into new capacities (bucket admission), on the host.

    The live edges are read to the host once and laid out against the new
    ghost index by :func:`from_coo`; the result lies on ``g``'s device.
    Raises ``ValueError`` if the graph does not fit.
    """
    n = int(g.n_nodes)
    src, dst, w = (t.cpu().numpy() for t in (g.src, g.dst, g.w))
    mask = src < g.n_cap
    if n > n_cap:
        raise ValueError(f"n_cap={n_cap} < n_nodes {n}")
    if int(mask.sum()) > m_cap:
        raise ValueError(f"m_cap={m_cap} < num edges {int(mask.sum())}")
    return from_coo(n, src[mask], dst[mask], w[mask], n_cap=n_cap,
                    m_cap=m_cap, device=g.device)


def unit_graph(n_cap: int, m_cap: int, *, device=None) -> Graph:
    """A 1-vertex graph with a unit self-loop: the batch filler.

    Keeps ``2m > 0`` so a filler never divides by zero in modularity;
    callers discard its results.  ``device`` as in :func:`from_coo`.
    """
    return from_coo(1, np.array([0]), np.array([0]),
                    np.array([1.0], np.float32), n_cap=n_cap, m_cap=m_cap,
                    device=device)


def remap_coo(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
              perm: np.ndarray, n_cap: int, m_cap: int):
    """The host half of :func:`remap_vertices` on padded numpy arrays:
    ``(src, dst, w)`` relabelled through ``perm``, re-sorted and re-padded
    to ``m_cap``."""
    perm = np.asarray(perm, np.int64)
    live = src < n_cap
    keep = live & (perm[src] >= 0) & (perm[dst] >= 0)
    s, d, ww = _sort_coo(perm[src[keep]].astype(np.int32),
                         perm[dst[keep]].astype(np.int32),
                         w[keep].astype(np.float32))
    pad = m_cap - s.shape[0]
    return (np.concatenate([s, np.full(pad, n_cap, np.int32)]),
            np.concatenate([d, np.full(pad, n_cap, np.int32)]),
            np.concatenate([ww, np.zeros(pad, np.float32)]))


def remap_vertices(g: Graph, perm: np.ndarray, n_nodes: int) -> Graph:
    """Vertex remap and compaction (dynamic vertex removals), on the host.

    ``perm`` maps old vertex ids to new ids (``int[nv]``, covering the
    ghost slot; ``-1`` marks tombstoned ids).  Live edges with a
    tombstoned endpoint are dropped, the survivors are relabelled through
    ``perm``, re-sorted to restore the ``(src, dst)`` order invariant, and
    re-padded to the **same** capacities, so the freed edge slots return
    to the padding pool as edge deletions do.  The graph is read to the
    host once; the result lies on ``g``'s device.
    """
    perm = np.asarray(perm, np.int64)
    if perm.shape != (g.nv,):
        raise ValueError(f"perm must have shape ({g.nv},), got {perm.shape}")
    if n_nodes > g.n_cap:
        raise ValueError(f"n_cap={g.n_cap} < n_nodes {n_nodes}")
    src, dst, w = (t.cpu().numpy() for t in (g.src, g.dst, g.w))
    s, d, ww = remap_coo(src, dst, w, perm, g.n_cap, g.m_cap)
    dev = g.device
    return Graph(src=torch.from_numpy(s).to(dev),
                 dst=torch.from_numpy(d).to(dev),
                 w=torch.from_numpy(ww).to(dev),
                 n_nodes=torch.tensor(int(n_nodes), dtype=torch.int32,
                                      device=dev),
                 n_cap=g.n_cap, m_cap=g.m_cap)


def from_coo(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray | None = None,
    *,
    n_cap: int | None = None,
    m_cap: int | None = None,
    device=None,
) -> Graph:
    """Build a :class:`Graph` from an already-directed COO edge list.

    The caller is responsible for the both-directions convention; see
    :func:`from_undirected` for the friendly path.
    """
    device = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if w is None:
        w = np.ones(src.shape, dtype=np.float32)
    w = np.asarray(w, dtype=np.float32)
    if n_cap is None:
        n_cap = int(n_nodes)
    if m_cap is None:
        m_cap = int(src.shape[0])
    if src.shape[0] > m_cap:
        raise ValueError(f"m_cap={m_cap} < num edges {src.shape[0]}")
    if n_nodes > n_cap:
        raise ValueError(f"n_cap={n_cap} < n_nodes {n_nodes}")
    src, dst, w = _sort_coo(src, dst, w)
    pad = m_cap - src.shape[0]
    ghost = n_cap
    src = np.concatenate([src, np.full(pad, ghost, np.int32)])
    dst = np.concatenate([dst, np.full(pad, ghost, np.int32)])
    w = np.concatenate([w, np.zeros(pad, np.float32)])
    return Graph(
        src=torch.from_numpy(src).to(device),
        dst=torch.from_numpy(dst).to(device),
        w=torch.from_numpy(w).to(device),
        n_nodes=torch.tensor(n_nodes, dtype=torch.int32, device=device),
        n_cap=n_cap,
        m_cap=m_cap,
    )


def from_undirected(
    n_nodes: int,
    u: np.ndarray,
    v: np.ndarray,
    w: np.ndarray | None = None,
    *,
    n_cap: int | None = None,
    m_cap: int | None = None,
    dedup: bool = True,
    device=None,
) -> Graph:
    """Build a :class:`Graph` from an undirected edge list.

    Each edge ``{u, v}`` with ``u != v`` is materialized in both directions;
    self-loops are kept once.  Duplicate undirected edges are merged by
    summing weights when ``dedup``.
    """
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    if w is None:
        w = np.ones(u.shape, dtype=np.float32)
    w = np.asarray(w, dtype=np.float32)
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    if dedup and lo.size:
        key = lo * (n_nodes + 1) + hi
        order = np.argsort(key, kind="stable")
        key, lo, hi, w = key[order], lo[order], hi[order], w[order]
        first = np.ones_like(key, dtype=bool)
        first[1:] = key[1:] != key[:-1]
        run = np.cumsum(first) - 1
        w = np.bincount(run, weights=w).astype(np.float32)
        lo, hi = lo[first], hi[first]
    loops = lo == hi
    s = np.concatenate([lo, hi[~loops]])
    d = np.concatenate([hi, lo[~loops]])
    ww = np.concatenate([w, w[~loops]])
    return from_coo(n_nodes, s, d, ww, n_cap=n_cap, m_cap=m_cap,
                    device=device)
