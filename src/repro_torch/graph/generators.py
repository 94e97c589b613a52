"""Synthetic graph generators (port of ``repro/graph/generators.py``).

Host-side numpy, copied verbatim so the same seed gives byte-identical
``src``/``dst``/``w``; only the ``device=`` keyword (where the graph is
placed; ``None`` = CUDA) is new.

These cover the paper's evaluation families at laptop scale:

* :func:`sbm_graph` — planted-partition graphs (social-network-like) with a
  known ground-truth community structure.
* :func:`rmat_graph` — power-law web-like graphs (the paper's LAW web crawls).
* :func:`ring_of_cliques` / :func:`grid_graph` — low-degree road-network-like
  graphs where the splitting phase dominates (paper §5.3).
* :func:`bridge_graph` — the adversarial construction of paper Figure 1:
  communities connected through a single bridge vertex that is pulled away by
  a heavier community, leaving an internally-disconnected community.  This is
  the regression fixture for the whole contribution.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.container import Graph, from_undirected


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def sbm_graph(
    n_nodes: int = 256,
    n_blocks: int = 8,
    p_in: float = 0.3,
    p_out: float = 0.01,
    seed: int = 0,
    *,
    n_cap: int | None = None,
    m_cap: int | None = None,
    device=None,
) -> tuple[Graph, np.ndarray]:
    """Stochastic block model. Returns (graph, ground-truth block labels)."""
    rng = _rng(seed)
    labels = np.sort(rng.integers(0, n_blocks, size=n_nodes))
    iu, ju = np.triu_indices(n_nodes, k=1)
    same = labels[iu] == labels[ju]
    p = np.where(same, p_in, p_out)
    keep = rng.random(iu.shape[0]) < p
    g = from_undirected(n_nodes, iu[keep], ju[keep], n_cap=n_cap, m_cap=m_cap,
                        device=device)
    return g, labels


def rmat_graph(
    scale: int = 10,
    edge_factor: int = 8,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    *,
    n_cap: int | None = None,
    m_cap: int | None = None,
    device=None,
) -> Graph:
    """R-MAT power-law generator (Graph500 parameters by default)."""
    rng = _rng(seed)
    n = 1 << scale
    m = n * edge_factor
    u = np.zeros(m, dtype=np.int64)
    v = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        right = r >= ab  # quadrant c or d -> u bit set
        r2 = rng.random(m)
        # within top half: b quadrant -> v bit set; within bottom: d quadrant
        v_bit = np.where(right, r >= abc, r2 >= a / ab)
        u = (u << 1) | right.astype(np.int64)
        v = (v << 1) | v_bit.astype(np.int64)
    keep = u != v
    return from_undirected(n, u[keep], v[keep], n_cap=n_cap, m_cap=m_cap,
                           device=device)


def ring_of_cliques(
    n_cliques: int = 16,
    clique_size: int = 8,
    *,
    n_cap: int | None = None,
    m_cap: int | None = None,
    device=None,
) -> Graph:
    """Cliques arranged on a ring, adjacent cliques joined by one edge."""
    n = n_cliques * clique_size
    us, vs = [], []
    for ci in range(n_cliques):
        base = ci * clique_size
        iu, ju = np.triu_indices(clique_size, k=1)
        us.append(base + iu)
        vs.append(base + ju)
        nxt = ((ci + 1) % n_cliques) * clique_size
        us.append(np.array([base]))
        vs.append(np.array([nxt]))
    return from_undirected(
        n, np.concatenate(us), np.concatenate(vs), n_cap=n_cap, m_cap=m_cap,
        device=device,
    )


def grid_graph(
    rows: int = 32,
    cols: int = 32,
    *,
    n_cap: int | None = None,
    m_cap: int | None = None,
    device=None,
) -> Graph:
    """2-D grid (road-network-like: degree ~4, large diameter)."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    us = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    vs = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return from_undirected(rows * cols, us, vs, n_cap=n_cap, m_cap=m_cap,
                           device=device)


def random_regular_graph(
    n_nodes: int = 128,
    degree: int = 6,
    seed: int = 0,
    *,
    n_cap: int | None = None,
    m_cap: int | None = None,
    device=None,
) -> Graph:
    """Random near-regular graph via permutation matchings (may drop a few
    conflicting edges; good enough as a fuzz fixture)."""
    rng = _rng(seed)
    us, vs = [], []
    for _ in range(degree):
        perm = rng.permutation(n_nodes)
        us.append(np.arange(n_nodes))
        vs.append(perm)
    u = np.concatenate(us)
    v = np.concatenate(vs)
    keep = u != v
    return from_undirected(n_nodes, u[keep], v[keep], n_cap=n_cap, m_cap=m_cap,
                           device=device)


def bridge_graph(
    n_satellites: int = 3,
    arm: int = 4,
    heavy: float = 4.0,
    *,
    n_cap: int | None = None,
    m_cap: int | None = None,
    device=None,
) -> tuple[Graph, int]:
    """Paper Figure 1 adversarial construction, generalized.

    A "home" community C1 is a star of ``n_satellites`` chains (arms) of
    length ``arm`` that meet only through a single **bridge vertex**.  The
    bridge is also heavily connected (weight ``heavy``) to a big external
    clique.  Louvain's local-moving phase pulls the bridge into the clique's
    community, leaving C1 internally disconnected — exactly the Figure 1(c)
    failure.  Returns (graph, bridge_vertex_id).
    """
    us, vs, ws = [], [], []
    nid = 0
    bridge = nid
    nid += 1
    # arms hanging off the bridge; arm-internal edges are strong so each arm
    # stays a coherent chunk, arm->bridge links are weak.
    for _ in range(n_satellites):
        prev = bridge
        for k in range(arm):
            cur = nid
            nid += 1
            us.append(prev)
            vs.append(cur)
            ws.append(1.0 if prev == bridge else 3.0)
            # make arm interiors cliquey
            if k >= 2:
                us.append(cur)
                vs.append(cur - 2)
                ws.append(3.0)
            prev = cur
    # heavy external clique pulling the bridge away
    clique = list(range(nid, nid + 6))
    nid += 6
    for i, a in enumerate(clique):
        for b in clique[i + 1:]:
            us.append(a)
            vs.append(b)
            ws.append(heavy)
    us.append(bridge)
    vs.append(clique[0])
    ws.append(heavy)
    g = from_undirected(
        nid, np.array(us), np.array(vs), np.array(ws, np.float32),
        n_cap=n_cap, m_cap=m_cap, device=device,
    )
    return g, bridge
