"""Synthetic but *structured* data streams (port of
``repro/data/streams.py``): numpy, torch and the port's generators only.

The model streams have enough structure for a loss to visibly fall:
:func:`token_stream` walks an order-1 Markov chain whose successor table
is the reference's (the same ``np.random.default_rng(seed)`` draws),
:func:`recsys_stream` labels (user, item) pairs by the reference's hash,
and :func:`gnn_node_labels` plants labels from the port's Louvain.  Their
random draws come from a ``torch.Generator`` (seeded with ``seed``), which
cannot give ``jax.random``'s numbers: the batches are the reference's in
law, not in value.

Timestamped :class:`GraphEvent` records in **external** vertex-id space —
edge add/delete/reweight, vertex add/remove — from
:func:`graph_event_stream` (configurable churn mixes over an evolving
graph) or :func:`planted_timeline_script` (a staged
merge -> split -> death -> birth scenario with lifecycle ground truth).
Fold them into windowed snapshots with
:class:`repro_torch.timeline.tracker.WindowedIngest`, or one window at a
time through the service's ``ingest_window``.  The same seed gives the
reference's events, field for field.

:func:`graph_dataset` names the generator fixtures.  Graphs are built on
``device`` (``None`` = CUDA, as every generator of the port).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.dynamic import _host_array
from repro_torch.device import resolve_device
from repro_torch.graph import (
    grid_graph, ring_of_cliques, rmat_graph, sbm_graph,
)
from repro_torch.graph.container import Graph, from_undirected


_U32 = 0xFFFFFFFF


def token_stream(vocab: int, batch: int, seq_len: int, *, seed: int = 0,
                 device=None):
    """Infinite iterator of (tokens, targets) int32[batch, seq_len] on
    ``device`` (``None`` = CUDA).

    Order-1 Markov chain with a sparse random transition table: each token
    has 8 plausible successors, so a model can reduce loss well below
    log(vocab).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    succ = torch.from_numpy(
        rng.integers(0, vocab, size=(vocab, 8)).astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    while True:
        x0 = torch.randint(0, vocab, (batch,), generator=gen, device=dev,
                           dtype=torch.int32)
        choice = torch.randint(0, 8, (seq_len, batch), generator=gen,
                               device=dev)
        toks = [x0]
        for t in range(seq_len):
            toks.append(succ[toks[-1].long(), choice[t]])
        seq = torch.stack(toks, dim=1)          # [B, S+1]
        yield seq[:, :-1], seq[:, 1:]


def recsys_stream(cfg, batch: int, *, seed: int = 0, hot: int = 3,
                  device=None):
    """Infinite iterator of BST batches with learnable CTR structure, on
    ``device`` (``None`` = CUDA)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    while True:
        user = randint(0, cfg.user_vocab, batch)
        behavior = randint(0, cfg.item_vocab, batch, cfg.seq_len)
        target = randint(0, cfg.item_vocab, batch)
        fields = randint(-1, cfg.user_field_vocab, batch, cfg.n_user_fields,
                         hot)
        # structured label: hash-parity of (user, target), the reference's
        # uint32 arithmetic in int64 under a 32-bit mask (ids < 2**31, so
        # no product leaves int64)
        h = ((user.long() * 2654435761 & _U32)
             + (target.long() * 97 & _U32)) & _U32
        label = ((h % 7) < 3).to(torch.int32)
        yield dict(user=user, behavior=behavior, target=target,
                   fields=fields, label=label)


def graph_dataset(name: str, **kw):
    """Named graph fixtures used across benchmarks/examples (``kw`` goes
    to the generator, ``device`` included)."""
    if name == "sbm":
        return sbm_graph(**kw)[0]
    if name == "rmat":
        return rmat_graph(**kw)
    if name == "grid":
        return grid_graph(**kw)
    if name == "ring":
        return ring_of_cliques(**kw)
    raise KeyError(name)


def gnn_node_labels(g, n_classes: int, *, seed: int = 0):
    """Planted labels: community-correlated (the port's Louvain on ``g``,
    on ``g``'s device), so GNN training can learn.  int32 numpy [nv]."""
    from repro_torch.core import LouvainConfig, louvain

    C, _ = louvain(g, LouvainConfig(max_passes=3), device=g.device)
    return (C.cpu().numpy() % n_classes).astype(np.int32)


# -- graph-event streams (temporal community tracking) ---------------------

@dataclasses.dataclass(frozen=True)
class GraphEvent:
    """One timestamped graph mutation in EXTERNAL vertex-id space.

    ``kind``: ``edge_add`` (insert/strengthen: ``+w``), ``edge_del``
    (remove: ``w`` is the weight being removed — the stream generator
    knows the current weight, so deletion events are self-contained),
    ``edge_delta`` (signed reweight by ``w``), ``vertex_add`` (``u`` is
    the new vertex's external id — chosen by the producer, never
    reused), ``vertex_del`` (``u``'s incident edges go with it;
    consumers need no separate edge events).
    """

    t: float
    kind: str
    u: int = -1
    v: int = -1
    w: float = 0.0


DEFAULT_CHURN_MIX = (("edge_add", 0.45), ("edge_del", 0.25),
                     ("edge_delta", 0.15), ("vertex_add", 0.08),
                     ("vertex_del", 0.07))


def graph_event_stream(g0: Graph, *, rate: float = 100.0, seed: int = 0,
                       mix=DEFAULT_CHURN_MIX, t0: float = 0.0,
                       min_vertices: int = 8, wire_degree: int = 3):
    """Infinite iterator of :class:`GraphEvent` with nondecreasing ``t``.

    Mutates a host-side mirror of ``g0`` so every event is valid against
    the evolving graph: ``edge_del`` always names a live edge with its
    full current weight, ``vertex_del`` a live vertex (never draining
    below ``min_vertices``), ``vertex_add`` mints a fresh external id
    and is followed by ``wire_degree`` ``edge_add`` events attaching it
    (same timestamp — they land in the same window).  Gaps between
    events are Exp(``rate``); external ids for ``g0`` are its internal
    ids ``0..n-1`` (the service's initial assignment), new vertices take
    ``n, n+1, ...``.
    """
    rng = np.random.default_rng(seed)
    n0 = int(g0.n_nodes)
    src = _host_array(g0.src)
    dst = _host_array(g0.dst)
    w = _host_array(g0.w)
    sel = (src < g0.n_cap) & (src <= dst)
    weights: Dict[Tuple[int, int], float] = {
        (int(a), int(b)): float(c)
        for a, b, c in zip(src[sel], dst[sel], w[sel])}
    live: List[int] = list(range(n0))
    next_ext = n0
    kinds = [k for k, _ in mix]
    probs = np.asarray([p for _, p in mix], float)
    probs = probs / probs.sum()
    t = float(t0)
    while True:
        t += float(rng.exponential(1.0 / rate))
        kind = kinds[int(rng.choice(len(kinds), p=probs))]
        if kind == "vertex_add":
            e = next_ext
            next_ext += 1
            yield GraphEvent(t, "vertex_add", u=e)
            k = min(wire_degree, len(live))
            for nb in rng.choice(live, size=k, replace=False):
                key = (min(e, int(nb)), max(e, int(nb)))
                weights[key] = weights.get(key, 0.0) + 1.0
                yield GraphEvent(t, "edge_add", u=key[0], v=key[1], w=1.0)
            live.append(e)
        elif kind == "vertex_del" and len(live) > min_vertices:
            i = int(rng.integers(len(live)))
            e = live.pop(i)
            for key in [k2 for k2 in weights if e in k2]:
                del weights[key]
            yield GraphEvent(t, "vertex_del", u=e)
        elif kind == "edge_del" and weights:
            key = list(weights)[int(rng.integers(len(weights)))]
            cur = weights.pop(key)
            yield GraphEvent(t, "edge_del", u=key[0], v=key[1], w=cur)
        elif kind == "edge_delta" and weights:
            key = list(weights)[int(rng.integers(len(weights)))]
            d = float(rng.uniform(0.25, 1.0))
            weights[key] += d
            yield GraphEvent(t, "edge_delta", u=key[0], v=key[1], w=d)
        else:                                     # edge_add (or fallback)
            a, b = rng.choice(live, size=2, replace=False)
            key = (min(int(a), int(b)), max(int(a), int(b)))
            weights[key] = weights.get(key, 0.0) + 1.0
            yield GraphEvent(t, "edge_add", u=key[0], v=key[1], w=1.0)


def _clique_edges(ids) -> List[Tuple[int, int]]:
    ids = list(ids)
    return [(ids[i], ids[j]) for i in range(len(ids))
            for j in range(i + 1, len(ids))]


def planted_timeline_script(*, clique: int = 8, n_cliques: int = 4,
                            window: float = 1.0, device=None):
    """Staged lifecycle scenario with ground truth.

    The initial graph is ``n_cliques`` disjoint ``clique``-vertex
    cliques — each one a community on its own (and trivially connected,
    so the zero-disconnected invariant holds from the seed detect).
    Then five windows of events:

    0. nothing                      -> continuations only
    1. the MOVER clique's internal
       edges dissolve and each
       member is wired into the
       TARGET clique              -> their communities **merge**
       (deterministic: mover vertices end with neighbors ONLY in the
       target community, so the warm local move must absorb them — a
       symmetric complete-bipartite bridge would instead oscillate)
    2. window 1 reversed            -> the merged community is left
       internally DISCONNECTED (the mover clique's component re-forms
       with no bridge), so the paper's split pass must cut it ->
       **split**
    3. every member of clique 2
       removed                      -> its community **dies**
    4. a fresh ``clique``-vertex
       clique added and wired       -> a community is **born**

    Returns ``(g0, windows, expected)``: ``g0`` on ``device`` (``None``
    = CUDA), ``windows[i]`` the event list for window ``i`` (timestamps
    inside ``(i*window, (i+1)*window)``
    — feed through :class:`repro_torch.timeline.tracker.WindowedIngest` with
    the same ``window``), ``expected[i]`` the exact multiset of
    non-continuation lifecycle kinds the window must produce.
    """
    if clique < 3 or n_cliques < 3:
        raise ValueError("need clique >= 3 and n_cliques >= 3")
    # Interleaved membership (clique k = ids congruent to k) rather than
    # contiguous blocks: the service renumbers communities densely, so
    # clique k's label is the small integer k — and the warm handshake
    # can NEVER move a vertex into a community whose label equals its own
    # id (both sides of the parity test hash the same integer).  With
    # contiguous blocks the merge target's label collides with a merging
    # member's id (vertex 1 vs label 1) and one straggler is guaranteed.
    # The mover/target pair below (last clique -> clique 0) is likewise
    # parity-audited: every mover id's `_hash_parity` stream diverges
    # from label 0's within 4 sweeps and the join sequence never leaves
    # two consecutive gainless sweeps, so the warm loop provably outlives
    # every schedule block and the merge completes deterministically
    # (the timeline tests assert the exact event sequence).
    groups = [[k + n_cliques * j for j in range(clique)]
              for k in range(n_cliques)]
    n0 = clique * n_cliques
    pairs = [p for grp in groups for p in _clique_edges(grp)]
    u = np.asarray([p[0] for p in pairs], np.int32)
    v = np.asarray([p[1] for p in pairs], np.int32)
    g0 = from_undirected(n0, u, v, device=device)

    def stamp(i, evs):
        # spread inside the window, strictly before its end
        dt = window / (len(evs) + 1)
        return [dataclasses.replace(e, t=i * window + (j + 1) * dt)
                for j, e in enumerate(evs)]

    # each mover-clique member trades its internal edges for wires into
    # the target clique (ceil(clique/2) of them — enough pull, still
    # asymmetric); mover = last clique, target = clique 0 (see the
    # parity audit above)
    movers, target = groups[-1], groups[0]
    inner0 = _clique_edges(movers)
    k_wire = max(2, clique // 2)
    bridges = [(a, target[(i + j) % clique])
               for i, a in enumerate(movers) for j in range(k_wire)]
    w1 = ([GraphEvent(0.0, "edge_del", u=a, v=b, w=1.0) for a, b in inner0]
          + [GraphEvent(0.0, "edge_add", u=a, v=b, w=1.0)
             for a, b in bridges])
    w2 = ([GraphEvent(0.0, "edge_add", u=a, v=b, w=1.0) for a, b in inner0]
          + [GraphEvent(0.0, "edge_del", u=a, v=b, w=1.0)
             for a, b in bridges])
    w3 = [GraphEvent(0.0, "vertex_del", u=x) for x in groups[2]]
    newbies = list(range(n0, n0 + clique))
    w4 = ([GraphEvent(0.0, "vertex_add", u=x) for x in newbies]
          + [GraphEvent(0.0, "edge_add", u=a, v=b, w=1.0)
             for a, b in _clique_edges(newbies)])
    windows = [stamp(0, []), stamp(1, w1), stamp(2, w2), stamp(3, w3),
               stamp(4, w4)]
    expected = [[], ["merge"], ["split"], ["death"], ["birth"]]
    return g0, windows, expected
