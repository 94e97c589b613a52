"""GSP-Louvain multi-pass loop (paper Algorithm 3; port of
``repro/core/louvain.py``).

Each pass runs local-moving -> splitting (SP variants) -> convergence
checks -> renumber -> dendrogram lookup -> aggregation -> threshold
scaling, in the paper's order: the split happens *before* the ``l_i <= 1``
break, so the returned partition is split-clean for every ``sp-*`` mode.
The reference's ``lax.while_loop`` over passes is a Python loop here; the
pass that sets ``done`` still applies its local-move and split to the
top-level membership and only skips the aggregation, as the reference's
frozen graph does.  Each pass works on the live edges only: the ghost
padding that keeps the reference's shapes static is stripped after every
aggregation (``graph.container.strip_padding``).

Split policies (``LouvainConfig.split``), all eight of the reference's:
'none'; 'sp-lp' / 'sp-lpp' / 'sp-pj' (split every pass; 'sp-pj' is
GSP-Louvain, the default); 'sl-lp' / 'sl-lpp' / 'sl-pj' (split once,
after the last pass); 'refine' (Leiden-style refinement in the split slot,
:func:`refine_labels`).  One departure from the reference: a refinement
can leave a part unconnected, and the reference returns such communities
(ROADMAP C.7), so 'refine' ends by splitting any community that came out
unconnected into its connected pieces.  Where none did, the labels are
the reference's.

``scan`` picks the phases' formulation: 'sort' (the sortscan) or 'dense'
(local move and split on ``[nv, nv]`` matrices with one adjacency a pass
shared by the two; both scans aggregate by the sort formulation, see
``core/aggregate.py``); the two give the same labels and stats bit for
bit.

:func:`louvain_staged` is the reference's Figure-5 entry point: the same loop
with wall seconds per phase and per pass, and the reference's host
arithmetic in float64.  :func:`louvain_tile` is the pass loop of the
batched engine's tile, for several graphs of one bucket at once (either
scan, every split policy).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import _segments as seg
from repro_torch.core.aggregate import aggregate, aggregate_union
from repro_torch.core.local_move import (dense_adjacency, local_move,
                                         local_move_tile, tile_adjacency)
from repro_torch.core.split import split_labels, split_labels_tile
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as col
from repro_torch.graph.container import (Graph, GraphUnion, strip_padding,
                                         union_of)
from repro_torch.kernels import ops

SPLITS = ("none", "sp-lp", "sp-lpp", "sp-pj", "sl-lp", "sl-lpp", "sl-pj",
          "refine")
SCANS = ("sort", "dense")


@dataclasses.dataclass(frozen=True)
class LouvainConfig:
    max_passes: int = 10
    max_iters: int = 20
    tolerance: float = 1e-2
    tolerance_drop: float = 10.0
    aggregation_tolerance: float = 0.8
    split: str = "sp-pj"          # none | {sp,sl}-{lp,lpp,pj} | refine
    sync: str = "handshake"       # handshake | parity | all
    prune: bool = True
    split_max_iters: int = 0      # 0 = graph-size bound


def _check_split(split: str) -> None:
    if split not in SPLITS:
        raise ValueError(f"split must be one of {SPLITS}, got {split!r}")


def _check_scan(scan: str) -> None:
    if scan not in SCANS:
        raise ValueError(f"scan must be one of {SCANS}, got {scan!r}")


def _split_mode(split: str) -> str:
    return split.split("-")[1] if "-" in split else "pj"


class _Clock:
    """Adds wall seconds per phase into ``phase_seconds`` (when given),
    synchronizing the device at each phase edge so the time is the
    phase's own."""

    def __init__(self, phase_seconds, device):
        self.out = phase_seconds
        self.sync = (torch.cuda.synchronize if device.type == "cuda"
                     else (lambda: None))

    def run(self, phase, fn, *args, **kw):
        if self.out is None:
            return fn(*args, **kw)
        self.sync()
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        self.sync()
        self.out[phase] = self.out.get(phase, 0.0) + time.perf_counter() - t0
        return res


def refine_labels(src, dst, w, C, two_m, *, tau, max_iters: int = 10,
                  scan: str = "sort", adj=None, owned=None, group=None,
                  gidx=None, m_total=None):
    """Leiden refinement: local-move from singletons within each community
    of ``C`` (cross-community weights zeroed, zero-weight edges kept in the
    edge list), scored against the full graph's ``two_m``.  Returns a
    refinement of ``C``.  A move needs a positive in-community edge, but a
    part can still come out unconnected, as in the reference: vertices
    join a neighbour's community, and that neighbour moves on in a later
    sweep (ROADMAP C.7).

    As in the reference, the local move runs with its default ``sync``
    ('handshake') and ``prune`` (True), whatever the pass's config says,
    and with the pass's ``scan``.  ``adj`` shares the dense scan's
    adjacency of the same edges (the masked edges keep every pair).
    ``owned``, ``group``, ``gidx`` and ``m_total`` are the sharded
    driver's (see ``local_move``): on a rank of ``group``, ``K_in`` takes
    a disjoint-support ``psum``.  The reference's ``skip`` has no
    counterpart in this host loop, and its backend knobs none on a
    device-dispatched reduce.
    """
    nv = C.shape[0]
    w_in = torch.where(C[src] == C[dst], w, 0.0)
    K_in = col.psum(ops.segreduce_sorted(w_in, src, nv, op="sum"), group)
    C0 = torch.arange(nv, dtype=torch.int32, device=C.device)
    R, _, _ = local_move(src, dst, w_in, C0, K_in, K_in, two_m, tau=tau,
                         max_iters=max_iters, scan=scan, adj=adj,
                         owned=owned, group=group, gidx=gidx,
                         m_total=m_total)
    return R


def refine_labels_tile(src, dst, w, C, two_m, *, counts, tau,
                       max_iters: int = 10, scan: str = "dense", adj=None):
    """:func:`refine_labels` of each graph of a tile: ``C`` ``[b * nv]``
    in a ``GraphUnion``'s slots (``counts`` its per-graph live edges, host
    ints), ``two_m`` float32 ``[b]``, each graph's 2m.  The
    cross-community weights are zeroed and every edge kept, so on the
    dense scan the pass's
    :func:`~repro_torch.core.local_move.tile_adjacency` ``adj`` is shared
    (the sortscan needs none); ``K_in`` is one segment sum over the
    union's slots; the local move (``scan``) starts from singletons with
    its own defaults ('handshake', pruning), as :func:`refine_labels`'s
    does.  Returns the refined labels ``[b * nv]``, each graph's the bits
    of :func:`refine_labels` on it alone."""
    n = C.shape[0]
    w_in = torch.where(C[src] == C[dst], w, 0.0)
    K_in = ops.segreduce_sorted(w_in, src, n, op="sum")
    C0 = torch.arange(n, dtype=torch.int32, device=C.device)
    R, _, _, _ = local_move_tile(src, dst, w_in, C0, K_in, K_in, two_m,
                                 counts=counts, tau=tau, max_iters=max_iters,
                                 scan=scan, adj=adj)
    return R


def _split_slot(cfg: LouvainConfig, src, dst, w, C, two_m, tau, scan, adj):
    """The labels the pass's split slot gives: refined or split ``C``."""
    if cfg.split == "refine":
        return refine_labels(src, dst, w, C, two_m, tau=tau,
                             max_iters=cfg.max_iters, scan=scan, adj=adj)
    labels, _ = split_labels(src, dst, w, C, mode=_split_mode(cfg.split),
                             max_iters=cfg.split_max_iters,
                             impl=_split_impl(scan), adj=adj)
    return labels


def _split_impl(scan: str) -> str:
    return "dense" if scan == "dense" else "coo"


def _split_unconnected(live, C, node_mask):
    """``(C, moved)``: ``C`` with every unconnected community split into
    its connected pieces (pointer jumping), and the vertices moved out of
    the piece that holds their community's smallest id.  Where every
    community is connected, ``C`` comes back as it was, with 0."""
    nv = C.shape[0]
    L, _ = split_labels(*live, C, mode="pj")
    n_pieces, n_comms = (int(seg.count_communities(x, node_mask, nv))
                         for x in (L, C))
    if n_pieces == n_comms:
        return C, 0
    s_c, perm = torch.sort(C, stable=True)
    first = ops.segreduce_sorted(L[perm], s_c, nv, op="min")
    moved = int(torch.sum((L != first[C]) & node_mask))
    return seg.renumber(L, node_mask, nv)[0], moved


def _split_unconnected_tile(edges, C, node_mask):
    """:func:`_split_unconnected` of each graph of a tile: ``edges`` the
    graphs' live edges, as the
    :func:`~repro_torch.core.local_move.tile_adjacency` ``[b, nv, nv]``
    (the dense scan) or as their
    :class:`~repro_torch.graph.container.GraphUnion` (the sortscan), ``C``
    and ``node_mask`` ``[b * nv]`` in union slots.  Returns ``(C,
    moved)``, ``moved`` int64 numpy ``[b]``.

    The split is the dense one on each graph's adjacency, or the coo one
    on the union, as the single-graph repair runs it (the same ``nv``
    round limit; no edge crosses graphs, so each graph's labels are its
    own): both reach the same integer fixpoint.  Pieces and communities
    are counted per graph in one host copy; only a graph whose counts
    differ is renumbered from its pieces, and the rest keep ``C`` as it
    was, with 0 moved."""
    if isinstance(edges, GraphUnion):
        b, nv = edges.b, edges.nv
        L, _ = split_labels(edges.src, edges.dst, edges.w, C, mode="pj",
                            max_iters=nv)
    else:
        b, nv, _ = edges.shape
        slot = torch.arange(b * nv, dtype=torch.int32, device=C.device)
        base = slot - torch.remainder(slot, nv)
        L = split_labels_tile((C - base).view(b, nv), edges, mode="pj"
                              ).view(b * nv) + base
    n = b * nv
    counts = torch.stack([seg.count_communities_tile(x, node_mask, b)
                          for x in (L, C)]).cpu().numpy()
    split = counts[0] != counts[1]
    if not split.any():
        return C, np.zeros(b, np.int64)
    s_c, perm = torch.sort(C, stable=True)
    first = ops.segreduce_sorted(L[perm], s_c, n, op="min")
    moved = torch.sum(((L != first[C]) & node_mask).view(b, nv), dim=1)
    split_t = torch.from_numpy(split).to(C.device)
    renumbered = seg.renumber_tile(L, node_mask, b)[0]
    C = torch.where(split_t.repeat_interleave(nv), renumbered, C)
    return C, np.where(split, moved.cpu().numpy(), 0)


def _louvain(g: Graph, cfg: LouvainConfig, clock: _Clock,
             pass_seconds: list | None = None, scan: str = "sort"):
    """The pass loop of :func:`louvain_impl`; with ``pass_seconds`` (the
    staged entry point) it appends each pass's wall seconds there and keeps
    ``tau`` and the shrink test in float64 on the host, as the reference's
    ``louvain_staged`` does (its ``louvain_impl`` keeps them in float32).
    ``scan='dense'`` builds one bool[nv, nv] adjacency a pass, shared by
    the local move and the split slot, and runs the dense split."""
    _check_split(cfg.split)
    _check_scan(scan)
    dense = scan == "dense"
    staged = pass_seconds is not None
    nv = g.nv
    dev = g.device
    two_m = g.total_weight_2m()
    in_slot = cfg.split == "refine" or cfg.split.startswith("sp")
    ids = torch.arange(nv, dtype=torch.int32, device=dev)

    # the reference's fixed capacities exist for jit: work on live edges
    live = strip_padding(g.src, g.dst, g.w, g.ghost)
    esrc, edst, ew = live
    Ctop = ids
    n_cur = int(g.n_nodes)
    tau = float(cfg.tolerance) if staged else np.float32(cfg.tolerance)
    drop = cfg.tolerance_drop if staged else np.float32(cfg.tolerance_drop)
    passes = li = li_total = split_moved = 0
    done = False
    while not done and passes < cfg.max_passes:
        if staged:
            clock.sync()
            t_pass = time.perf_counter()
        node_valid = ids < n_cur
        # aggregation emits run-sorted super-edges, so esrc stays sorted
        K = clock.run("other", ops.segreduce_sorted, ew, esrc, nv, op="sum")
        adj = (clock.run("other", dense_adjacency, esrc, edst, nv)
               if dense else None)
        C, _, li = clock.run(
            "local_move", local_move, esrc, edst, ew, ids, K, K, two_m,
            tau=tau, max_iters=cfg.max_iters, sync=cfg.sync, prune=cfg.prune,
            scan=scan, adj=adj)
        labels = (clock.run("split", _split_slot, cfg, esrc, edst, ew, C,
                            two_m, tau, scan, adj) if in_slot else C)
        C_dense, n_comms = clock.run("other", seg.renumber, labels,
                                     node_valid, nv)
        # split-pass trigger count: vertices the split moved (telemetry)
        split_moved += int(torch.sum((labels != C) & node_valid))
        Ctop = C_dense[Ctop]
        n_comms = int(n_comms)
        passes += 1
        li_total += li
        if staged:   # the reference's pass time leaves out aggregation
            pass_seconds.append(time.perf_counter() - t_pass)
            low_shrink = n_comms > cfg.aggregation_tolerance * n_cur
        else:
            low_shrink = np.float32(n_comms) > (
                np.float32(cfg.aggregation_tolerance) * np.float32(n_cur))
        done = li <= 1 or low_shrink
        if not done:   # the reference freezes the graph on the last pass
            esrc, edst, ew = clock.run(
                "aggregate", lambda: strip_padding(
                    *aggregate(esrc, edst, ew, C_dense), g.ghost))
            n_cur = n_comms
            tau = tau / drop

    node_mask = g.node_mask()
    if cfg.split.startswith("sl"):
        # split last: once, on the original graph's top-level labels
        labels, _ = clock.run("split", split_labels, *live, Ctop,
                              mode=_split_mode(cfg.split),
                              max_iters=cfg.split_max_iters,
                              impl=_split_impl(scan))
        split_moved += int(torch.sum((labels != Ctop) & node_mask))
        Ctop, _ = seg.renumber(labels, node_mask, nv)
    elif cfg.split == "refine":
        Ctop, moved = clock.run("split", _split_unconnected, live, Ctop,
                                node_mask)
        split_moved += moved
    n_final = int(seg.count_communities(Ctop, node_mask, nv))
    stats = dict(passes=passes, li_last=li, li_total=li_total,
                 split_moved=split_moved, n_communities=n_final)
    return Ctop, stats


def louvain_impl(g: Graph, cfg: LouvainConfig = LouvainConfig(), *,
                 scan: str = "sort", phase_seconds: dict | None = None):
    """Run GSP-Louvain on ``g`` where it lies.

    Returns ``(C int32[nv] dense top-level membership, stats)`` with stats
    passes / li_last / li_total / split_moved / n_communities as Python
    ints.  Ghost and padding vertices map to the trailing community ids.

    ``scan``: 'sort' (the sortscan) or 'dense' (local move and split on
    ``[nv, nv]`` matrices, for small graphs); the two give the same labels
    and stats bit for bit.

    ``phase_seconds``: a dict to which the wall seconds of each phase
    (local_move, split, aggregate, other) are added, with the device
    synchronized at every phase edge; ``None`` adds no synchronization.
    """
    return _louvain(g, cfg, _Clock(phase_seconds, g.device), scan=scan)


def louvain(g: Graph, cfg: LouvainConfig | None = None, *,
            scan: str = "sort", device=None, mesh=None):
    """GSP-Louvain, the public entry point: ``(C, stats)``.

    ``scan``: 'sort', 'dense' or 'auto', which means 'sort' here as in the
    reference's ``louvain()`` (only ``detect()`` resolves 'auto' by the
    graph's shape).  Runs on ``device`` (``None`` = CUDA; raises when CUDA
    is absent), moving the graph there first if needed.

    ``mesh`` (an int or a ``launch.mesh.Mesh``) routes to the sharded
    driver, ``core/distributed.py:louvain_sharded``, whose labels are the
    single-device ones bit for bit; an int is that many ranks on
    ``device``'s kind.  The dense scan is single-device only.
    """
    g = g.to(resolve_device(device))
    cfg = cfg if cfg is not None else LouvainConfig()
    if mesh is not None:
        if scan == "dense":
            raise ValueError("scan='dense' is single-device only")
        from repro_torch.core.distributed import louvain_sharded
        return louvain_sharded(g, cfg, mesh=mesh)
    return louvain_impl(g, cfg, scan="sort" if scan == "auto" else scan)


def louvain_staged(g: Graph, cfg: LouvainConfig | None = None, *,
                   device=None):
    """Host-staged GSP-Louvain with per-phase and per-pass wall times (the
    paper's Figure 5): ``(C, stats)``, where stats also carries
    ``phase_seconds`` = {local_move, split, aggregate, other} and
    ``pass_seconds``, one entry a pass (aggregation left out, as in the
    reference).

    ``tau`` is divided and the shrink test made in float64 on the host, as
    in the reference's ``louvain_staged``, so its labels equal that one's
    (they can differ from :func:`louvain_impl`'s, which uses float32).
    Runs on ``device`` (``None`` = CUDA; raises when CUDA is absent).
    """
    g = g.to(resolve_device(device))
    phase = dict(local_move=0.0, split=0.0, aggregate=0.0, other=0.0)
    pass_seconds: list[float] = []
    C, stats = _louvain(g, cfg if cfg is not None else LouvainConfig(),
                        _Clock(phase, g.device), pass_seconds)
    stats.update(phase_seconds=phase, pass_seconds=pass_seconds)
    return C, stats


def louvain_tile(stacked: Graph, cfg: LouvainConfig = LouvainConfig(), *,
                 union: GraphUnion | None = None, scan: str = "dense"):
    """The pass loop of :func:`louvain_impl` for the ``b`` graphs of a
    :func:`stack_graphs` result at once, the batched engine's tile, with
    any split policy and either ``scan``.  Returns ``(C int32 [b, nv],
    stats, union)``: each graph's top-level labels and stats, the bits of
    ``louvain_impl(scan=scan)`` on it alone, and the
    :class:`~repro_torch.graph.container.GraphUnion` of its live edges
    (the detector and the modularity run on it; ``union`` passes one
    already made of ``stacked``).

    The graphs still in the loop form one union a pass: one ``K``, one
    :func:`~repro_torch.core.local_move.local_move_tile`, one split slot
    (the split for 'sp-*', :func:`refine_labels_tile` for 'refine',
    nothing for 'none' and 'sl-*'), one renumber and one aggregation for
    all.  Each graph keeps its own ``li``, community count, ``n_cur``,
    float32 shrink test and stats; all start together, so they share the
    pass index and ``tau``.  A graph whose loop is done (``li <= 1`` or a
    low shrink) leaves the union at the aggregation, its labels final.
    Each pass reads the community counts and split moves of all its
    graphs in one host copy.  After the loop, 'sl-*' splits every graph
    once and 'refine' splits what refinement left unconnected
    (:func:`_split_unconnected_tile`), both on the original live edges.

    The dense scan builds one :func:`~repro_torch.core.local_move.
    tile_adjacency` ``[b, nv, nv]`` a pass, shared by the local move, the
    refinement and ``split_labels_tile``.  The sortscan builds none: its
    sweeps sort the union's edges, and every split is the coo
    :func:`~repro_torch.core.split.split_labels` on the union with the
    lone graph's round limit.  That split is an integer fixpoint and a
    graph at its fixpoint maps to itself, so the rounds the union runs
    past one graph's last change leave its labels as they were; no edge
    crosses graphs, so each graph's labels are its own."""
    _check_split(cfg.split)
    _check_scan(scan)
    dense = scan == "dense"
    b, nv, dev = stacked.src.shape[0], stacked.nv, stacked.device
    union = union_of(stacked) if union is None else union
    # 2m over each graph's padded edges, as Graph.total_weight_2m
    two_m = ops.sum_inorder_per_graph(stacked.w.reshape(-1),
                                      (stacked.m_cap,) * b)
    n_nodes = stacked.n_nodes.cpu().numpy().astype(np.int64)
    local = torch.arange(nv, dtype=torch.int32, device=dev)
    Ctop = local.repeat(b, 1)
    esrc, edst, ew, counts = union.src, union.dst, union.w, union.counts
    # the original live edges: their tile adjacency, or their union
    adj0 = tile_adjacency(esrc, edst, b, nv) if dense else None
    refine = cfg.split == "refine"
    mode = _split_mode(cfg.split)
    split_iters = cfg.split_max_iters if cfg.split_max_iters > 0 else nv
    pos = np.arange(b)              # the graphs in the union, in order
    n_cur = n_nodes.copy()
    tau = np.float32(cfg.tolerance)
    drop = np.float32(cfg.tolerance_drop)
    agg = np.float32(cfg.aggregation_tolerance)
    passes, li_last, li_total, split_moved = (np.zeros(b, np.int64)
                                              for _ in range(4))
    n_pass = 0
    while pos.size and n_pass < cfg.max_passes:
        a = pos.size
        pos_t = torch.from_numpy(pos).to(dev)
        ids = torch.arange(a * nv, dtype=torch.int32, device=dev)
        base = ids - torch.remainder(ids, nv)
        node_valid = (local[None, :] < torch.from_numpy(n_cur[pos]).to(dev)[
            :, None]).view(a * nv)
        K = ops.segreduce_sorted(ew, esrc, a * nv, op="sum")
        adj = None
        if dense:
            adj = adj0 if n_pass == 0 else tile_adjacency(esrc, edst, a, nv)
        two_m_a = two_m[pos_t]
        C, _, li, _ = local_move_tile(
            esrc, edst, ew, ids, K, K, two_m_a, counts=counts, tau=tau,
            max_iters=cfg.max_iters, sync=cfg.sync, prune=cfg.prune,
            scan=scan, adj=adj)
        if refine:
            labels = refine_labels_tile(esrc, edst, ew, C, two_m_a,
                                        counts=counts, tau=tau,
                                        max_iters=cfg.max_iters, scan=scan,
                                        adj=adj)
        elif cfg.split.startswith("sp") and dense:
            labels = split_labels_tile((C - base).view(a, nv), adj,
                                       mode=mode,
                                       max_iters=cfg.split_max_iters
                                       ).view(a * nv) + base
        elif cfg.split.startswith("sp"):
            labels, _ = split_labels(esrc, edst, ew, C, mode=mode,
                                     max_iters=split_iters)
        else:
            labels = C
        C_dense, n_comms = seg.renumber_tile(labels, node_valid, a)
        moved = torch.sum(((labels != C) & node_valid).view(a, nv), dim=1)
        n_comms, moved = torch.stack([n_comms.to(torch.int64), moved]
                                     ).cpu().numpy()
        Ctop[pos_t] = torch.gather(C_dense.view(a, nv), 1,
                                   Ctop[pos_t].long()) - base.view(a, nv)
        n_pass += 1
        passes[pos] += 1
        li_last[pos] = li
        li_total[pos] += li
        split_moved[pos] += moved
        low_shrink = n_comms.astype(np.float32) > agg * n_cur[pos].astype(
            np.float32)
        cont = ~((li <= 1) | low_shrink)
        if not cont.any() or n_pass == cfg.max_passes:
            break
        # the reference freezes a done graph; here it leaves the union
        keep = None if cont.all() else torch.from_numpy(cont).to(dev)
        esrc, edst, ew, counts = aggregate_union(esrc, edst, ew, C_dense,
                                                 nv, keep)
        if keep is not None:     # close the gaps the done graphs leave
            shift = torch.from_numpy(
                ((np.arange(a) - np.cumsum(cont) + 1) * nv).astype(np.int32)
            ).to(dev)
            esrc = esrc - shift[torch.div(esrc, nv, rounding_mode="floor")
                                .long()]
            edst = edst - shift[torch.div(edst, nv, rounding_mode="floor")
                                .long()]
            counts = counts[cont]
        counts = tuple(int(x) for x in counts)
        n_cur[pos[cont]] = n_comms[cont]
        pos = pos[cont]
        tau = tau / drop

    full = torch.arange(b * nv, dtype=torch.int32, device=dev)
    base = full - torch.remainder(full, nv)
    top = Ctop.view(b * nv) + base
    node_mask = (local[None, :] < stacked.n_nodes[:, None]).view(b * nv)
    if cfg.split.startswith("sl"):
        # split last: once, on the original graphs' top-level labels
        if dense:
            labels = split_labels_tile(Ctop, adj0, mode=mode,
                                       max_iters=cfg.split_max_iters
                                       ).view(b * nv) + base
        else:
            labels, _ = split_labels(union.src, union.dst, union.w, top,
                                     mode=mode, max_iters=split_iters)
        split_moved += torch.sum(((labels != top) & node_mask).view(b, nv),
                                 dim=1).cpu().numpy()
        top = seg.renumber_tile(labels, node_mask, b)[0]
    elif refine:
        top, moved = _split_unconnected_tile(adj0 if dense else union, top,
                                             node_mask)
        split_moved += moved
    Ctop = (top - base).view(b, nv)
    n_final = seg.count_communities_tile(top, node_mask, b).tolist()
    stats = [dict(passes=int(passes[g]), li_last=int(li_last[g]),
                  li_total=int(li_total[g]), split_moved=int(split_moved[g]),
                  n_communities=int(n_final[g])) for g in range(b)]
    return Ctop, stats, union
