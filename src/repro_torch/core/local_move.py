"""Local-moving phase of GSP-Louvain (paper Algorithm 4; port of
``repro/core/local_move.py``): the sortscan and its dense twin.

The whole edge set is sorted by ``(src, C[dst])`` once per half-sweep;
equal keys form runs and one in-order run sum yields every ``K_{i->c}``
(one "hashtable" for the entire graph).  Delta-modularity (paper Eq. 2) is
scored per run representative, and a sorted segment max/min per source
vertex picks the best destination community.  The synchronization policy,
anchored joins, pruning and best-Q tracking are the reference's: see its
module docstring.  Here the ``lax.while_loop`` is a Python loop driven from
the host, which reads one scalar per sweep to test convergence.

``scan='dense'`` (:func:`_half_sweep_dense`, for small ``nv``) takes the
same decisions on ``[nv, nv]`` community matrices filled from the same
in-order run sums, and wakes neighbours through a bool[nv, nv] adjacency;
its results are the sortscan's bit for bit.

Every reduction that feeds a move or a convergence decision folds in index
order: the sorted ones through the segment-reduce kernel, the Sigma
recompute keyed by the unsorted ``C_new`` through a stable sort and the
same kernel (``ops.segment_sum_inorder``).  The two flat sums of
:func:`realized_modularity`, which feed the best-Q and convergence tests,
and 2m (``Graph.total_weight_2m``), which scales every Eq.-2 score, are
fixed-order trees of in-order folds (``ops.sum_inorder``): the same bits
on the card and on the CPU.  They round like any float32 sum once they
pass 2**24, so they need not equal the reference's ``jnp.sum``, which
folds in another order.

``seg_impl='scatter'`` runs the reference's unfused sweep,
:func:`_half_sweep_scatter` (separate run sums and run fields, then
reductions by run vertex), the paired baseline of the fused one: the same
bits, on the same kernel.

:func:`local_move_tile` is the sweep loop of the batched engine's tile:
the graphs of one bucket laid out as one union of ``b * nv`` slots, swept
in lockstep by either scan (the dense half-sweep and realized modularity
with a graph axis, or the sortscan's half-sweep on the union, which
builds no ``[b, nv, nv]`` matrix), every convergence decision kept per
graph.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import _segments as seg
from repro_torch.distributed import collectives as col
from repro_torch.graph.container import union_ghosts
from repro_torch.kernels import ops
from repro_torch.kernels.dense_sweep import (dense_half_sweep_cuda,
                                             dense_modularity_cuda, edge_rows)

NEG = float("-inf")
_U32 = 0xFFFFFFFF


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32): split ``c`` in
    16-bit halves so no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _parity(ids: torch.Tensor, salts) -> torch.Tensor:
    h = (_mul_u32(ids.to(torch.int64) & _U32, 0x9E3779B1) + salts) & _U32
    h = _mul_u32(h ^ (h >> 16), 0x45D9F3B)
    return ((h >> 13) & 1).to(torch.int32)


def _salt(it: int, mul: int) -> int:
    return ((int(it) & _U32) * mul) & _U32


def _hash_parity(ids: torch.Tensor, it: int) -> torch.Tensor:
    """Iteration-salted pseudo-random parity bit per id (int32).

    The reference's uint32 wraparound arithmetic, emulated in int64 with a
    mask after every multiply, add and shift.  Salting with the iteration
    re-rolls the mover/target bipartition every sweep (see the reference).
    """
    return _parity(ids, _salt(it, 0x85EBCA77))


def _parity_table(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``_hash_parity(ids, it)`` for every ``it`` in ``range(n)`` as one
    int32 ``[n, len(ids)]`` table, in the same integer operations: a loop
    of small sweeps reads a row a sweep instead of hashing again."""
    salts = torch.tensor([_salt(it, 0x85EBCA77) for it in range(n)],
                         dtype=torch.int64, device=ids.device)[:, None]
    return _parity(ids, salts)


@functools.lru_cache(maxsize=32)
def _parity_masks(nv: int, n: int, device: torch.device):
    """``(pbits == 0, pbits == 1)`` for the :func:`_parity_table` of the
    vertex ids ``[0, nv)``: bool ``[n, nv]`` each, the movers and the
    targets of each parity in each of ``n`` sweeps.  Cached by shape,
    since a service sweeps graphs of the same few widths over and over;
    callers only read them."""
    pbits = _parity_table(torch.arange(nv, dtype=torch.int32, device=device),
                          n)
    return pbits == 0, pbits == 1


def realized_modularity(src, dst, w, C, Sigma, two_m, *, group=None,
                        gidx=None, m_total=None) -> torch.Tensor:
    """Q of the current partition: two flat reductions (internal edge
    weight, sum of Sigma^2), each in one fixed order on every device.

    On a rank of ``group`` (the sharded driver, ``core/distributed.py``)
    the masked weights of this shard's edges go to their global live-edge
    slots ``gidx`` of an ``[m_total + 1]`` vector, and the ``psum`` adds
    only disjoint-support zeros (``x + 0.0 == x``).  So ``full[:m_total]``
    is elementwise the single-device masked-weight vector, at the same
    length, and the same ``sum_inorder`` over it gives the same bits:
    ``sum_inorder``'s tree depends on the length, so the vector must be
    the whole one.  A ``psum`` of per-rank scalar partials would fold in
    another order.  Sigma is replicated, so its sum needs no collective.
    Without ``gidx`` (the approximate harness, ``community_pass``) the
    internal weight is summed by vertex, as the reference's is there.
    """
    w_in = torch.where(torch.index_select(C, 0, src)
                       == torch.index_select(C, 0, dst), w, 0.0)
    if group is not None and gidx is not None:
        full = torch.zeros(m_total + 1, dtype=torch.float32, device=C.device)
        full[gidx.long()] = w_in
        w_in = col.psum(full, group)[:m_total]
    elif group is not None:
        # the approximate harness, which has no global slots (as in the
        # reference): each vertex's internal weight, merged by a
        # disjoint-support psum, then summed over the vertices
        w_in = col.psum(ops.segreduce_sorted(w_in, src, C.shape[0],
                                             op="sum"), group)
    internal = ops.sum_inorder(w_in)
    sig2 = ops.sum_inorder(Sigma * Sigma)
    return internal / two_m - sig2 / (two_m * two_m)


def _half_sweep(src, dst, w, C, K, Sigma, two_m, movable, target_ok=None,
                anchored=True, owned=None, group=None, gain=True, graphs=1):
    """One synchronous half-sweep (fused sortscan).  Returns
    ``(C_new, Sigma_new, moved, gain, want)``.

    ``target_ok``: bool[nv] — moves only into communities flagged True (the
    handshake schedule).  ``anchored``: join-attraction counts only frozen
    neighbours; off for the 'all' ablation, where nothing is frozen.

    On a rank of ``group``, ``src``/``dst``/``w`` are this shard's edges
    and ``owned`` (bool[nv]) the vertices whose out-edges they all are:
    only owned vertices are candidates, ``C_new``, ``moved`` and ``want``
    merge the owners' decisions (an int32 ``psum`` of disjoint rows, a
    ``psum`` and a ``pmax``), and every rank recomputes Sigma from the
    replicated K and ``C_new`` with the single-device in-order fold; it is
    never merged.  ``gain`` stays this shard's (no caller reads it);
    ``gain=False`` returns ``None`` for it, as the dense twin does.

    ``graphs = b > 1`` sweeps a tile, the sortscan's union: the ``b * nv``
    slots of a :class:`~repro_torch.graph.container.GraphUnion` (its live
    edges, ``src`` sorted and graph-major), community ids in their own
    graph's slots, ``two_m`` float32 ``[b]``, each graph's ghost at its
    local ``nv - 1``.  No edge crosses graphs and the union keeps each
    graph's edges in their order, so the stable ``(src, C[dst])`` sort
    gives each graph's runs in their lone order, each run folds its
    elements in the lone order, and Sigma's sort by ``C_new`` keeps vertex
    order inside each community.  Each element reads its own graph's 2m
    and ghost slot (``c_star``'s empty fill is ``INT_MAX``, so a vertex
    moves only below its own graph's ghost), and every graph's ghost is
    reset in ``C_new``: each graph's outputs are the bits of its
    half-sweep alone, and ``gain`` is ``[b]``.  ``owned`` and ``group``
    are single-graph only.
    """
    n = C.shape[0]
    nv = n // graphs
    m_cap = src.shape[0]
    ghost = n - 1               # the last slot parks K_own's other writes

    # --- scanCommunities: sort by (src, C[dst]); gather payloads ---------
    cd = C[dst]
    s_src, s_cd, perm = seg.sort_runs(src, cd)
    s_dst = dst[perm]
    s_w = w[perm]
    if graphs > 1:   # each element's own graph: its ghost slot and 2m
        g_e = torch.div(s_src, nv, rounding_mode="floor")
        ghost_e = g_e * nv + (nv - 1)
        two_m = torch.index_select(two_m, 0, g_e)
        slot = torch.arange(n, dtype=torch.int32, device=C.device)
        ghost_v = slot - torch.remainder(slot, nv) + (nv - 1)
    else:
        ghost_e = ghost_v = ghost
    not_self = s_src != s_dst  # exclude self-loops from scan (paper Alg. 4)
    w_all = torch.where(not_self, s_w, 0.0)
    w_frozen = (torch.where(not_self & ~movable[s_dst], s_w, 0.0)
                if anchored else w_all)
    starts = seg.run_starts(s_src, s_cd)
    rid = seg.run_ids(starts)
    # pass A: true and anchored K_{i->c} in ONE in-order run reduction
    Wc = seg.runs_reduce(torch.stack([w_all, w_frozen], dim=1), rid, m_cap)
    W_all_e = Wc[rid, 0]           # true K_{i->c}, per element of the run
    W_frz_e = Wc[rid, 1]           # anchored K_{i->c}

    # --- K_{i->d}: true weight to own community (excluding self) ---------
    # at most one own run per vertex: a scatter-set at own-run starts, with
    # every other element parked on the last slot and cleared after
    own_start = starts & (s_cd == C[s_src])
    K_own = torch.zeros(n, dtype=torch.float32, device=C.device)
    K_own[torch.where(own_start, s_src, ghost)] = torch.where(
        own_start, W_all_e, 0.0)
    K_own[ghost] = 0.0

    # --- delta-modularity per run representative (paper Eq. 2) -----------
    Ki = K[s_src]
    d_of_i = C[s_src]
    dq = (
        2.0 * (W_all_e - K_own[s_src]) / two_m
        - 2.0 * Ki * (Ki + Sigma[s_cd] - Sigma[d_of_i]) / (two_m * two_m)
    )
    valid = (starts & (s_src < ghost_e) & (s_cd < ghost_e)
             & (s_cd != d_of_i))
    cand = valid & (W_frz_e > 0.0) & movable[s_src]
    if owned is not None:
        cand = cand & owned[s_src]
    if target_ok is not None:
        cand = cand & target_ok[s_cd]
    # 'want': a positive move ignoring the schedule gates keeps a vertex
    # awake under pruning; zero-weight runs never count (see reference)
    base = valid & (W_all_e > 0.0)
    # pass B: want and best in one 2-channel sorted segment max
    dq_c = torch.where(cand, dq, NEG)
    mx = ops.segreduce_sorted(
        torch.stack([torch.where(base, dq, NEG), dq_c], dim=1), s_src, n,
        op="max")
    want = mx[:, 0] > 0.0
    best = mx[:, 1]

    # --- argmax per source vertex (min community id breaks ties) ---------
    is_best = cand & (dq_c >= best[s_src])
    c_star = ops.segreduce_sorted(torch.where(is_best, s_cd, seg.INT_MAX),
                                  s_src, n, op="min")
    move = (best > 0.0) & (c_star < ghost_v)
    C_new = torch.where(move, c_star, C)
    gain = _gain(move, best, graphs) if gain else None
    if group is not None:
        # merge the owners' decisions (each vertex owned by one shard)
        C_new = col.psum(torch.where(owned, C_new, 0), group)
        move = col.psum((owned & move).to(torch.int32), group) > 0
        want = col.pmax((want & owned).to(torch.int32), group) > 0
    if graphs > 1:
        ghosts = union_ghosts(graphs, nv, C.device)
        C_new[ghosts.long()] = ghosts
    else:
        C_new[ghost] = ghost

    # --- exact Sigma recompute (synchronous, in-order) --------------------
    Sigma_new = ops.segment_sum_inorder(K, C_new, n)
    return C_new, Sigma_new, move, gain, want


def _half_sweep_scatter(src, dst, w, C, K, Sigma, two_m, movable,
                        target_ok=None, anchored=True, owned=None,
                        group=None):
    """The reference's unfused sweep (``seg_impl='scatter'``): the same
    contract and the same five results as :func:`_half_sweep`, bit for
    bit, and like the reference's it needs no sorted ``src``.

    Its steps are the reference's: a stable sort of the edges by ``(src,
    C[dst])`` carrying both weight channels, two separate in-order run
    sums, the run fields (vertex and community of each run), K_own as a
    segment sum by run vertex, Eq.-2 scoring per run, two segment maxima
    (``want`` and ``best``), the segment-min argmax and the Sigma
    recompute.  The reference reduces by run vertex with
    ``jax.ops.segment_*``; here the run vertices are sorted (runs follow
    the ``(src, C[dst])`` order, and unused run slots hold the ghost id,
    the largest), so every such reduction is the sorted segment-reduce
    kernel's, and the Sigma recompute keyed by the unsorted ``C_new`` is
    the in-order one of :func:`_half_sweep`.  No float atomic decides
    anything.  ``owned`` and ``group`` as in :func:`_half_sweep`.
    """
    nv = C.shape[0]
    m_cap = src.shape[0]
    ghost = nv - 1

    # --- scanCommunities: sort by (src, C[dst]) and reduce runs ----------
    cd = C[dst]
    not_self = src != dst  # exclude self-loops from scan (paper Alg. 4)
    w_all = torch.where(not_self, w, 0.0)
    w_frozen = (torch.where(not_self & ~movable[dst], w, 0.0)
                if anchored else w_all)
    s_src, s_cd, s_wf, s_wa = seg.sort_by_key2(src, cd, w_frozen, w_all)
    starts = seg.run_starts(s_src, s_cd)
    rid = seg.run_ids(starts)
    W_ic = seg.runs_reduce(s_wf, rid, m_cap)
    W_ic_all = seg.runs_reduce(s_wa, rid, m_cap)
    i_run, run_valid = seg.run_field(s_src, starts, rid, m_cap, ghost)
    c_run, _ = seg.run_field(s_cd, starts, rid, m_cap, ghost)

    # --- K_{i->d}: true weight to own community (excluding self) ---------
    own = (c_run == C[i_run]) & run_valid
    K_own = ops.segreduce_sorted(torch.where(own, W_ic_all, 0.0), i_run, nv,
                                 op="sum")

    # --- delta-modularity per candidate run (paper Eq. 2) ----------------
    Ki = K[i_run]
    d_of_i = C[i_run]
    dq = (
        2.0 * (W_ic_all - K_own[i_run]) / two_m
        - 2.0 * Ki * (Ki + Sigma[c_run] - Sigma[d_of_i]) / (two_m * two_m)
    )
    geom = run_valid & (i_run < ghost) & (c_run < ghost) & (c_run != d_of_i)
    cand = geom & (W_ic > 0.0) & movable[i_run]
    if owned is not None:
        cand = cand & owned[i_run]
    if target_ok is not None:
        cand = cand & target_ok[c_run]
    dq_all = torch.where(geom & (W_ic_all > 0.0), dq, NEG)
    want = ops.segreduce_sorted(dq_all, i_run, nv, op="max") > 0.0
    dq = torch.where(cand, dq, NEG)

    # --- argmax per source vertex (min community id breaks ties) ---------
    best = ops.segreduce_sorted(dq, i_run, nv, op="max")
    is_best = cand & (dq >= best[i_run])
    c_star = ops.segreduce_sorted(torch.where(is_best, c_run, seg.INT_MAX),
                                  i_run, nv, op="min")
    move = (best > 0.0) & (c_star < ghost)
    C_new = torch.where(move, c_star, C)
    gain = torch.sum(torch.where(move, best, 0.0))
    if group is not None:
        # merge the owners' decisions (each vertex owned by one shard)
        C_new = col.psum(torch.where(owned, C_new, 0), group)
        move = col.psum((owned & move).to(torch.int32), group) > 0
        want = col.pmax((want & owned).to(torch.int32), group) > 0
    C_new[ghost] = ghost

    # --- exact Sigma recompute (synchronous, in-order) --------------------
    Sigma_new = ops.segment_sum_inorder(K, C_new, nv)
    return C_new, Sigma_new, move, gain, want


def _half_sweep_dense(src, dst, w, C, K, Sigma, two_m, movable,
                      target_ok=None, anchored=True, rows=None, gain=True,
                      graphs=1):
    """Dense twin of :func:`_half_sweep` for small ``nv``: the same
    contract and the same bits, with every decision taken on ``[nv, nv]``
    community matrices (row i: vertex i; column c: community c).

    The reference fills its matrices with one complex-packed scatter-add,
    which gives the sortscan's run sums only because XLA on the CPU adds
    duplicate indices in edge order.  On the card a scatter-add is atomic
    and folds in no fixed order, so here each cell is one segment of a
    sorted 2-channel segment sum over the ``nv * nv`` cells: the edges
    stably sorted by cell ``src * nv + C[dst]`` (the order of the
    sortscan's ``(src, C[dst])`` sort), each cell folding its edges in
    index order from +0.0, as the sortscan's run sums do.  A cell no edge
    reaches is an empty segment and holds +0.0, as in the reference, and
    the reference's predicates on the matrices (``W_all > 0`` for
    ``want``, ``W_frz > 0`` for a candidate) are kept as they are: a run
    of zero-weight edges (refine's masked edges) exists but is no
    candidate.  Row max and min, the only other reductions, are exact in
    any order.  The reference's ``owned`` and ``axis`` (its sharded
    harness) have no counterpart here.

    ``graphs = b > 1`` sweeps a tile: the ``b * nv`` slots of a
    :class:`~repro_torch.graph.container.GraphUnion`, community ids in
    their own graph's slots, ``two_m`` float32 ``[b]`` (0-dim for one
    graph), each graph's ghost at its local ``nv - 1``.  Every row reads
    its own graph's 2m, Sigma and columns, so each graph's outputs are the
    bits of its half-sweep alone (the vmapped sweep of the reference's
    engine), and ``gain`` is ``[b]``.

    On the card the half-sweep is the kernel ``csrc/dense_sweep.cu``
    (:func:`repro_torch.kernels.dense_sweep.dense_half_sweep_cuda`), two
    launches in place of the dozens of :func:`_half_sweep_dense_plain`, its
    plain version, with the same bits; ``rows`` (``dense_sweep.edge_rows``
    of ``src``) lets a caller share the edges' row order across sweeps.
    ``gain=False`` returns ``None`` for the gain, which the sweep loop
    never reads (on the card its sum would cost two more launches).
    """
    if not C.is_cuda:
        return _half_sweep_dense_plain(src, dst, w, C, K, Sigma, two_m,
                                       movable, target_ok, anchored, gain,
                                       graphs)
    if rows is None:
        rows = edge_rows(src, C.shape[0])
    C_new, Sigma_new, move, want, best = dense_half_sweep_cuda(
        rows, dst, w, C, K, Sigma, two_m, movable, target_ok, anchored,
        graphs=graphs)
    return C_new, Sigma_new, move, \
        _gain(move, best, graphs) if gain else None, want


def _gain(move, best, graphs):
    """The moved rows' summed best scores: a 0-dim sum for one graph,
    ``[b]`` for a tile (neither is read by a decision)."""
    moved = torch.where(move, best, 0.0)
    return torch.sum(moved) if graphs == 1 else moved.view(graphs, -1).sum(1)


def _half_sweep_dense_plain(src, dst, w, C, K, Sigma, two_m, movable,
                            target_ok=None, anchored=True, gain=True,
                            graphs=1):
    """The plain PyTorch version of :func:`_half_sweep_dense` (on any
    device; the CPU's route), with the ``[nv, nv]`` matrices' bits.

    It takes every decision over the cells that an edge reaches, the
    sorted runs of ``src * nv + C[dst]``, rather than over all ``nv * nv``
    cells: only such a cell can pass ``W_all > 0`` (``want``) or ``W_frz
    > 0`` (a candidate), and a cell no edge reaches holds +0.0.  Each run
    folds its edges in index order from +0.0, as a matrix cell's segment
    does.  ``K_own`` adds +0.0 to the one own-community run of a row,
    which is exact.  The row max and the min-id argmin are exact in any
    order (the values reduced pass ``W > 0``, so ``2m > 0`` and they are
    finite), so a scatter takes them.  ``gain`` sums the same ``[nv]``
    vector.

    For a tile (``graphs = b > 1``) the cells are ``(g * nv + i) * nv +
    c`` with ``c`` the local column, so ``torch.unique``'s order is
    graph-major with each graph's own order inside, and ``Sigma_new`` is
    one in-order segment sum over the union's community ids."""
    n = C.shape[0]
    nv = n // graphs
    ghost = nv - 1                  # each graph's ghost, by local id
    take = torch.index_select   # a 1-D gather, half the host time of x[idx]

    # --- pass A: true and anchored K_{i->c} per cell an edge reaches -----
    not_self = src != dst  # exclude self-loops from scan (paper Alg. 4)
    cd = take(C, 0, dst)
    if graphs > 1:
        cd = torch.remainder(cd, nv)
    cell, run = torch.unique(src.to(torch.int64) * nv + cd,
                             return_inverse=True)
    run, n_cells = run.to(torch.int32), cell.shape[0]
    W_all = ops.segment_sum_inorder(torch.where(not_self, w, 0.0), run,
                                    n_cells)
    if anchored:         # anchored K_{i->c}: frozen neighbours only
        W_frz = ops.segment_sum_inorder(
            torch.where(not_self & ~take(movable, 0, dst), w, 0.0), run,
            n_cells)
    else:
        W_frz = W_all
    i = torch.div(cell, nv, rounding_mode="floor")
    c = cell - i * nv
    if graphs > 1:      # local row, and the column's union community id
        il = torch.remainder(i, nv)
        cg = i - il + c
        two_m = take(two_m, 0, torch.div(i, nv, rounding_mode="floor"))
    else:
        il, cg = i, c
    Ci = take(C, 0, i)

    # --- K_{i->d}: true weight to own community (excluding self) ---------
    own = cg == Ci
    K_own = torch.zeros(n, dtype=W_all.dtype, device=W_all.device
                        ).index_add_(0, i, torch.where(own, W_all, 0.0))

    # --- delta-modularity per candidate cell (paper Eq. 2) ---------------
    # 2.0 * (W - K_own) / two_m - 2.0 * Ki * (Ki + Sigma_c - Sigma_d)
    #   / (two_m * two_m), each doubling as x + x (exact: the same bits)
    Ki = take(K, 0, i)
    d = W_all - take(K_own, 0, i)
    dq = (d + d) / two_m - (Ki + Ki) * (
        Ki + take(Sigma, 0, cg) - take(Sigma, 0, Ci)) / (two_m * two_m)
    geom = (torch.maximum(il, c) < ghost) & ~own
    cand = geom & (W_frz > 0.0) & take(movable, 0, i)
    if target_ok is not None:
        cand = cand & take(target_ok, 0, cg)

    def row_max(v):
        return torch.full((n,), NEG, dtype=v.dtype, device=v.device
                          ).scatter_reduce_(0, i, v, "amax")

    want = row_max(torch.where(geom & (W_all > 0.0), dq, NEG)) > 0.0

    # --- argmax per source vertex (min community id breaks ties) ---------
    # a row moves only to a positive best, which only candidates reach
    # (the rest score NEG): so c_star < ghost, and c_star of a row that
    # does not move is never read
    dq_cand = torch.where(cand, dq, NEG)
    best = row_max(dq_cand)
    c_star = torch.full((n,), seg.INT_MAX, dtype=torch.int64,
                        device=C.device).scatter_reduce_(
        0, i, torch.where(dq_cand >= take(best, 0, i), cg, seg.INT_MAX),
        "amin")
    move = best > 0.0
    C_new = torch.where(move, c_star, C).to(C.dtype)
    if graphs > 1:
        ghosts = union_ghosts(graphs, nv, C.device)
        C_new[ghosts.long()] = ghosts
    else:
        C_new[ghost] = ghost

    # --- exact Sigma recompute: identical to the sort path ----------------
    Sigma_new = ops.segment_sum_inorder(K, C_new, n)
    return C_new, Sigma_new, move, _gain(move, best, graphs) if gain \
        else None, want


def dense_adjacency(src, dst, nv: int) -> torch.Tensor:
    """bool[nv, nv] edge adjacency of the dense scan: a plain assignment
    of ``True`` (no accumulation), exact in any order."""
    adj = torch.zeros((nv, nv), dtype=torch.bool, device=src.device)
    adj[src.long(), dst.long()] = True
    return adj


def wake_neighbours(moved, src, dst, nv: int, adj=None,
                    group=None) -> torch.Tensor:
    """bool[nv]: the vertices with a neighbour in ``moved``.  Keyed by the
    sorted src (on the symmetric directed COO out- and in-neighbours
    coincide, and booleans make it exact), or a column ``any`` of the
    dense scan's adjacency.  On a rank of ``group``, a ``pmax`` merges the
    shards' rows."""
    if adj is not None:
        return torch.any(adj & moved[:, None], dim=0)
    nbr = ops.segreduce_sorted(moved[dst].to(torch.int32), src, nv, op="max")
    return col.pmax(nbr, group) > 0


def _wake_by_dst(moved, src, dst, nv: int, group=None) -> torch.Tensor:
    """The scatter sweep's wake-up, keyed by the unsorted ``dst`` as in
    the reference: an integer scatter max, exact in any order."""
    nbr = torch.zeros(nv, dtype=torch.int32, device=moved.device)
    nbr.scatter_reduce_(0, dst.long(), moved[src].to(torch.int32), "amax")
    return col.pmax(nbr, group) > 0


SEG_IMPLS = ("auto", "scatter")


def _check_seg_impl(seg_impl: str):
    if seg_impl in ("xla", "pallas"):
        raise ValueError(
            f"seg_impl={seg_impl!r} has no counterpart in the port: the "
            "segment reductions run the kernel of the tensor's device; "
            "pass 'auto' (the fused sweep) or 'scatter'")
    if seg_impl not in SEG_IMPLS:
        raise ValueError(f"seg_impl must be one of {SEG_IMPLS}, got "
                         f"{seg_impl!r}")


def _move_loop(src, dst, w, C0, K, Sigma0, two_m, *, tau, max_iters, phases,
               prune, active0, warm, scan, adj, owned=None, group=None,
               gidx=None, m_total=None, seg_impl="auto"):
    """The sweep loop shared by :func:`local_move` and the warm start of
    ``core/dynamic.py``.  Returns ``(C_best, Sigma_best, l_i, sweeps)``.

    ``warm`` keeps a vertex awake only while it is active and wants a
    move (``nbr_moved | (want & active)``), as the reference's warm local
    move does; the cold loop wakes every wanting vertex.  ``owned``,
    ``group``, ``gidx``, ``m_total`` and ``seg_impl``: see
    :func:`local_move`."""
    _check_seg_impl(seg_impl)
    nv = C0.shape[0]
    ghost = nv - 1
    dev = C0.device
    tau = np.float32(tau)
    ids = torch.arange(nv, dtype=torch.int32, device=dev)
    scatter = False
    masks = None
    if scan == "dense":
        sweep = _half_sweep_dense
        if adj is None:
            adj = dense_adjacency(src, dst, nv)
        kw = dict(gain=False)       # the loop never reads it
        if dev.type == "cuda":
            kw["rows"] = edge_rows(src, nv)
        masks = _parity_masks(nv, max_iters, dev)
    elif scan == "sort":
        scatter = seg_impl == "scatter"
        sweep = _half_sweep_scatter if scatter else _half_sweep
        adj, kw = None, dict(owned=owned, group=group)
    else:
        raise ValueError(f"scan must be 'sort' or 'dense', got {scan!r}")

    if scan == "dense" and dev.type == "cuda":
        def realized(C, Sigma):   # the same bits, in one launch
            return dense_modularity_cuda(src, dst, w, C, Sigma, two_m)
    else:
        def realized(C, Sigma):
            return realized_modularity(src, dst, w, C, Sigma, two_m,
                                       group=group, gidx=gidx,
                                       m_total=m_total)

    C = C0.to(torch.int32).clone()
    C[ghost] = ghost
    Sigma = Sigma0
    active = active0
    q_prev = realized(C, Sigma)
    C_best, Sigma_best, q_best = C, Sigma, q_prev
    dQ_iter = dQ_prev = np.float32(np.inf)
    it = n_prod = 0
    # converge only after two consecutive no-gain sweeps: a single sweep
    # can stall purely because of an unlucky parity roll
    while (it < 2 or dQ_iter > tau or dQ_prev > tau) and it < max_iters:
        if masks is None:
            pbit = _hash_parity(ids, it)
            par = (pbit == 0, pbit == 1)
        else:
            par = (masks[0][it], masks[1][it])
        moved_any = None
        for ph, tp in phases:
            movable = active if ph is None else active & par[ph]
            target_ok = None if tp is None else par[tp]
            C, Sigma, moved, _, want = sweep(
                src, dst, w, C, K, Sigma, two_m, movable,
                target_ok=target_ok, anchored=ph is not None, **kw)
            moved_any = moved if moved_any is None else moved_any | moved
        q_now = realized(C, Sigma)
        if prune:
            # neighbours of moved vertices wake up; everyone else sleeps
            nbr_moved = (_wake_by_dst(moved_any, src, dst, nv, group)
                         if scatter else
                         wake_neighbours(moved_any, src, dst, nv, adj, group))
            # schedule-blocked desire stays awake
            active = nbr_moved | ((want & active) if warm else want)
        else:
            active = torch.ones(nv, dtype=torch.bool, device=dev)
        better = q_now > q_best
        C_best = torch.where(better, C, C_best)
        Sigma_best = torch.where(better, Sigma, Sigma_best)
        q_best = torch.maximum(q_now, q_best)
        gain = np.float32((q_now - q_prev).item())   # the sweep's one sync
        q_prev = q_now
        dQ_prev, dQ_iter = dQ_iter, gain
        it += 1
        n_prod += int(gain > tau)
    # li keeps the paper's semantics: li == 1 <=> no productive iteration
    li = min(n_prod + 1, it)
    return C_best, Sigma_best, max(li, 1), it


SYNC_PHASES = {
    "handshake": ((0, 1), (1, 0)),      # (mover parity, target parity)
    "parity": ((0, None), (1, None)),
    "all": ((None, None),),             # plain synchronous Jacobi (ablation)
}


def local_move(src, dst, w, C0, K, Sigma0, two_m, *, tau, max_iters: int = 20,
               sync: str = "handshake", prune: bool = True,
               scan: str = "sort", adj=None, owned=None, group=None,
               gidx=None, m_total=None, seg_impl: str = "auto"):
    """Run the local-moving phase to convergence.

    ``tau`` is a float32 threshold (a numpy float32 or Python float holding
    a float32 value).  Returns ``(C, Sigma, l_i)``: the best-realized-Q
    membership, its community weights, and the paper's iteration count
    ``l_i`` as a Python int (``l_i <= 1`` is the global convergence signal).

    ``scan='dense'`` sweeps with :func:`_half_sweep_dense` (the same bits)
    and wakes neighbours through the bool[nv, nv] adjacency ``adj``, built
    here from the edges when not given (the pass loop shares one with the
    split).

    ``seg_impl`` picks the sortscan's sweep: ``'auto'`` the fused
    :func:`_half_sweep`, ``'scatter'`` the reference's unfused
    :func:`_half_sweep_scatter` (the paired baseline; the same bits).
    The reference's ``'xla'`` and ``'pallas'`` raise ``ValueError``: here
    every reduction runs the kernel of its tensor's device.  The dense
    scan ignores it, as in the reference.

    On a rank of the process group ``group`` (the sharded driver,
    ``core/distributed.py``): ``src``/``dst``/``w`` are this shard's
    edges, ``owned`` (bool[nv]) the vertices it owns, ``gidx`` (int32) the
    global live-edge slot of each of its edges and ``m_total`` the live
    edge count; ``K`` and ``Sigma0`` are replicated.  Every rank returns
    the single-device result bit for bit.  With ``group=None`` these
    arguments are unused and nothing changes.  The dense scan is
    single-device only.
    """
    if sync not in SYNC_PHASES:
        raise ValueError(f"unknown sync mode {sync!r}")
    if scan == "dense" and group is not None:
        raise ValueError("scan='dense' is single-device only (group=None)")
    nv = C0.shape[0]
    active0 = torch.ones(nv, dtype=torch.bool, device=C0.device)
    C, Sigma, li, _ = _move_loop(
        src, dst, w, C0, K, Sigma0, two_m, tau=tau, max_iters=max_iters,
        phases=SYNC_PHASES[sync], prune=prune, active0=active0, warm=False,
        scan=scan, adj=adj, owned=owned, group=group, gidx=gidx,
        m_total=m_total, seg_impl=seg_impl)
    return C, Sigma, li


# --- the tile: b graphs of one bucket in lockstep ----------------------------

def tile_adjacency(src, dst, graphs: int, nv: int) -> torch.Tensor:
    """bool ``[b, nv, nv]``: each graph's :func:`dense_adjacency`, from a
    union's edges (``src``, ``dst`` in ``g * nv + i`` slots)."""
    adj = torch.zeros((graphs, nv, nv), dtype=torch.bool, device=src.device)
    adj.view(graphs * nv, nv)[src.long(), torch.remainder(dst, nv).long()] \
        = True
    return adj


def wake_neighbours_tile(moved, adj) -> torch.Tensor:
    """bool ``[b * nv]``: :func:`wake_neighbours` of each graph of a tile,
    a column ``any`` of its own ``[nv, nv]`` adjacency (exact)."""
    b, nv, _ = adj.shape
    return torch.any(adj & moved.view(b, nv)[:, :, None], dim=1).view(b * nv)


@functools.lru_cache(maxsize=16)
def _tile_parity_masks(nv: int, n: int, graphs: int, device: torch.device):
    """:func:`_parity_masks` of the local ids, repeated for each graph of
    a tile: bool ``[n, b * nv]`` each (a tile's parity is each graph's
    own)."""
    return tuple(m.repeat(1, graphs) for m in _parity_masks(nv, n, device))


def realized_modularity_tile(src, dst, w, C, Sigma, two_m, counts):
    """:func:`realized_modularity` of each graph of a tile, float32
    ``[b]``: the two flat sums by ``ops.sum_inorder_per_graph``, each
    graph's the bits of its own (``counts``: its live edges, host ints)."""
    b = len(counts)
    nv = C.shape[0] // b
    w_in = torch.where(torch.index_select(C, 0, src)
                       == torch.index_select(C, 0, dst), w, 0.0)
    internal = ops.sum_inorder_per_graph(w_in, counts)
    sig2 = ops.sum_inorder_per_graph(Sigma * Sigma, (nv,) * b)
    return internal / two_m - sig2 / (two_m * two_m)


def local_move_tile(src, dst, w, C0, K, Sigma0, two_m, *, counts, tau,
                    max_iters: int = 20, sync: str = "handshake",
                    prune: bool = True, scan: str = "dense", adj=None,
                    active0=None, warm: bool = False):
    """:func:`local_move` of the ``b = len(counts)`` graphs of a tile at
    once: one set of launches and one host read a sweep.  Returns ``(C,
    Sigma, l_i, sweeps)``, ``l_i`` and ``sweeps`` int64 numpy ``[b]``.

    The edges are a :class:`~repro_torch.graph.container.GraphUnion`'s
    (``counts`` its per-graph live edges), ``C0``/``K``/``Sigma0`` are
    ``[b * nv]`` in its slots, ``two_m`` float32 ``[b]``.  Every graph
    starts at sweep 0, so all share the sweep index and its parity roll
    (by local id).  Each keeps its own ``dQ_iter``, ``dQ_prev``, productive
    count, best ``C``/``Sigma``/``Q``, awake set and convergence: once its
    loop test fails it neither moves (its rows are not movable) nor
    changes state, and its result is the state at its own convergence, as
    a vmapped ``while_loop`` selects it.  So each graph's outputs are the
    bits of :func:`local_move` on it alone.  The sweep's gains come to the
    host in one ``[b]`` copy.

    ``scan='dense'`` sweeps with :func:`_half_sweep_dense` and wakes
    neighbours through ``adj``, the :func:`tile_adjacency` (built here
    when not given); on the card realized Q is the dense modularity
    kernel.  ``scan='sort'`` sweeps with the sortscan's :func:`_half_sweep`
    on the union and wakes neighbours by the union's sorted ``src``
    (:func:`wake_neighbours` over ``b * nv`` slots): no ``[b, nv, nv]``
    matrix is built, and realized Q is :func:`realized_modularity_tile` on
    either device.

    ``active0`` (bool ``[b * nv]``, default all awake) and ``warm`` give
    each graph the warm start of ``core/dynamic.py:warm_local_move``: the
    awake set starts at ``active0``, and with ``warm`` a vertex stays
    awake only while a neighbour moved or it is still awake and wants a
    move, as :func:`_move_loop` keeps it; the outputs are then the bits
    of ``warm_local_move`` on each graph alone."""
    if sync not in SYNC_PHASES:
        raise ValueError(f"unknown sync mode {sync!r}")
    b = len(counts)
    n = C0.shape[0]
    nv = n // b
    dev = C0.device
    tau = np.float32(tau)
    masks = _tile_parity_masks(nv, max_iters, b, dev)
    kw = dict(gain=False, graphs=b)
    if scan == "dense":
        sweep = _half_sweep_dense
        if adj is None:
            adj = tile_adjacency(src, dst, b, nv)

        def wake(moved):
            return wake_neighbours_tile(moved, adj)
    elif scan == "sort":
        sweep = _half_sweep

        def wake(moved):
            return wake_neighbours(moved, src, dst, n)
    else:
        raise ValueError(f"scan must be 'sort' or 'dense', got {scan!r}")
    if scan == "dense" and dev.type == "cuda":
        kw["rows"] = edge_rows(src, n)
        eptr = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int32)).to(dev)

        def realized(C, Sigma):   # the same bits, in one launch
            return dense_modularity_cuda(src, dst, w, C, Sigma, two_m,
                                         edge_counts=counts, edge_ptr=eptr)
    else:
        def realized(C, Sigma):
            return realized_modularity_tile(src, dst, w, C, Sigma, two_m,
                                            counts)

    C = C0.to(torch.int32).clone()
    ghosts = union_ghosts(b, nv, dev)
    C[ghosts.long()] = ghosts
    Sigma = Sigma0
    active = (torch.ones(n, dtype=torch.bool, device=dev) if active0 is None
              else active0)
    q_prev = realized(C, Sigma)
    C_best, Sigma_best, q_best = C, Sigma, q_prev
    dQ_iter = np.full(b, np.inf, np.float32)
    dQ_prev = dQ_iter.copy()
    n_prod = np.zeros(b, np.int64)
    sweeps = np.zeros(b, np.int64)
    running = np.full(b, max_iters > 0)
    run_g = run_v = None            # None: every graph still sweeps
    it = 0
    while running.any():
        par = (masks[0][it], masks[1][it])
        moved_any = None
        for ph, tp in SYNC_PHASES[sync]:
            movable = active if ph is None else active & par[ph]
            if run_v is not None:
                movable = movable & run_v
            target_ok = None if tp is None else par[tp]
            C, Sigma, moved, _, want = sweep(
                src, dst, w, C, K, Sigma, two_m, movable,
                target_ok=target_ok, anchored=ph is not None, **kw)
            moved_any = moved if moved_any is None else moved_any | moved
        q_now = realized(C, Sigma)
        if prune:
            # schedule-blocked desire stays awake, as in _move_loop
            active = wake(moved_any) | (
                (want & active) if warm else want)
        else:
            active = torch.ones(n, dtype=torch.bool, device=dev)
        better = q_now > q_best
        if run_g is not None:
            better = better & run_g
        keep = better[:, None]
        C_best = torch.where(keep, C.view(b, nv), C_best.view(b, nv)
                             ).view(n)
        Sigma_best = torch.where(keep, Sigma.view(b, nv),
                                 Sigma_best.view(b, nv)).view(n)
        q_max = torch.maximum(q_now, q_best)
        q_best = q_max if run_g is None else torch.where(run_g, q_max,
                                                          q_best)
        gain = (q_now - q_prev).cpu().numpy()    # the sweep's one sync
        q_prev = q_now
        r = running
        dQ_prev[r], dQ_iter[r] = dQ_iter[r], gain[r]
        sweeps[r] += 1
        n_prod[r] += gain[r] > tau
        it += 1
        running = r & ((it < 2) | (dQ_iter > tau) | (dQ_prev > tau)) & (
            it < max_iters)
        if not np.array_equal(running, r):
            run_g = torch.from_numpy(running).to(dev)
            run_v = run_g.repeat_interleave(nv)
    # li keeps the paper's semantics: li == 1 <=> no productive iteration
    li = np.maximum(np.minimum(n_prod + 1, sweeps), 1)
    return C_best, Sigma_best, li, sweeps
