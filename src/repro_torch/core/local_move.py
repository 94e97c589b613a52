"""Local-moving phase of GSP-Louvain (paper Algorithm 4), sortscan path
(port of ``repro/core/local_move.py``).

The whole edge set is sorted by ``(src, C[dst])`` once per half-sweep;
equal keys form runs and one in-order run sum yields every ``K_{i->c}``
(one "hashtable" for the entire graph).  Delta-modularity (paper Eq. 2) is
scored per run representative, and a sorted segment max/min per source
vertex picks the best destination community.  The synchronization policy,
anchored joins, pruning and best-Q tracking are the reference's: see its
module docstring.  Here the ``lax.while_loop`` is a Python loop driven from
the host, which reads one scalar per sweep to test convergence.

Every reduction that feeds a move or a convergence decision folds in index
order: the sorted ones through the segment-reduce kernel, the Sigma
recompute keyed by the unsorted ``C_new`` through a stable sort and the
same kernel (``ops.segment_sum_inorder``).  The two flat sums of
:func:`realized_modularity` follow torch's reduction order; with integer
weights they are exact below 2**24.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import _segments as seg
from repro_torch.kernels import ops

NEG = float("-inf")
_U32 = 0xFFFFFFFF


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32): split ``c`` in
    16-bit halves so no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash_parity(ids: torch.Tensor, it: int) -> torch.Tensor:
    """Iteration-salted pseudo-random parity bit per id (int32).

    The reference's uint32 wraparound arithmetic, emulated in int64 with a
    mask after every multiply, add and shift.  Salting with the iteration
    re-rolls the mover/target bipartition every sweep (see the reference).
    """
    salt = ((int(it) & _U32) * 0x85EBCA77) & _U32
    h = (_mul_u32(ids.to(torch.int64) & _U32, 0x9E3779B1) + salt) & _U32
    h = _mul_u32(h ^ (h >> 16), 0x45D9F3B)
    return ((h >> 13) & 1).to(torch.int32)


def realized_modularity(src, dst, w, C, Sigma, two_m) -> torch.Tensor:
    """Q of the current partition: two flat reductions (internal edge
    weight, sum of Sigma^2)."""
    w_in = torch.where(C[src] == C[dst], w, 0.0)
    internal = torch.sum(w_in)
    sig2 = torch.sum(Sigma * Sigma)
    return internal / two_m - sig2 / (two_m * two_m)


def _half_sweep(src, dst, w, C, K, Sigma, two_m, movable, target_ok=None,
                anchored=True):
    """One synchronous half-sweep (fused sortscan).  Returns
    ``(C_new, Sigma_new, moved, gain, want)``.

    ``target_ok``: bool[nv] — moves only into communities flagged True (the
    handshake schedule).  ``anchored``: join-attraction counts only frozen
    neighbours; off for the 'all' ablation, where nothing is frozen.
    """
    nv = C.shape[0]
    m_cap = src.shape[0]
    ghost = nv - 1

    # --- scanCommunities: sort by (src, C[dst]); gather payloads ---------
    cd = C[dst]
    s_src, s_cd, perm = seg.sort_runs(src, cd)
    s_dst = dst[perm]
    s_w = w[perm]
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
    # every other element parked on the ghost slot and cleared after
    own_start = starts & (s_cd == C[s_src])
    K_own = torch.zeros(nv, dtype=torch.float32, device=C.device)
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
    valid = starts & (s_src < ghost) & (s_cd < ghost) & (s_cd != d_of_i)
    cand = valid & (W_frz_e > 0.0) & movable[s_src]
    if target_ok is not None:
        cand = cand & target_ok[s_cd]
    # 'want': a positive move ignoring the schedule gates keeps a vertex
    # awake under pruning; zero-weight runs never count (see reference)
    base = valid & (W_all_e > 0.0)
    # pass B: want and best in one 2-channel sorted segment max
    dq_c = torch.where(cand, dq, NEG)
    mx = ops.segreduce_sorted(
        torch.stack([torch.where(base, dq, NEG), dq_c], dim=1), s_src, nv,
        op="max")
    want = mx[:, 0] > 0.0
    best = mx[:, 1]

    # --- argmax per source vertex (min community id breaks ties) ---------
    is_best = cand & (dq_c >= best[s_src])
    c_star = ops.segreduce_sorted(torch.where(is_best, s_cd, seg.INT_MAX),
                                  s_src, nv, op="min")
    move = (best > 0.0) & (c_star < ghost)
    C_new = torch.where(move, c_star, C)
    C_new[ghost] = ghost

    # --- exact Sigma recompute (synchronous, in-order) --------------------
    Sigma_new = ops.segment_sum_inorder(K, C_new, nv)
    gain = torch.sum(torch.where(move, best, 0.0))
    return C_new, Sigma_new, move, gain, want


def local_move(src, dst, w, C0, K, Sigma0, two_m, *, tau, max_iters: int = 20,
               sync: str = "handshake", prune: bool = True):
    """Run the local-moving phase to convergence.

    ``tau`` is a float32 threshold (a numpy float32 or Python float holding
    a float32 value).  Returns ``(C, Sigma, l_i)``: the best-realized-Q
    membership, its community weights, and the paper's iteration count
    ``l_i`` as a Python int (``l_i <= 1`` is the global convergence signal).
    """
    nv = C0.shape[0]
    ghost = nv - 1
    dev = C0.device
    tau = np.float32(tau)
    ids = torch.arange(nv, dtype=torch.int32, device=dev)
    if sync == "handshake":
        phases = ((0, 1), (1, 0))       # (mover parity, target parity)
    elif sync == "parity":
        phases = ((0, None), (1, None))
    elif sync == "all":                 # plain synchronous Jacobi (ablation)
        phases = ((None, None),)
    else:
        raise ValueError(f"unknown sync mode {sync!r}")

    C = C0.to(torch.int32).clone()
    C[ghost] = ghost
    Sigma = Sigma0
    active = torch.ones(nv, dtype=torch.bool, device=dev)
    q_prev = realized_modularity(src, dst, w, C, Sigma, two_m)
    C_best, Sigma_best, q_best = C, Sigma, q_prev
    dQ_iter = dQ_prev = np.float32(np.inf)
    it = n_prod = 0
    # converge only after two consecutive no-gain sweeps: a single sweep
    # can stall purely because of an unlucky parity roll
    while (it < 2 or dQ_iter > tau or dQ_prev > tau) and it < max_iters:
        moved_any = torch.zeros(nv, dtype=torch.bool, device=dev)
        pbit = _hash_parity(ids, it)
        for ph, tp in phases:
            movable = active if ph is None else active & (pbit == ph)
            target_ok = None if tp is None else (pbit == tp)
            C, Sigma, moved, _, want = _half_sweep(
                src, dst, w, C, K, Sigma, two_m, movable,
                target_ok=target_ok, anchored=ph is not None)
            moved_any = moved_any | moved
        q_now = realized_modularity(src, dst, w, C, Sigma, two_m)
        if prune:
            # neighbours of moved vertices wake up; everyone else sleeps.
            # Keyed by the sorted src: on the symmetric directed COO out-
            # and in-neighbours coincide, and booleans make it exact.
            nbr_moved = ops.segreduce_sorted(
                moved_any[dst].to(torch.int32), src, nv, op="max") > 0
            active = nbr_moved | want   # schedule-blocked desire stays awake
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
    return C_best, Sigma_best, max(li, 1)
