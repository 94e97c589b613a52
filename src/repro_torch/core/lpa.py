"""Label Propagation community detection (Raghavan et al. 2007), the
portfolio's 'fast' tier (port of ``repro/core/lpa.py``).

Synchronous max-weight label propagation with the same hash-rolled parity
handshake as the local move.  Each round is the reference's sortscan: one
sort of the edges by ``(src, C[dst])``, an in-order run sum of the weights
(``K_{i->c}``), a float32 segment max of the run sums per vertex, and the
tie-break by an iteration-salted hash as a segment min; every reduction
goes through ``ops.segreduce_sorted``.  The ``lax.while_loop`` is a Python
loop driven from the host, which reads one flag per round.

The reference's hash is uint32 arithmetic, and the segment reduce takes
only float32 and int32: the hash is computed in int64, masked to 32 bits
after every multiply, add and shift, and shifted down by ``2**31`` into
int32 (:func:`hash_key`), which keeps its order.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import _segments as seg
from repro_torch.core.local_move import _U32, _hash_parity, _mul_u32
from repro_torch.device import resolve_device
from repro_torch.graph.container import strip_padding
from repro_torch.kernels import ops


def hash_key(c: torch.Tensor, it: int) -> torch.Tensor:
    """The reference's tie-break hash of community ids ``c`` at round
    ``it`` as an order-keeping int32 key: the uint32 ``h`` (``lpa.py``'s
    ``(c * 0x9E3779B1 + it * 0xB5297A4D)``, then ``(h ^ (h >> 15)) *
    0x45D9F3B``, all mod 2**32) minus ``2**31``, which is ``h ^ 0x80000000``
    read as signed.  The uint32 sentinel ``0xFFFFFFFF`` maps to INT32_MAX.
    """
    salt = ((int(it) & _U32) * 0xB5297A4D) & _U32
    h = (_mul_u32(c.to(torch.int64) & _U32, 0x9E3779B1) + salt) & _U32
    h = _mul_u32(h ^ (h >> 15), 0x45D9F3B)
    return (h - 2**31).to(torch.int32)


def lpa_run(g, *, max_iters: int = 50):
    """Weighted LPA on a :class:`repro_torch.graph.Graph`, where it lies.

    Returns ``(dense labels int32[nv], rounds as a Python int)``.  Works on
    the live edges; the reference masks its padding (``s_src < ghost``), so
    the labels do not change.
    """
    nv = g.nv
    ghost = nv - 1
    src, dst, w = strip_padding(g.src, g.dst, g.w, g.ghost)
    m = src.shape[0]
    ids = torch.arange(nv, dtype=torch.int32, device=g.device)
    C = ids
    changed = changed_prev = True
    it = 0
    # stop only after both parity rounds go quiet
    while (changed or changed_prev or it < 2) and it < max_iters:
        pbit = _hash_parity(ids, it)
        # per-vertex best label among neighbours by total incident weight
        s_src, s_cd, perm = seg.sort_runs(src, C[dst])
        starts = seg.run_starts(s_src, s_cd)
        rid = seg.run_ids(starts)
        W = seg.runs_reduce(w[perm], rid, m)[rid]
        cand = starts & (s_src < ghost) & (s_cd < ghost)
        score = torch.where(cand, W, float("-inf"))
        best = ops.segreduce_sorted(score, s_src, nv, op="max")
        is_best = cand & (score >= best[s_src])
        # random-equivalent tie-break (see the reference): min hash key,
        # hashed once a community id and gathered, not once an edge
        hkey = torch.where(is_best, hash_key(ids, it)[s_cd], seg.INT_MAX)
        hmin = ops.segreduce_sorted(hkey, s_src, nv, op="min")
        pick = is_best & (hkey == hmin[s_src])
        c_star = ops.segreduce_sorted(torch.where(pick, s_cd, seg.INT_MAX),
                                      s_src, nv, op="min")
        # handshake: parity-p vertices adopt labels of parity-(1-p) groups
        p = it % 2
        movable = pbit == p
        target_ok = pbit[torch.clamp(c_star, 0, ghost)] != p
        ok = (best > 0) & (c_star < ghost) & movable & target_ok
        C_new = torch.where(ok, c_star, C)
        changed_prev, changed = changed, bool(torch.any(C_new != C))
        C = C_new
        it += 1
    labels, _ = seg.renumber(C, g.node_mask(), nv)
    return labels, it


def lpa(g, *, options=None, device=None):
    """LPA through the portfolio dispatch (the 'fast' tier): ``(C, stats)``
    with the tiers' stats shape.  ``options`` is a ``DetectOptions``; its
    algorithm is forced to 'fast'.  Runs on ``device`` (``None`` = CUDA;
    raises when CUDA is absent), moving the graph there first if needed.
    """
    from repro_torch.core.api import DetectOptions
    from repro_torch.core.portfolio import partition

    opts = dataclasses.replace(options or DetectOptions(), algorithm="fast")
    return partition(g.to(resolve_device(device)), opts)
