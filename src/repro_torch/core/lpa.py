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
import functools

import torch

from repro_torch.core import _segments as seg
from repro_torch.core.local_move import _U32, _mul_u32, _parity, _salt
from repro_torch.device import resolve_device
from repro_torch.graph.container import strip_padding
from repro_torch.kernels import ops


def _hash_key(c: torch.Tensor, salt) -> torch.Tensor:
    """:func:`hash_key` with the round's salt given: an int, or an int64
    column ``[n, 1]`` that hashes ``n`` rounds at once."""
    h = (_mul_u32(c.to(torch.int64) & _U32, 0x9E3779B1) + salt) & _U32
    h = _mul_u32(h ^ (h >> 15), 0x45D9F3B)
    return (h - 2**31).to(torch.int32)


def hash_key(c: torch.Tensor, it: int) -> torch.Tensor:
    """The reference's tie-break hash of community ids ``c`` at round
    ``it`` as an order-keeping int32 key: the uint32 ``h`` (``lpa.py``'s
    ``(c * 0x9E3779B1 + it * 0xB5297A4D)``, then ``(h ^ (h >> 15)) *
    0x45D9F3B``, all mod 2**32) minus ``2**31``, which is ``h ^ 0x80000000``
    read as signed.  The uint32 sentinel ``0xFFFFFFFF`` maps to INT32_MAX.
    """
    return _hash_key(c, _salt(it, 0xB5297A4D))


TABLE_CELLS = 1 << 18   # cells in one block of per-round hash rows


def _round_tables(nv: int, start: int, n: int, device: torch.device):
    """For the vertex ids ``[0, nv)`` and rounds ``start .. start + n -
    1``: which ids move (their ``_hash_parity`` bit is the round's parity)
    and their tie-break keys (:func:`hash_key`), bool and int32 ``[n, nv]``,
    in the same integer operations."""
    ids = torch.arange(nv, dtype=torch.int32, device=device)

    def column(values, dtype=torch.int64):
        return torch.tensor(values, dtype=dtype, device=device)[:, None]

    its = range(start, start + n)
    pbits = _parity(ids, column([_salt(it, 0x85EBCA77) for it in its]))
    return (pbits == column([it % 2 for it in its], torch.int32),
            _hash_key(ids, column([_salt(it, 0xB5297A4D) for it in its])))


# a run whose rounds fit one block reads them from here: a service runs
# graphs of the same few widths over and over, and callers only read them
_round_tables_cached = functools.lru_cache(maxsize=32)(_round_tables)


def lpa_run(g, *, max_iters: int = 50):
    """Weighted LPA on a :class:`repro_torch.graph.Graph`, where it lies.

    Returns ``(dense labels int32[nv], rounds as a Python int)``.  Works on
    the live edges; the reference masks its padding (``s_src < ghost``), so
    the labels do not change.

    A round costs the host one call a tensor operation, which on the card
    is most of its time, so a round makes as few as the reference's
    results allow.  The hashes of the vertex ids depend on the round
    alone: they come from tables of up to :data:`TABLE_CELLS` entries, a
    block of rounds at a time, kept between runs where one block holds
    them all.  The edges' ``src`` is sorted and live (the graph's
    invariant, after :func:`strip_padding`), so the stable sort by
    ``(src, C[dst])`` leaves ``src`` where it was and the sorted sources
    are ``src`` itself; the runs start where the packed key changes.
    """
    nv = g.nv
    ghost = nv - 1
    src, dst, w = strip_padding(g.src, g.dst, g.w, g.ghost)
    m = src.shape[0]
    take = torch.index_select
    src_hi = src.to(torch.int64) << 32
    ids = torch.arange(nv, dtype=torch.int32, device=g.device)
    block = max(1, min(max_iters, TABLE_CELLS // nv))
    tables = _round_tables_cached if block == max_iters else _round_tables
    C = ids
    changed = changed_prev = True
    it = 0
    # stop only after both parity rounds go quiet
    while (changed or changed_prev or it < 2) and it < max_iters:
        if it % block == 0:
            movers, hkeys = tables(nv, it, min(block, max_iters - it),
                                   ids.device)
        movable, hkey_of = movers[it % block], hkeys[it % block]
        # per-vertex best label among neighbours by total incident weight
        cd = take(C, 0, dst)
        s_key, perm = torch.sort(src_hi | cd, stable=True)
        s_cd = take(cd, 0, perm)
        starts = torch.ones(m, dtype=torch.bool, device=g.device)
        starts[1:] = s_key[1:] != s_key[:-1]
        rid = torch.cumsum(starts, 0, dtype=torch.int32) - 1
        W = take(ops.segreduce_sorted(take(w, 0, perm), rid, m), 0, rid)
        cand = starts & (s_cd < ghost)
        score = torch.where(cand, W, float("-inf"))
        best = ops.segreduce_sorted(score, src, nv, op="max")
        is_best = cand & (score >= take(best, 0, src))
        # random-equivalent tie-break (see the reference): min hash key
        hkey = torch.where(is_best, take(hkey_of, 0, s_cd), seg.INT_MAX)
        hmin = ops.segreduce_sorted(hkey, src, nv, op="min")
        pick = is_best & (hkey == take(hmin, 0, src))
        c_star = ops.segreduce_sorted(torch.where(pick, s_cd, seg.INT_MAX),
                                      src, nv, op="min")
        # handshake: parity-p vertices adopt labels of parity-(1-p) groups
        target_ok = ~take(movable, 0, torch.clamp(c_star, 0, ghost))
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
