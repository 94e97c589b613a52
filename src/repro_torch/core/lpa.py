"""Label Propagation community detection (Raghavan et al. 2007), the
portfolio's 'fast' tier (port of ``repro/core/lpa.py``).

Synchronous max-weight label propagation with the same hash-rolled parity
handshake as the local move.  Each round is the reference's sortscan: one
sort of the edges by ``(src, C[dst])``, an in-order run sum of the weights
(``K_{i->c}``), a float32 segment max of the run sums per vertex, and the
tie-break by an iteration-salted hash as a segment min; every reduction
goes through ``ops.segreduce_sorted``.  The ``lax.while_loop`` is a Python
loop driven from the host, which reads one flag vector per round.
:func:`lpa_run_tile` runs the rounds of several graphs of one bucket in
lockstep (the batched engine's tile); :func:`lpa_run` is a tile of one.

The reference's hash is uint32 arithmetic, and the segment reduce takes
only float32 and int32: the hash is computed in int64, masked to 32 bits
after every multiply, add and shift, and shifted down by ``2**31`` into
int32 (:func:`hash_key`), which keeps its order.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import _segments as seg
from repro_torch.core.local_move import _U32, _mul_u32, _parity, _salt
from repro_torch.device import resolve_device
from repro_torch.graph.container import stack_graphs, union_of
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


def lpa_run(g, *, max_iters: int = 50):
    """Weighted LPA on a :class:`repro_torch.graph.Graph`, where it lies.

    Returns ``(dense labels int32[nv], rounds as a Python int)``: the
    rounds of :func:`lpa_run_tile` on a tile of this one graph.  Works on
    the live edges; the reference masks its padding (``s_src < ghost``),
    so the labels do not change.
    """
    C, rounds, _, _ = lpa_run_tile(stack_graphs([g]), max_iters=max_iters)
    return C[0], int(rounds[0])


def _tile_round_tables(nv: int, start: int, n: int, graphs: int,
                       device: torch.device):
    """:func:`_round_tables` for a tile: the movers repeated for each of
    its graphs (bool ``[n, b * nv]``; a tile's parity is each graph's own,
    by local id), the keys by local id (int32 ``[n, nv]``)."""
    movers, hkeys = _round_tables(nv, start, n, device)
    return movers.repeat(1, graphs), hkeys


# a run whose rounds fit one block reads them from here: a service runs
# graphs of the same few widths over and over, and callers only read them
_tile_round_tables_cached = functools.lru_cache(maxsize=32)(
    _tile_round_tables)


def lpa_run_tile(stacked, *, union=None, max_iters: int = 50):
    """:func:`lpa_run` of the ``b`` graphs of a ``stack_graphs`` result at
    once, the batched engine's tile for the fast tier: their rounds in
    lockstep on the :class:`~repro_torch.graph.container.GraphUnion` of
    their live edges (``union`` passes one already made).  Returns ``(C
    int32 [b, nv], rounds int64 numpy [b], n_communities int32 [b],
    union)``: each graph's dense labels (local ids) and round count, the
    bits of :func:`lpa_run` on it alone.

    A round is the reference's on the union's ``b * nv`` slots: one
    stable sort of the packed ``(src, C[dst])`` key, the in-order run sum,
    the max and the two mins by segment.  The union's ``src`` is sorted,
    live and graph-major, so the stable sort leaves it where it was (the
    sorted sources are ``src`` itself), the runs start where the packed
    key changes, and a run never crosses graphs.  The ghost test and the
    tie-break hash read each community's local id, and the movers are
    each graph's own table row.  Every graph starts at round 0, so all
    share the round index; each keeps its own ``changed``,
    ``changed_prev`` and loop test, and one whose loop has ended neither
    moves nor counts rounds.  The host reads one ``[b]`` flag vector a
    round.

    A round costs the host one call a tensor operation, which on the card
    is most of its time, so a round makes as few as the reference's
    results allow.  The hashes of the vertex ids depend on the round
    alone: they come from tables of up to :data:`TABLE_CELLS` entries, a
    block of rounds at a time, kept between runs where one block holds
    them all."""
    b, nv, dev = stacked.src.shape[0], stacked.nv, stacked.device
    u = union_of(stacked) if union is None else union
    n = b * nv
    ghost = nv - 1
    src, dst, w = u.src, u.dst, u.w
    m = src.shape[0]
    take = torch.index_select
    src_hi = src.to(torch.int64) << 32
    slot = torch.arange(n, dtype=torch.int32, device=dev)
    local = torch.remainder(slot, nv)
    block = max(1, min(max_iters, TABLE_CELLS // nv))
    tables = (_tile_round_tables_cached if block == max_iters
              else _tile_round_tables)
    C = slot
    changed = np.ones(b, bool)
    changed_prev = changed.copy()
    rounds = np.zeros(b, np.int64)
    running = np.full(b, max_iters > 0)
    run_v = None                    # None: every graph still runs
    it = 0
    while running.any():
        if it % block == 0:
            movers, hkeys = tables(nv, it, min(block, max_iters - it), b,
                                   dev)
        movable, hkey_of = movers[it % block], hkeys[it % block]
        if run_v is not None:
            movable = movable & run_v
        # per-vertex best label among neighbours by total incident weight
        cd = take(C, 0, dst)
        s_key, perm = torch.sort(src_hi | cd, stable=True)
        s_cd = take(cd, 0, perm)
        s_loc = torch.remainder(s_cd, nv)
        starts = torch.ones(m, dtype=torch.bool, device=dev)
        starts[1:] = s_key[1:] != s_key[:-1]
        rid = torch.cumsum(starts, 0, dtype=torch.int32) - 1
        W = take(ops.segreduce_sorted(take(w, 0, perm), rid, m), 0, rid)
        cand = starts & (s_loc < ghost)
        score = torch.where(cand, W, float("-inf"))
        best = ops.segreduce_sorted(score, src, n, op="max")
        is_best = cand & (score >= take(best, 0, src))
        # random-equivalent tie-break (see the reference): min hash key
        hkey = torch.where(is_best, take(hkey_of, 0, s_loc), seg.INT_MAX)
        hmin = ops.segreduce_sorted(hkey, src, n, op="min")
        pick = is_best & (hkey == take(hmin, 0, src))
        c_star = ops.segreduce_sorted(torch.where(pick, s_cd, seg.INT_MAX),
                                      src, n, op="min")
        # handshake: parity-p vertices adopt labels of parity-(1-p) groups;
        # a pick is a candidate, so a picked c_star is below its ghost
        target_ok = ~take(movable, 0, torch.clamp(c_star, 0, n - 1))
        ok = (best > 0) & (c_star < seg.INT_MAX) & movable & target_ok
        C_new = torch.where(ok, c_star, C)
        r = running
        changed_prev = np.where(r, changed, changed_prev)
        changed = np.where(r, torch.any((C_new != C).view(b, nv), dim=1
                                        ).cpu().numpy(), changed)
        C = C_new
        rounds[r] += 1
        it += 1
        # stop only after both parity rounds go quiet
        running = r & (changed | changed_prev | (it < 2)) & (it < max_iters)
        if not np.array_equal(running, r):
            run_v = torch.from_numpy(running).to(dev).repeat_interleave(nv)
    node_valid = local < stacked.n_nodes.repeat_interleave(nv)
    labels, n_comms = seg.renumber_tile(C, node_valid, b)
    return (labels - (slot - local)).view(b, nv), rounds, n_comms, u


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
