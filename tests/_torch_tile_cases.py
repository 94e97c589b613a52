"""Seeded sweep states of the batched engine's tile, for the tile's tests
(``tests/test_torch_batched.py`` on the CPU, ``tests/test_torch_cuda.py``
on the card) and ``chip_smoke.py``.

:func:`tile_state` takes graphs of one bucket and draws, for each, labels
``C`` (the ghost its own), movable and target masks from one numpy seed,
with ``K``, ``Sigma`` and 2m from the port's in-order folds: once a graph
alone and once laid out as the union of the tile
(``graph/container.py:GraphUnion``), on the graphs' device.  Imports no
jax.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.container import stack_graphs, strip_padding, union_of
from repro_torch.kernels import ops


def tile_state(graphs, seed: int = 7, refine: bool = False):
    """``(lone, union_args, union)``: ``lone`` a tuple ``(src, dst, w, C,
    K, Sigma, two_m, movable, target_ok)`` a graph (its live edges,
    ``[nv]`` state, 0-dim 2m), ``union_args`` the same nine on the union
    (``[b * nv]`` state, communities in their graph's slots, 2m ``[b]``),
    and the union.  ``refine=True`` gives a refinement's first sweep
    instead (``core/louvain.py:refine_labels``): the weights between the
    drawn communities zeroed (every edge kept), ``K`` and ``Sigma`` the
    in-community weights, ``C`` the singletons, 2m the whole graph's."""
    rng = np.random.default_rng(seed)
    u = union_of(stack_graphs(graphs))
    nv, dev, lone = u.nv, u.src.device, []
    for g in graphs:
        src, dst, w = strip_padding(g.src, g.dst, g.w, g.ghost)
        C = torch.from_numpy(rng.integers(0, max(int(g.n_nodes), 1),
                                          nv).astype(np.int32)).to(dev)
        C[nv - 1] = nv - 1
        two_m = ops.sum_inorder(w)
        if refine:
            w = torch.where(C[src] == C[dst], w, 0.0)
            C = torch.arange(nv, dtype=torch.int32, device=dev)
        K = ops.segreduce_sorted(w, src, nv, op="sum")
        Sigma = ops.segment_sum_inorder(K, C, nv)
        movable = torch.from_numpy(rng.random(nv) < 0.6).to(dev)
        target = torch.from_numpy(rng.random(nv) < 0.5).to(dev)
        lone.append((src, dst, w, C, K, Sigma, two_m, movable, target))
    off = torch.arange(len(graphs), dtype=torch.int32, device=dev)[:, None]
    C_u = torch.stack([a[3] for a in lone]).add(off * nv).view(-1)
    cat = [torch.cat([a[k] for a in lone]) for k in (4, 5, 7, 8)]
    w_u = torch.cat([a[2] for a in lone]) if refine else u.w
    union_args = (u.src, u.dst, w_u, C_u, cat[0], cat[1],
                  torch.stack([a[6] for a in lone]), cat[2], cat[3])
    return lone, union_args, u
