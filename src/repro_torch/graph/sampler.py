"""Uniform-fanout neighbor sampling (GraphSAGE-style), port of
``repro/graph/sampler.py``.

``minibatch_lg`` cells train on sampled k-hop subgraphs: ``batch_nodes``
seeds, fanout ``[f1, f2]`` (15-10).  The sampler works on the CSR view of
a :class:`~repro_torch.graph.container.Graph` with **static output
shapes**:

* layer 0 frontier: ``[B]`` seed ids
* layer 1 frontier: ``[B, f1]`` sampled neighbor ids (+ edge list)
* layer 2 frontier: ``[B * f1, f2]`` ...

Vertices with degree < fanout sample with replacement; degree-0 vertices
(and ghost padding) yield self-edges with weight 0, which downstream
segment-reductions ignore.

The reference's ``_sample_layer`` draws and samples in one; here
:func:`sample_layer` is a pure function of the draws ``r`` and
:func:`neighbor_sample` draws them from a ``torch.Generator``.  Given the
reference's draws, the neighbours and masks are the reference's bit for
bit.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.device import resolve_device

DRAW_HIGH = 2**31 - 1       # draws are uniform int32 in [0, DRAW_HIGH)


def sample_layer(r, frontier, row_offsets, dst):
    """Sample ``r.shape[1]`` neighbors for each vertex in ``frontier`` from
    the draws ``r`` (int32 ``[F, fanout]``, in ``[0, DRAW_HIGH)``).

    Returns (neighbors [F, fanout] int32, valid [F, fanout] bool).
    """
    f = frontier.long()
    start = row_offsets[f]
    end = row_offsets[f + 1]
    deg = end - start
    # uniform with replacement in [0, deg); degree-0 falls back to self
    offs = torch.where(deg[:, None] > 0,
                       r % torch.clamp(deg[:, None], min=1), 0)
    idx = start[:, None] + offs
    nbrs = dst[torch.clamp(idx, 0, dst.shape[0] - 1).long()]
    valid = (deg[:, None] > 0).expand(nbrs.shape)
    nbrs = torch.where(valid, nbrs, frontier[:, None])
    return nbrs, valid


def neighbor_sample(gen: torch.Generator, seeds, row_offsets, dst,
                    fanouts: Sequence[int], *, device=None):
    """Multi-layer uniform neighbor sampling on ``device`` (``None`` =
    CUDA; the inputs are moved there).

    Args:
      gen: the generator of the draws, one int32 ``[F_l, fanout_l]`` block
        a layer, drawn on its own device (so a CPU generator gives the
        same samples on every device).
      seeds: int32[B] seed vertex ids.
      row_offsets: int32[nv + 1] CSR offsets of the full graph.
      dst: int32[m_cap] CSR/sorted-COO destination array.
      fanouts: per-layer fanout, outermost first (e.g. ``(15, 10)``).

    Returns:
      A dict with, per layer ``l``:
        ``src_l`` int32[F_l * fanout_l]: edge sources (frontier vertex ids,
            repeated), ``dst_l``: sampled neighbors, ``valid_l``: bool mask,
      plus ``frontiers``: list of frontier id arrays (layer 0 = seeds).
      Shapes are static given (B, fanouts).
    """
    dev = resolve_device(device)
    frontier = seeds.to(dev)
    row_offsets, dst = row_offsets.to(dev), dst.to(dev)
    layers = []
    frontiers = [frontier]
    for f in fanouts:
        r = torch.randint(0, DRAW_HIGH, (frontier.shape[0], f),
                          generator=gen, device=gen.device,
                          dtype=torch.int32).to(dev)
        nbrs, valid = sample_layer(r, frontier, row_offsets, dst)
        dst_e = nbrs.reshape(-1)
        layers.append(dict(src=frontier.repeat_interleave(f), dst=dst_e,
                           valid=valid.reshape(-1), fanout=f))
        frontier = dst_e
        frontiers.append(frontier)
    return dict(layers=layers, frontiers=frontiers)


def subgraph_relabel(frontiers):
    """Concatenate frontiers into one padded node list with positional ids.

    The sampled computation graph is 'layered': layer l edges connect
    positions in frontier[l] to positions in frontier[l+1].  Models consume
    positional indexing directly, so no hash-based relabeling is needed —
    this returns the flat node id list [sum_l F_l] and per-layer position
    offsets.
    """
    sizes = [int(f.shape[0]) for f in frontiers]
    offsets = [0]
    for s in sizes[:-1]:
        offsets.append(offsets[-1] + s)
    return torch.cat(frontiers), offsets
