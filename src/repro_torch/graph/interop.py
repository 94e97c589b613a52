"""Carry a graph (and optionally labels) across from the JAX package.

The JAX package's :class:`repro.graph.container.Graph` and its int32 labels
leave JAX as numpy arrays (the caller does the ``np.asarray``; this module
imports no jax).  :func:`graph_from_arrays` places them on a device as the
port's :class:`~repro_torch.graph.container.Graph`, unchanged: the arrays
already hold the padded, sorted directed-COO layout, so nothing is re-sorted
and both packages see the same input bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.container import Graph


def graph_from_arrays(src, dst, w, n_nodes, n_cap: int, *, C=None,
                      device=None):
    """Build a :class:`Graph` from padded directed-COO arrays.

    ``src``/``dst`` int32[m_cap], ``w`` float32[m_cap] and ``n_nodes``
    follow the container invariants (checked: lengths, ghost index,
    ``src`` nondecreasing).  Returns the graph, or ``(graph, C)`` when
    int32 labels ``C`` of length ``n_cap + 1`` are given.
    """
    device = resolve_device(device)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    w = np.asarray(w, np.float32)
    if not (src.shape == dst.shape == w.shape and src.ndim == 1):
        raise ValueError("src, dst and w must be 1-D arrays of one length")
    if src.size and (src.max() > n_cap or dst.max() > n_cap
                     or src.min() < 0 or dst.min() < 0):
        raise ValueError(f"vertex ids must lie in [0, n_cap={n_cap}]")
    if np.any(src[1:] < src[:-1]):
        raise ValueError("src must be sorted (container invariant)")
    g = Graph(
        src=torch.from_numpy(src.copy()).to(device),
        dst=torch.from_numpy(dst.copy()).to(device),
        w=torch.from_numpy(w.copy()).to(device),
        n_nodes=torch.tensor(int(n_nodes), dtype=torch.int32, device=device),
        n_cap=int(n_cap),
        m_cap=int(src.shape[0]),
    )
    if C is None:
        return g
    C = np.asarray(C, np.int32)
    if C.shape != (g.nv,):
        raise ValueError(f"C must have shape ({g.nv},), got {C.shape}")
    return g, torch.from_numpy(C.copy()).to(device)
