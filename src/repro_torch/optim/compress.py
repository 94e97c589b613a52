"""int8 gradient compression with error feedback (port of
``repro/optim/compress.py``).

Each leaf is quantized to int8 with a per-tensor scale, and the
quantization residual is carried to the next step (error feedback keeps the
long-run mean unbiased).  ``torch.round``, like ``jnp.round``, rounds half
to even, so the codes are the reference's bit for bit on the same inputs.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def compress_int8(grads, error):
    """Returns (quantized int8 tree, scales tree, new local error tree);
    ``error`` is a tree like ``grads`` or ``None`` (no residual yet)."""
    def one(g, e):
        g = g.float() + e
        scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        new_e = g - q.float() * scale
        return q, scale, new_e

    flat = tree_leaves(grads)
    flat_e = tree_leaves(error) if error is not None else [0.0] * len(flat)
    out = [one(g, e) for g, e in zip(flat, flat_e)]
    return tuple(tree_unflatten(grads, [o[i] for o in out])
                 for i in range(3))


def decompress_int8(q, scales):
    return tree_map(lambda qq, ss: qq.float() * ss, q, scales)


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
