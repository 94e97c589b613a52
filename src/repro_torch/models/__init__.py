"""Model zoo (port of ``repro/models/``): LM transformers (dense + MoE),
GNNs, recsys.

Every family keeps the reference's functional surface: a ``Config``
dataclass (the published configs live in :mod:`repro_torch.configs`), an
``init_*(gen, cfg, device=None)`` drawing the reference's parameter tree
from a ``torch.Generator``, pure forward / loss functions on tensors, and
``param_logical_axes(cfg)``: the reference's logical-axes tree of the
parameters, which :mod:`repro_torch.distributed.sharding` resolves to
specs on a mesh (:mod:`repro_torch.launch.steps`).

The reference draws its parameters with ``jax.random``, which torch cannot
reproduce; :func:`params_from_numpy` carries its arrays across.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def _leaf_from_numpy(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: by its bits
        t = torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def normal(gen: torch.Generator, shape, *, device=None) -> torch.Tensor:
    """A standard-normal float32 tensor of ``shape`` drawn from ``gen`` on
    its device, placed on ``device`` (default: the generator's)."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x if device is None else x.to(device)


def params_from_numpy(tree, *, device, dtype=None):
    """A reference parameter or optimiser tree, with numpy leaves (an
    LM's, a GNN's, BST's, or AdamW's ``dict(m, v, step)``), as the port's
    tree of tensors on ``device``: the same keys, nesting and shapes, each
    leaf its numpy dtype, or ``dtype`` for the floating ones."""
    return tree_map(lambda a: _leaf_from_numpy(a, device, dtype), tree)


__all__ = ["normal", "params_from_numpy"]
