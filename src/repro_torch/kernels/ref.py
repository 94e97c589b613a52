"""Plain PyTorch versions of the port's kernels.

:func:`segreduce_sorted_ref` is the plain version of the segment-reduce
kernel (``csrc/segreduce.cu``): the same function, the same signature.  On
the CPU it folds every segment in index order (``index_add_`` and
``scatter_reduce_`` walk the rows sequentially there, which the tests pin
against the JAX reference), so the port uses it for CPU tensors.  On CUDA
``index_add_`` is atomic and folds in no fixed order: there it serves only
as a comparison and timing yardstick, never on the main path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segsum import scan_identity

_REDUCE = {"max": "amax", "min": "amin"}


def segreduce_sorted_ref(values: torch.Tensor, ids: torch.Tensor,
                         num_segments: int, *, op: str = "sum"
                         ) -> torch.Tensor:
    """Segment reduce of ``values [M]`` or ``[M, D]`` over ``ids [M]`` in
    ``[0, num_segments)``; empty segments get :func:`scan_identity`."""
    out = torch.full((num_segments,) + tuple(values.shape[1:]),
                     scan_identity(op, values.dtype), dtype=values.dtype,
                     device=values.device)
    if op == "sum":
        return out.index_add_(0, ids, values)
    if op not in _REDUCE:
        raise ValueError(f"op must be sum, max or min, got {op!r}")
    index = ids.long().view((-1,) + (1,) * (values.dim() - 1))
    return out.scatter_reduce_(0, index.expand_as(values), values,
                               _REDUCE[op], include_self=True)
