"""The kernel dispatch point (port of ``repro/kernels/ops.py``).

Dispatch is by device, with no knob: a CUDA tensor goes to the hand-written
kernel (``kernels/segsum.py``), a CPU tensor to the plain version
(``kernels/ref.py``).  There is no fallback from one to the other.

The bit-exactness contract carries over from the reference: every segment
is folded strictly in index order, so the kernel, the plain version on the
CPU and the JAX package's backends agree bit for bit, and with them every
delta-modularity tie-break and partition.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.segsum import segreduce_sorted_cuda


def segreduce_sorted(values: torch.Tensor, ids: torch.Tensor,
                     num_segments: int, *, op: str = "sum") -> torch.Tensor:
    """Segment reduce (sum/max/min) over **sorted** segment ids.

    values: [M] or [M, D], float32 or int32; ids: int32[M], nondecreasing,
    in [0, num_segments).  Empty segments get the same fills as the
    ``jax.ops.segment_*`` family (0 / dtype-min / dtype-max).
    """
    squeeze = values.dim() == 1
    v = values[:, None] if squeeze else values
    if v.is_cuda:
        out = segreduce_sorted_cuda(v.contiguous(), ids.contiguous(),
                                    num_segments, op=op)
    elif v.device.type == "cpu":
        out = ref.segreduce_sorted_ref(v, ids, num_segments, op=op)
    else:
        raise ValueError(f"no segreduce_sorted for device {v.device}")
    return out[:, 0] if squeeze else out


def segment_sum_inorder(values: torch.Tensor, ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Segment sum over **unsorted** ids, folded in index order.

    The reference leaves these sums (Sigma keyed by community) to XLA's
    in-order scatter.  A stable sort by id keeps index order within each
    id, so the sorted segment sum that follows is the same left fold on
    every device, with no atomics.
    """
    s_ids, perm = torch.sort(ids, stable=True)
    return segreduce_sorted(values[perm], s_ids, num_segments, op="sum")
