"""The kernel dispatch point (port of ``repro/kernels/ops.py``).

Dispatch is by device, with no knob: a CUDA tensor goes to the hand-written
kernel (``kernels/segsum.py``, ``spmm.py``, ``onehot_segsum.py``,
``flash_attn.py``), a CPU tensor to the plain version (``kernels/ref.py``).
There is no fallback from one to the other.  The public functions keep the
reference's signatures and layouts, less its ``impl`` and block-size knobs.

The bit-exactness contract of :func:`segreduce_sorted` carries over from
the reference: the kernel, the plain version and the JAX package's
backends agree bit for bit, and with them every delta-modularity tie-break
and partition.  The f32 sum folds every segment strictly in index order.
Max, min (the reference's IEEE maximum/minimum: -0 below +0, NaN
absorbing) and the int32 sum (wrapping) are exact in any order, so the
kernel reduces them in a tree and still gives the same bits.  The other
functions are held to the reference within stated tolerances.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attn import flash_attention_cuda
from repro_torch.kernels.onehot_segsum import onehot_segsum_cuda
from repro_torch.kernels.segsum import cumsum_cuda, segreduce_sorted_cuda
from repro_torch.kernels.spmm import bucket_spmm_cuda


def _on(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise for any other."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no {what} for device {t.device}")


def segreduce_sorted(values: torch.Tensor, ids: torch.Tensor,
                     num_segments: int, *, op: str = "sum") -> torch.Tensor:
    """Segment reduce (sum/max/min) over **sorted** segment ids.

    values: [M] or [M, D], float32 or int32; ids: int32[M], nondecreasing,
    in [0, num_segments).  Empty segments get the same fills as the
    ``jax.ops.segment_*`` family (0 / dtype-min / dtype-max).  A float32
    max or min segment that holds a NaN is NaN; +0 is above -0.
    """
    squeeze = values.dim() == 1
    v = values[:, None] if squeeze else values
    if _on(v, "segreduce_sorted"):
        out = segreduce_sorted_cuda(v.contiguous(), ids.contiguous(),
                                    num_segments, op=op)
    else:
        out = ref.segreduce_sorted_ref(v, ids, num_segments, op=op)
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


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0 of ``x [M]`` or ``[M, D]``,
    accumulated and returned in float32 (as the reference's kernel path)."""
    squeeze = x.dim() == 1
    v = x[:, None] if squeeze else x
    out = cumsum_cuda(v.contiguous()) if _on(v, "cumsum") \
        else ref.cumsum_ref(v)
    return out[:, 0] if squeeze else out


def segsum_sorted(values: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Segment sum over sorted ids as a difference of prefix sums.

    The sum over segment s is ``prefix[end_s] - prefix[start_s]``: two
    gathers of :func:`cumsum`'s output, prepended with a zero row, at the
    bounds ``searchsorted`` finds.  Returned in ``values``' type.  The
    float32 prefix loses precision once it passes 2**24 (see PERF.md); the
    direct sum is ``ref.segsum_sorted_ref``.
    """
    out = ref.prefix_difference(cumsum(values), segment_ids, num_segments)
    return out.to(values.dtype)


def spmm(nbr: torch.Tensor, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Fixed-degree neighbour aggregation ``out[i] = sum_k w[i, k] *
    x[nbr[i, k]]``: ``nbr`` int32 ``[N, K]``, ``w`` float32 ``[N, K]``
    (padding: any in-bounds id with ``w == 0``), ``x [Nx, D]``; returns
    ``[N, D]`` in ``x``'s type.  Any ``Nx`` (no VMEM envelope here); a
    neighbour outside ``[0, Nx)`` adds 0 on every device, as in the
    reference's kernel (its XLA path clamps such a gather instead)."""
    if _on(x, "spmm"):
        return bucket_spmm_cuda(nbr.contiguous(), w.contiguous(),
                                x.contiguous())
    return ref.bucket_spmm_ref(nbr, w, x)


def segsum(values: torch.Tensor, ids: torch.Tensor,
           num_segments: int) -> torch.Tensor:
    """Unsorted segment sum: ``values [N]`` or ``[N, D]`` by int32 ``ids``
    in ``[0, num_segments)``, summed in float32, returned in ``values``'
    type; deterministic on the card.  Any ``num_segments``; a row whose id
    lies outside ``[0, num_segments)`` adds nothing on every device, as in
    both of the reference's paths."""
    squeeze = values.dim() == 1
    v = values[:, None] if squeeze else values
    if _on(v, "segsum"):
        out = onehot_segsum_cuda(v.contiguous(), ids.contiguous(),
                                 num_segments)
    else:
        out = ref.onehot_segsum_ref(v, ids, num_segments)
    return out[:, 0] if squeeze else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """Attention forward with grouped-query heads.

    q: ``[B, Sq, Hq, Dh]``; k, v: ``[B, Sk, Hkv, Dh]`` with ``Hq % Hkv ==
    0``; returns ``[B, Sq, Hq, Dh]`` in ``q``'s type.  Query head ``h``
    attends with kv head ``h // (Hq // Hkv)``.  Keys at or beyond ``Sk``
    do not exist: nothing is padded.
    """
    if _on(q, "flash_attention"):
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return ref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
