"""The kernel dispatch point (port of ``repro/kernels/ops.py``).

Dispatch is by device, with no knob: a CUDA tensor goes to the hand-written
kernel (``kernels/segsum.py``, ``spmm.py``, ``onehot_segsum.py``,
``flash_attn.py``), a CPU tensor to the plain version (``kernels/ref.py``).
There is no fallback from one to the other.  A fake tensor
(``FakeTensorMode``: a trace, which runs nothing) reaches B.5's registered
op on any device, so a trace counts the kernel's work.  The public functions keep the
reference's signatures and layouts, less its ``impl`` and block-size knobs.

The bit-exactness contract of :func:`segreduce_sorted` carries over from
the reference: the kernel, the plain version and the JAX package's
backends agree bit for bit, and with them every delta-modularity tie-break
and partition.  The f32 sum folds every segment strictly in index order.
Max, min (the reference's IEEE maximum/minimum: -0 below +0, NaN
absorbing) and the int32 sum (wrapping) are exact in any order, so the
kernel reduces them in a tree and still gives the same bits.
:func:`sum_inorder` builds a flat sum in one fixed order on top of it, the
same on every device.  The other functions are held to the reference
within stated tolerances.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import flash_attn  # noqa: F401 (registers the op)
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
    if not _on(values, "segreduce_sorted"):
        return ref.segreduce_sorted_ref(values, ids, num_segments, op=op)
    squeeze = values.dim() == 1
    v = values[:, None] if squeeze else values
    out = segreduce_sorted_cuda(v.contiguous(), ids.contiguous(),
                                num_segments, op=op)
    return out[:, 0] if squeeze else out


def segment_sum_inorder(values: torch.Tensor, ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Segment sum over **unsorted** ids, folded in index order.

    The reference leaves these sums (Sigma keyed by community) to XLA's
    in-order scatter.  A stable sort by id keeps index order within each
    id, so the sorted segment sum that follows is the same left fold on
    every device, with no atomics.
    """
    if not _on(values, "segment_sum_inorder"):
        # the CPU's index_add_ walks the rows in index order: the same fold
        return ref.segreduce_sorted_ref(values, ids, num_segments)
    s_ids, perm = torch.sort(ids, stable=True)
    return segreduce_sorted(values[perm], s_ids, num_segments, op="sum")


FLAT_CHUNK = 1024   # values that one in-order fold of sum_inorder takes


def sum_inorder(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of ``x [M]`` in one fixed order on every device.

    A tree of in-order folds, :data:`FLAT_CHUNK` wide: each level folds
    chunks of ``FLAT_CHUNK`` consecutive values in index order from +0.0
    (keyed by ``arange // FLAT_CHUNK``), until one value is left.  Every
    level goes through :func:`segreduce_sorted`, so the card's kernel and
    the CPU's plain version give the same bits; ``torch.sum`` is a tree
    whose shape depends on the device.  Partial sums stay small, so the
    result stays close to the exact sum: a flat fold, or two levels at
    scale 21, folds tens of thousands of values into one float32 that has
    passed 2**24 and drifts by hundreds of ulps.  An empty ``x`` sums to
    +0.0.  Returns a 0-dim tensor on ``x``'s device.
    """
    while True:
        m = x.shape[0]
        chunk = torch.arange(m, dtype=torch.int32, device=x.device) // FLAT_CHUNK
        x = segreduce_sorted(x, chunk, max(-(-m // FLAT_CHUNK), 1), op="sum")
        if x.shape[0] == 1:
            return x[0]


@functools.lru_cache(maxsize=16)
def _flat_levels(lengths: tuple, device: torch.device) -> tuple:
    """The chunk keys of each level of :func:`sum_inorder_per_graph` for
    pieces of these ``lengths``: ``((keys int32, n_chunks), ...)``, keyed
    ``chunk_base[g] + (j - off[g]) // FLAT_CHUNK``.  Cached by lengths,
    since a sweep loop sums pieces of the same lengths every sweep."""
    n = np.asarray(lengths, np.int64)
    levels = []
    while True:
        chunks = np.maximum(-(-n // FLAT_CHUNK), 1)
        base = np.cumsum(chunks) - chunks
        g = np.repeat(np.arange(n.shape[0]), n)
        pos = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        keys = (base[g] + pos // FLAT_CHUNK).astype(np.int32)
        levels.append((torch.from_numpy(keys).to(device), int(chunks.sum())))
        if (chunks == 1).all():
            return tuple(levels)
        n = chunks


def sum_inorder_per_graph(x: torch.Tensor, lengths) -> torch.Tensor:
    """:func:`sum_inorder` of each of the consecutive pieces of ``x`` whose
    ``lengths`` (host ints, summing to ``x``'s length) are given: float32
    ``[len(lengths)]``, each value the bits of :func:`sum_inorder` on its
    piece alone.

    Each level folds every piece's chunks of :data:`FLAT_CHUNK` values in
    one :func:`segreduce_sorted`, piece after piece, so the chunks and
    their folds are the lone sum's.  A piece that is down to one value
    before the others is folded again as a chunk of one, ``+0.0 + v``,
    which is ``v``: a fold from +0.0 never gives -0.0.  An empty piece
    sums to +0.0, as :func:`sum_inorder` of an empty vector."""
    for keys, n_chunks in _flat_levels(tuple(int(n) for n in lengths),
                                       x.device):
        x = segreduce_sorted(x, keys, n_chunks, op="sum")
    return x


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
    if _on(q, "flash_attention") or _is_fake(q):
        # the registered op: flash_attention_cuda on the card; a fake
        # tensor (a trace, on any device) meets its fake kernel instead
        return torch.ops.repro_torch.flash_attention(q, k, v, causal, window)
    return ref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window)


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)
