"""Plain PyTorch versions of the port's kernels.

Each function here is the plain version of one kernel, with the same
semantics as its oracle in ``repro/kernels/ref.py``: what a CPU tensor
runs, and what the kernel is held against on the card.

:func:`segreduce_sorted_ref` is the plain version of the segment-reduce
kernel (``csrc/segreduce.cu``): the same function, the same signature.  On
the CPU its f32 sum folds every segment in index order (``index_add_``
walks the rows sequentially there, which the tests pin against the JAX
reference), so the port uses it for CPU tensors.  On CUDA that
``index_add_`` is atomic and folds in no fixed order: there it serves only
as a comparison and timing yardstick, never on the main path.  Its max,
min and int32 sum are exact in any order on both devices: f32 max/min
reduce the int32 key of :func:`order_key` with ``scatter_reduce_``, which
gives the reference's IEEE maximum/minimum (-0 below +0, NaN absorbing)
bit for bit, with the same NaN bits as the kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.segsum import scan_identity

_REDUCE = {"max": "amax", "min": "amin"}
_INT32 = torch.iinfo(torch.int32)


def order_key(bits: torch.Tensor) -> torch.Tensor:
    """The int32 key of float32 bits (``x.view(torch.int32)``) whose order
    is the float order with -0 below +0; its own inverse.  (NaN bits map
    outside [key(-inf), key(+inf)]; :func:`segreduce_sorted_ref` sends them
    to the key that wins instead.)"""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def segreduce_sorted_ref(values: torch.Tensor, ids: torch.Tensor,
                         num_segments: int, *, op: str = "sum"
                         ) -> torch.Tensor:
    """Segment reduce of ``values [M]`` or ``[M, D]`` over ``ids [M]`` in
    ``[0, num_segments)``; empty segments get :func:`scan_identity`.  A
    float32 max (min) segment that holds a NaN gives the NaN of bits
    0x7fffffff (0xffffffff), as the kernel does."""
    shape = (num_segments,) + tuple(values.shape[1:])
    if op == "sum":
        out = torch.zeros(shape, dtype=values.dtype, device=values.device)
        if values.is_cuda or values.dim() == 1 or values.shape[1] > 8:
            return out.index_add_(0, ids, values)
        # the CPU's index_add_ takes a [M] vector in one scalar loop and a
        # [M, D] matrix row by row through a tensor iterator, some 20x
        # slower at D = 1 or 2: a few columns go one at a time (the same
        # in-order fold, the same bits)
        for d in range(values.shape[1]):
            out[:, d].index_add_(0, ids, values[:, d])
        return out
    if op not in _REDUCE:
        raise ValueError(f"op must be sum, max or min, got {op!r}")
    keyed = values.dtype == torch.float32
    x, init = values, scan_identity(op, values.dtype)
    if keyed:
        nan_key = _INT32.max if op == "max" else _INT32.min
        x = torch.where(torch.isnan(values), nan_key,
                        order_key(values.view(torch.int32)))
        init = int(order_key(torch.tensor(init, dtype=torch.float32)
                             .view(torch.int32)))
    out = torch.full(shape, init, dtype=x.dtype, device=values.device)
    index = ids.long().view((-1,) + (1,) * (values.dim() - 1))
    out.scatter_reduce_(0, index.expand_as(x), x, _REDUCE[op],
                        include_self=True)
    return order_key(out).view(torch.float32) if keyed else out


def cumsum_ref(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0, accumulated and returned in
    float32: the function of ``csrc/cumsum.cu`` and of the reference's
    ``cumsum_blocked`` (the reference's oracle casts back to ``x``'s
    type)."""
    return torch.cumsum(x.float(), dim=0)


def segsum_sorted_ref(values: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Direct segment sum of ``values [M]`` or ``[M, D]`` over sorted
    ``segment_ids``, in ``values``' type (the oracle of the prefix-difference
    ``ops.segsum_sorted``)."""
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, segment_ids, values)


def prefix_difference(prefix: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Segment sums over sorted ``segment_ids`` from the inclusive prefix
    sum of the values along axis 0: ``prefix[end_s] - prefix[start_s]``,
    with a zero row prepended and the bounds found by ``searchsorted`` (the
    reference's ``ops.segsum_sorted``)."""
    prefix = torch.cat([prefix.new_zeros((1,) + tuple(prefix.shape[1:])),
                        prefix])
    bounds = torch.searchsorted(
        segment_ids, torch.arange(num_segments + 1, dtype=segment_ids.dtype,
                                  device=segment_ids.device))
    return prefix[bounds[1:]] - prefix[bounds[:-1]]


def onehot_segsum_ref(values: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Unsorted segment sum of ``values [N, D]`` by ``ids [N]``, accumulated
    in float32 and returned in ``values``' type (``csrc/onehot_segsum.cu``;
    the reference's kernel path sums in float32 too)."""
    out = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]),
                      dtype=torch.float32, device=values.device)
    # a row whose id lies outside [0, num_segments) goes to a spare last
    # segment, dropped: it adds nothing, as in the kernels
    inside = (ids >= 0) & (ids < num_segments)
    out.index_add_(0, torch.where(inside, ids, num_segments), values.float())
    return out[:num_segments].to(values.dtype)


def bucket_spmm_ref(nbr: torch.Tensor, w: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_k w[i, k] * x[nbr[i, k]]`` in ``w``'s type (float32),
    returned in ``x``'s type; padding neighbours carry ``w == 0``.  A
    neighbour outside ``[0, Nx)`` adds 0, as in the kernels."""
    if x.shape[0] == 0:
        return x.new_zeros((nbr.shape[0], x.shape[1]))
    inside = (nbr >= 0) & (nbr < x.shape[0])
    gathered = x[torch.where(inside, nbr, 0).long()].to(w.dtype)  # [N, K, D]
    gathered = torch.where(inside[..., None], gathered, 0.0)
    return torch.einsum("nk,nkd->nd", torch.where(inside, w, 0.0),
                        gathered).to(x.dtype)


SCORE_CHUNK_ELEMS = 2**28   # float32 scores per head chunk (1 GiB)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None
                        ) -> torch.Tensor:
    """Masked-softmax attention, ``q, k, v [B, H, S, Dh]`` (same H), in
    float32, returned in ``q``'s type.  Rows that see no key are 0.  Heads
    go in chunks of at most ``SCORE_CHUNK_ELEMS`` scores, so long sequences
    fit on the card; the function does not depend on the chunking."""
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    out = torch.empty((b, h, sq, dh), dtype=q.dtype, device=q.device)
    step = max(1, SCORE_CHUNK_ELEMS // max(1, b * sq * sk))
    for h0 in range(0, h, step):
        hs = slice(h0, h0 + step)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, hs].float(),
                         k[:, hs].float()) / math.sqrt(dh)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        p = torch.where(torch.isnan(p), 0.0, p)
        out[:, hs] = torch.einsum("bhqk,bhkd->bhqd", p,
                                  v[:, hs].float()).to(q.dtype)
    return out


def flash_attention_gqa_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int | None = None) -> torch.Tensor:
    """:func:`flash_attention_ref` on the kernel's layout: ``q [B, Sq, Hq,
    Dh]``, ``k, v [B, Sk, Hkv, Dh]``, query head ``h`` with kv head ``h //
    (Hq // Hkv)`` (the kv heads repeated, as the reference's
    ``ops.flash_attention``); returns ``[B, Sq, Hq, Dh]``."""
    g = q.shape[2] // k.shape[2]
    out = flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(g, dim=1),
        v.transpose(1, 2).repeat_interleave(g, dim=1), causal=causal,
        window=window)
    return out.transpose(1, 2)
