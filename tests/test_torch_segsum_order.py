"""The fold order of the unsorted segment-sum kernel, emulated on the CPU.

``csrc/onehot_segsum.cu`` sorts the rows by bucket (``T`` consecutive
segments), cuts each bucket's rows into pieces at the multiples of ``P``,
folds each piece's warp sub-ranges in index order, adds the warp tiles in
warp order and the pieces in piece order.  ``kernels/onehot_segsum.py``
states that plan in plain Python (:func:`plan_for`, :func:`piece_ranges`,
:func:`warp_ranges`) and runs it on the CPU (:func:`emulate`); the card
tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` hold the kernel
equal to the emulation bit for bit.  Here, without a card:

* the plan depends on ``(N, C, D)`` alone and keeps its counters bounded
  (its scratch size is the source's, held in ``tests/test_torch_cuda.py``);
* a mirror of the kernels' block-to-piece mapping covers every piece once;
* the emulation is the stated fold (an explicit float32 left fold), within
  ``(2 * count + 16) * 2^-24 * sum|v|`` of float64 per segment, and agrees
  with ``repro.kernels.ops.segsum`` through both ``impl="pallas"`` (in
  interpret mode) and ``impl="xla"`` at the reference's tolerances.

Inputs are made with numpy from a seed.
"""
import bisect
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.kernels import ops as jops
from repro_torch.kernels import ref
from repro_torch.kernels import onehot_segsum as oh

U32 = 2.0**-24


# --- the plan ----------------------------------------------------------------

def test_plan_takes_only_the_shape():
    """No SM count or other property of the card enters the plan."""
    assert list(inspect.signature(oh.plan_for).parameters) == \
        ["n", "num_segments", "d"]


@pytest.mark.parametrize("n,c,d,tile,buckets,shared", [
    (2_097_153, 857_336, 1, 4096, 210, True),    # the Sigma recompute
    (2_097_152, 524_288, 4, 1024, 512, True),    # the TPU envelope's edge
    (2_097_152, 524_288, 1, 4096, 128, True),    # one giant community
    (20_000, 702, 1500, 2, 351, True),
    (10, 5, 3072, 1, 5, True),
    (1000, 10**6, 1, 4096, 245, True),
    (1000, 10**8, 1, 4096, 24_415, False),
    (0, 1, 1, 4096, 1, True),
])
def test_plan(n, c, d, tile, buckets, shared):
    p = oh.plan_for(n, c, d)
    assert (p.tile_segments, p.buckets, p.shared_counters) == \
        (tile, buckets, shared)
    assert p.tile_segments * d <= oh.TILE_FLOATS
    assert p.chunks >= 1 and p.chunks * p.chunk_rows >= n
    # counters stay within n + buckets (global) or 1024 a warp (shared)
    if shared:
        assert p.buckets <= oh.SHARED_BUCKETS
    else:
        assert p.chunk_rows >= p.buckets
        assert p.buckets * p.chunks <= n + p.buckets + p.chunk_rows
    assert p.pieces == p.buckets + -(-n // p.piece_rows)
    assert p.partial_slots == 2 * -(-n // p.piece_rows)


@pytest.mark.parametrize("d", [0, 3073])
def test_plan_refuses_other_widths(d):
    with pytest.raises(ValueError, match="channels"):
        oh.plan_for(100, 10, d)


@pytest.mark.parametrize("start,stop", [(0, 0), (5, 5), (0, 4096), (1, 4097),
                                        (5000, 13000), (8192, 9000),
                                        (4095, 20480)])
def test_piece_and_warp_ranges_tile_the_rows(start, stop):
    pieces = oh.piece_ranges(start, stop, 4096)
    assert pieces[0][0] == start and pieces[-1][1] == stop
    for (a, z), (a2, _) in zip(pieces, pieces[1:]):
        assert z == a2 and z % 4096 == 0
    for a, z in pieces:
        assert z - a <= 4096
        warps = oh.warp_ranges(a, z)
        assert len(warps) == oh.FOLD_WARPS
        assert warps[0][0] == a and warps[-1][1] == z
        for (lo, hi), (lo2, _) in zip(warps, warps[1:]):
            assert hi == lo2 and (hi == z or (hi - lo) % 32 == 0)


def _kernel_pieces(plan, sizes):
    """What ``segsum_fold`` and ``segsum_pieces`` do with each bucket, line
    for line: {bucket: [(lo, hi, slot or None)]} in piece order, and the
    slots ``segsum_pieces`` sums, in its order."""
    ends = np.cumsum(sizes).tolist()
    starts = [e - s for e, s in zip(ends, sizes)]
    p = plan.piece_rows
    got = {}
    for blk in range(plan.pieces):
        if blk < plan.buckets:
            b = blk
            s, e = starts[b], ends[b]
            cut = (s // p + 1) * p
            lo, hi = s, min(e, cut)
            slot = None if e <= cut else 2 * (s // p) + 1
        else:
            k = blk - plan.buckets
            lo = k * p
            b = bisect.bisect_right(ends, lo)     # first bucket ending past lo
            if b == plan.buckets or starts[b] == lo:
                continue
            hi, slot = min(ends[b], lo + p), 2 * k
        got.setdefault(b, []).append((lo, hi, slot))
    summed = {}
    for b in range(plan.buckets):
        s, e = starts[b], ends[b]
        k0 = s // p
        if e > (k0 + 1) * p:
            summed[b] = [2 * k0 + 1] + [2 * k for k in range(k0 + 1, -(-e // p))]
    return got, summed, starts, ends


@pytest.mark.parametrize("seed", range(4))
def test_kernel_blocks_cover_every_piece_once(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 9000, 40)
    sizes[rng.integers(0, 40, 10)] = 0                      # empty buckets
    sizes[3] = 50_000                                       # a giant one
    sizes[7] = 4096                                         # exact multiples
    sizes[8] = 8192
    n = int(sizes.sum())
    plan = oh.plan_for(n, 40 * 4096, 1)
    assert plan.buckets == 40
    got, summed, starts, ends = _kernel_pieces(plan, sizes.tolist())
    slots = []
    for b in range(40):
        pieces = got[b]
        want = oh.piece_ranges(starts[b], ends[b], plan.piece_rows)
        assert [(lo, hi) for lo, hi, _ in sorted(pieces)] == want
        if len(want) == 1:                       # written straight to out
            assert pieces[0][2] is None and b not in summed
        else:
            order = [slot for _, _, slot in sorted(pieces)]
            assert summed[b] == order
            slots += order
    assert len(slots) == len(set(slots))
    assert all(0 <= s < plan.partial_slots for s in slots)


# --- the emulation -----------------------------------------------------------

def test_emulation_is_the_stated_left_fold():
    """Warp sub-ranges folded in index order from 0 in float32, warp tiles
    added in warp order, pieces in piece order: one bucket of two pieces,
    every warp busy, written out scalar by scalar."""
    rng = np.random.default_rng(3)
    n, c = 6000, 5
    v = rng.normal(size=(n, 1)).astype(np.float32) * \
        np.float32(10.0) ** rng.integers(-3, 4, (n, 1)).astype(np.float32)
    ids = rng.integers(0, c, n).astype(np.int32)
    got = oh.emulate(torch.from_numpy(v), torch.from_numpy(ids), c)
    want = np.zeros(c, np.float32)
    for s in range(c):
        pieces = []
        for lo, hi in oh.piece_ranges(0, n, oh.PIECE_ROWS):
            warps = []
            for a, z in oh.warp_ranges(lo, hi):
                acc = np.float32(0.0)
                for i in range(a, z):
                    if ids[i] == s:
                        acc = np.float32(acc + v[i, 0])
                warps.append(acc)
            acc = warps[0]
            for w in warps[1:]:
                acc = np.float32(acc + w)
            pieces.append(acc)
        acc = pieces[0]
        for x in pieces[1:]:
            acc = np.float32(acc + x)
        want[s] = acc
    assert np.array_equal(got[:, 0].numpy().view(np.int32),
                          want.view(np.int32))


def _case(name):
    """(values, ids, C, block_n of the Pallas run) of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "d1":
        n, c, d, bn = 20_000, 3000, 1, 512
    elif name == "d3":
        n, c, d, bn = 5000, 9000, 3, 128
    elif name == "d4":
        n, c, d, bn = 10_000, 2000, 4, 256
    elif name == "d1500":
        n, c, d, bn = 3000, 700, 1500, 128
    elif name == "huge_c":
        n, c, d, bn = 1000, 10**6, 1, 16
    elif name == "skewed":
        n, c, d, bn = 12_000, 50_000, 1, 128
    else:                                              # out-of-range ids
        n, c, d, bn = 9000, 600, 2, 256
    v = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, c, n).astype(np.int32)
    if name == "skewed":
        ids[rng.permutation(n)[: n // 2]] = 7          # half in one segment
    if name == "out_of_range":
        bad = rng.permutation(n)[:500]
        ids[bad] = rng.choice(np.array([-1, -7, c, c + 1, 2**31 - 1],
                                       dtype=np.int32), 500)
    return v, ids, c, bn


CASES = ["d1", "d3", "d4", "d1500", "huge_c", "skewed", "out_of_range"]


@pytest.mark.parametrize("name", CASES)
def test_emulation_within_the_float32_bound(name):
    v, ids, c, _ = _case(name)
    vt, it = torch.from_numpy(v), torch.from_numpy(ids)
    got = oh.emulate(vt, it, c)
    assert got.dtype == torch.float32 and got.shape == (c, v.shape[1])
    exact = ref.onehot_segsum_ref(vt.double(), it, c)
    inside = (it >= 0) & (it < c)
    count = torch.zeros(c + 1, dtype=torch.float64).index_add_(
        0, torch.where(inside, it, c), torch.ones(len(it), dtype=torch.float64)
    )[:c]
    absum = ref.onehot_segsum_ref(vt.double().abs(), it, c)
    bound = (2 * count[:, None] + 16) * U32 * absum
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert not got[count == 0].any()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("name", CASES)
def test_emulation_agrees_with_the_reference(name, impl):
    v, ids, c, bn = _case(name)
    got = oh.emulate(torch.from_numpy(v), torch.from_numpy(ids), c)
    want = jops.segsum(jnp.asarray(v), jnp.asarray(ids), c, impl=impl,
                       block_n=bn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_emulation_rounds_once_to_the_input_type(dtype):
    v, ids, c, _ = _case("d4")
    vt = torch.from_numpy(v).to(dtype)
    got = oh.emulate(vt, torch.from_numpy(ids), c)
    assert got.dtype == dtype
    assert torch.equal(got, oh.emulate(vt.float(), torch.from_numpy(ids),
                                       c).to(dtype))
