"""The in-order route's plan, emulated on the CPU.

``csrc/segreduce.cu:segreduce_inorder`` folds each f32 segment in index
order in tiles of ``TILE_ROWS`` rows: the tile where a segment ends writes
it, and every tile before that, back to the one where it starts, hands its
fold on as a carry.  ``kernels/segsum.py:inorder_plan`` states that split
with the kernel's formulas and ``emulate_inorder`` folds by it; the card
tests (``tests/test_torch_cuda.py``) hold the kernel to both.  Here,
without a card, on every layout of ``_torch_layouts`` (tile edges, tiles
wholly inside a segment, gaps, millions of empty head and tail segments,
no rows, and a segment across six tiles that starts mid-tile) and on
random layouts at a 16-row tile:

* every output element has exactly one writer;
* every carry chain runs through consecutive tiles from the segment's first
  tile and ends at its last one, which writes it;
* the plan's fold equals the plain version (``index_add_`` on the CPU, a
  left fold from +0.0) bit for bit, with ±0, ±inf, NaN and subnormals; a
  NaN matches a NaN of any payload, since which operand's payload an add
  keeps is the hardware's choice (the card's adds give one canonical NaN).

Inputs are made with numpy from seeds.
"""
import inspect

import numpy as np
import pytest
import torch
from _torch_layouts import INORDER_LAYOUTS, tiled_layout

from repro_torch.kernels import ref
from repro_torch.kernels import segsum


def _random_layout(seed, tile):
    """Sorted ids over a few 16-row tiles: short runs, long runs across
    tiles, and gaps."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, 8 * tile))
    starts = rng.random(m) < rng.choice([0.05, 0.3, 0.9])
    starts[0] = True
    gaps = np.where(starts, rng.choice([1, 1, 1, 4], m), 0)
    ids = (np.cumsum(gaps) - 1).astype(np.int32)
    return ids, int(ids[-1]) + 1 + int(rng.integers(0, 5))


def _values(ids, d, seed, inf_nan):
    """Normal values with ±0 and subnormals, and with ``inf_nan`` ±inf and
    NaN too."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(ids.shape[0], d)).astype(np.float32)
    pick = rng.random(v.shape)
    v[pick < 0.1] = -0.0
    v[(pick >= 0.1) & (pick < 0.15)] = 0.0
    sub = (pick >= 0.3) & (pick < 0.5)
    v[sub] = (np.float32(1e-40) * rng.integers(-64, 65, v.shape))[sub]
    if inf_nan:
        v[(pick >= 0.15) & (pick < 0.16)] = np.inf
        v[(pick >= 0.16) & (pick < 0.17)] = -np.inf
        v[(pick >= 0.17) & (pick < 0.175)] = np.nan
    return v


def _cases():
    for name in INORDER_LAYOUTS:
        yield pytest.param(*tiled_layout(name), segsum.TILE_ROWS, id=name)
    for seed in range(6):
        yield pytest.param(*_random_layout(seed, 16), 16, id=f"random{seed}")


CASES = list(_cases())


def _segment_rows(ids, nseg):
    """First and last row of each segment (-1 where it is empty)."""
    first = np.full(nseg, -1, np.int64)
    last = np.full(nseg, -1, np.int64)
    rows = np.arange(ids.shape[0])
    first[ids[::-1]] = rows[::-1]
    last[ids] = rows
    return first, last


@pytest.mark.parametrize("ids,nseg,tile", CASES)
def test_every_output_has_one_writer(ids, nseg, tile):
    p = segsum.inorder_plan(ids, nseg, tile)
    assert p.writes.shape == (nseg,)
    assert bool((p.writes == 1).all()), np.flatnonzero(p.writes != 1)[:10]
    first, last = _segment_rows(ids, nseg)
    # a segment with rows is written by the tile of its last row; an empty
    # one by a tile (a gap between its ids) or by the head/tail fill
    full = last >= 0
    assert np.array_equal(p.writer[full], last[full] // tile)
    outside = (np.arange(nseg) < (ids[0] if ids.size else nseg)) | \
        (np.arange(nseg) > (ids[-1] if ids.size else -1))
    assert np.array_equal(p.writer == -1, outside)


@pytest.mark.parametrize("ids,nseg,tile", CASES)
def test_carry_chains_end_at_the_last_tile(ids, nseg, tile):
    p = segsum.inorder_plan(ids, nseg, tile)
    first, last = _segment_rows(ids, nseg)
    crossing = {s for s in range(nseg)
                if last[s] >= 0 and first[s] // tile != last[s] // tile}
    assert set(p.chains) == crossing
    for s, chain in p.chains.items():
        assert chain == list(range(first[s] // tile, last[s] // tile))
        assert chain[-1] + 1 == p.writer[s] == last[s] // tile
    # a tile takes a carry exactly where the tile before hands one on
    assert np.array_equal(p.carry_in[1:], p.carry_out[:-1])
    if p.carry_in.size:
        assert not p.carry_in[0] and not p.carry_out[-1]


@pytest.mark.parametrize("ids,nseg,tile", CASES)
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("inf_nan", [False, True])
def test_plan_fold_equals_plain(ids, nseg, tile, d, inf_nan):
    """Bit for bit; a NaN where the plain version has a NaN."""
    v = _values(ids, d, d + ids.shape[0], inf_nan)
    with np.errstate(invalid="ignore"):           # inf + -inf
        got = segsum.emulate_inorder(v, ids, nseg, tile)
    want = ref.segreduce_sorted_ref(torch.from_numpy(v), torch.from_numpy(ids),
                                    nseg, op="sum")
    nan = torch.isnan(got) & torch.isnan(want)
    assert bool(((got.view(torch.int32) == want.view(torch.int32)) | nan).all())
    assert torch.equal(torch.isnan(got), torch.isnan(want))


def test_hub_layout_spans_tiles_from_mid_tile():
    """The hub layout's long segment starts mid-tile and spans six tiles."""
    ids, nseg = tiled_layout("hub")
    p = segsum.inorder_plan(ids, nseg)
    s, chain = max(p.chains.items(), key=lambda kv: len(kv[1]))
    first, _ = _segment_rows(ids, nseg)
    assert len(chain) + 1 >= 5 and first[s] % segsum.TILE_ROWS != 0
    # the tiles inside it take a carry and hand one on, with no head
    inner = chain[1:]
    assert p.carry_in[inner].all() and p.carry_out[inner].all()
    assert (p.first_head[inner] == segsum.TILE_ROWS).all()


def test_wrapper_finds_no_offsets():
    """The in-order route takes no offsets: the wrapper runs no
    ``searchsorted`` and the C entry has no offsets argument."""
    src = inspect.getsource(segsum.segreduce_sorted_cuda)
    assert "searchsorted" not in src and "offsets" not in src
    cu = (segsum._build.CSRC / "segreduce.cu").read_text()
    entry = cu[cu.index('extern "C" int segreduce_sorted('):]
    assert "offsets" not in entry[:entry.index("{")]
