"""Sorted-id layouts at the edges of the segment-reduce kernel's tiles,
shared by the card tests (``test_torch_cuda.py``) and the CPU tests of the
in-order route's plan (``test_torch_inorder_plan.py``).

Each layout is ``(ids, nseg)``: nondecreasing int32 ids made with numpy
from a fixed seed, and a segment count past the last id.  ``T`` below is
the kernels' tile, ``segsum.TILE_ROWS``.
"""
import numpy as np

from repro_torch.kernels.segsum import TILE_ROWS

TILED_LAYOUTS = ["edges", "inside", "all", "one_row", "below_tile", "ragged",
                 "gaps", "head", "tail", "empty"]
# the in-order route's layouts: those, and one segment across many tiles
INORDER_LAYOUTS = TILED_LAYOUTS + ["hub"]


def _ids_from_starts(starts, spacing=1, head=0):
    starts = starts.copy()
    if starts.size:
        starts[0] = True
    return (head + (np.cumsum(starts) - 1) * spacing).astype(np.int32)


def tiled_layout(name):
    """``(ids, nseg)`` of one layout."""
    t = TILE_ROWS
    seed = sorted(TILED_LAYOUTS).index(name) if name in TILED_LAYOUTS \
        else len(TILED_LAYOUTS)
    rng = np.random.default_rng(seed)

    def starts(m, p=0.3):
        return rng.random(m) < p

    if name == "edges":            # runs that end and start at tile edges
        s = starts(4 * t + 100)
        s[t] = True                          # one ends at T - 1, one starts at T
        s[2 * t] = s[2 * t + 1] = True       # a one-row run starting at 2T
        s[3 * t - 1] = s[3 * t] = True       # a one-row run ending at 3T - 1
        ids = _ids_from_starts(s, spacing=2)
    elif name == "inside":         # tiles 1 and 2 wholly inside one segment
        s = starts(5 * t)
        s[t // 2: 3 * t + t // 2] = False
        s[t // 2] = True
        ids = _ids_from_starts(s)
    elif name == "all":            # one segment of all M rows, nseg = 1
        return np.zeros(5 * t + 3, np.int32), 1
    elif name == "one_row":
        return np.zeros(1, np.int32), 1
    elif name == "below_tile":     # M below one tile
        ids = _ids_from_starts(starts(100), spacing=3)
    elif name == "ragged":         # M not a multiple of the tile
        ids = _ids_from_starts(starts(4 * t + 777, 0.6), spacing=2)
    elif name == "gaps":           # interior gaps longer than a tile
        ids = _ids_from_starts(starts(3 * t))
        ids[t + 100:] += 3 * t + 5           # inside tile 1
        ids[2 * t:] += 5 * t                 # at the edge of tile 2
    elif name == "head":           # millions of empty segments before ids[0]
        ids = _ids_from_starts(starts(2 * t + 5), head=2_000_000)
    elif name == "tail":           # millions of empty segments after the last
        ids = _ids_from_starts(starts(2 * t + 5))
        return ids, int(ids[-1]) + 1 + 3_000_000
    elif name == "empty":          # no rows at all
        return np.zeros(0, np.int32), 10
    elif name == "hub":            # rows t + 300 .. 6t + 699: six tiles,
        s = starts(8 * t)          # starting and ending mid-tile
        s[t + 300: 6 * t + 700] = False
        s[t + 300] = s[6 * t + 700] = True
        ids = _ids_from_starts(s)
    else:
        raise ValueError(f"no layout {name!r}")
    return ids, int(ids[-1]) + 1 + 7
