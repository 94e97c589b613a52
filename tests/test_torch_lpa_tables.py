"""The per-round hash tables of the port's LPA and dense sweep loop, on
the CPU.

``lpa_run`` reads each round's movers and tie-break keys from tables of
the vertex ids (``core/lpa.py:_round_tables``, a block of rounds at a
time, cached by shape where one block holds all rounds), and the dense
sweep loop reads cached parity masks (``core/local_move.py:
_parity_masks``).  Each row must be what the per-round hashes give, and
``lpa_run`` must give the reference's labels and rounds whether its
rounds come in one block or in many.
"""
import importlib

import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import GRAPHS, _eq, _port

from repro.core.lpa import lpa_run as j_lpa_run
from repro_torch.core.local_move import _hash_parity, _parity_masks

# the module, not the package's ``lpa`` function of the same name
tlpa = importlib.import_module("repro_torch.core.lpa")


@pytest.mark.parametrize("nv,start,n", [(1, 0, 50), (65, 0, 50),
                                        (257, 7, 3), (1025, 49, 1)])
def test_round_tables_are_the_per_round_hashes(nv, start, n):
    ids = torch.arange(nv, dtype=torch.int32)
    movers, keys = tlpa._round_tables(nv, start, n, torch.device("cpu"))
    assert movers.shape == keys.shape == (n, nv)
    assert (movers.dtype, keys.dtype) == (torch.bool, torch.int32)
    for k in range(n):
        it = start + k
        assert torch.equal(movers[k], _hash_parity(ids, it) == it % 2), it
        assert torch.equal(keys[k], tlpa.hash_key(ids, it)), it


@pytest.mark.parametrize("nv,n", [(2, 20), (65, 20), (1025, 10)])
def test_parity_masks_are_the_per_sweep_parities(nv, n):
    ids = torch.arange(nv, dtype=torch.int32)
    zero, one = _parity_masks(nv, n, torch.device("cpu"))
    assert zero.shape == one.shape == (n, nv)
    for it in range(n):
        pbit = _hash_parity(ids, it)
        assert torch.equal(zero[it], pbit == 0) and torch.equal(one[it],
                                                                pbit == 1)
    assert _parity_masks(nv, n, torch.device("cpu"))[0] is zero   # cached


@pytest.mark.parametrize("cells", [1, 600, 1 << 18])
@pytest.mark.parametrize("family", ["rmat", "grid"])
def test_lpa_run_in_blocks_of_rounds_equals_reference(family, cells,
                                                      monkeypatch):
    """Tables of ``cells`` entries: one round a block, a few rounds a
    block (uncached), and every round in one block (cached)."""
    monkeypatch.setattr(tlpa, "TABLE_CELLS", cells)
    gj = GRAPHS[family]()
    Cj, itj = j_lpa_run(gj, seg_impl="xla")
    Ct, itt = tlpa.lpa_run(_port(gj))
    _eq(Ct, Cj, f"{family} LPA labels, {cells}-cell tables")
    assert itt == int(itj)
