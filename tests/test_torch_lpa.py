"""LPA, the 'fast' tier of the PyTorch port, held against the JAX package
on the CPU: the tie-break hash key, ``lpa_run``'s labels and rounds, and
the ``lpa`` entry point.

The reference's hash is uint32; the port computes it in int64 and shifts
it into int32 (``core/lpa.py:hash_key``) because the segment reduce takes
float32 and int32 only.  The key must be the reference's ``h`` minus
``2**31`` exactly, so that the min over keys picks what the min over
``h`` picks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_detect import GRAPHS, _eq, _port

import repro.core as jcore
import repro.graph as rg
import repro_torch.core as tcore
from repro.core.lpa import lpa_run as j_lpa_run
from repro_torch.core._segments import INT_MAX
from repro_torch.core.lpa import hash_key
from repro_torch.core.lpa import lpa_run as t_lpa_run

U32 = 2**32


def _reference_h(c: np.ndarray, it: int) -> np.ndarray:
    """The reference's uint32 hash (``src/repro/core/lpa.py``, the two
    lines that build ``h``), as int64."""
    s_cd = jnp.asarray(c.astype(np.uint32))
    it = jnp.int32(it)
    h = (s_cd.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
         + it.astype(jnp.uint32) * jnp.uint32(0xB5297A4D))
    h = ((h ^ (h >> 15)) * jnp.uint32(0x45D9F3B)).astype(jnp.uint32)
    return np.asarray(h).astype(np.int64)


REGIONS = {"near 0": 0, "near 2**31": 2**31 - 500,
           "near 2**32 - 1": U32 - 1000}


@pytest.mark.parametrize("region", sorted(REGIONS))
def test_hash_key_is_reference_hash_shifted(region):
    c = np.arange(REGIONS[region], REGIONS[region] + 1000, dtype=np.int64)
    c = np.concatenate([c, np.random.default_rng(0).integers(0, U32, 1000)])
    for it in range(51):
        key = hash_key(torch.from_numpy(c), it)
        assert key.dtype == torch.int32
        np.testing.assert_array_equal(key.numpy().astype(np.int64) + 2**31,
                                      _reference_h(c, it), err_msg=f"it={it}")


def test_hash_key_map_is_bijective_and_keeps_order():
    """h -> h - 2**31 (h ^ 0x80000000 as int32) keeps order, is one to one
    on the whole uint32 range, and sends the sentinel to INT32_MAX."""
    h = np.concatenate([np.arange(0, 2000),
                        np.arange(2**31 - 1000, 2**31 + 1000),
                        np.arange(U32 - 2000, U32),
                        np.random.default_rng(1).integers(0, U32, 5000)])
    h = np.unique(h.astype(np.int64))
    key = torch.from_numpy(h - 2**31).to(torch.int32).numpy()
    assert np.all(np.diff(key.astype(np.int64)) > 0)       # same order
    assert np.unique(key).size == h.size                    # one to one
    np.testing.assert_array_equal(key, (h ^ 0x80000000).astype(np.uint32)
                                  .view(np.int32))
    assert int(key[-1]) == INT_MAX and int(h[-1]) == U32 - 1


@pytest.mark.parametrize("family", sorted(GRAPHS))
def test_lpa_run_equals_reference(family):
    gj = GRAPHS[family]()
    Cj, itj = j_lpa_run(gj, seg_impl="xla")
    Ct, itt = t_lpa_run(_port(gj))
    _eq(Ct, Cj, f"{family} LPA labels")
    assert itt == int(itj)


@pytest.mark.parametrize("max_iters", [1, 2, 3, 7])
def test_lpa_run_round_limit_equals_reference(max_iters):
    gj = GRAPHS["rmat"]()
    Cj, itj = j_lpa_run(gj, max_iters=max_iters, seg_impl="xla")
    Ct, itt = t_lpa_run(_port(gj), max_iters=max_iters)
    _eq(Ct, Cj, f"LPA labels after at most {max_iters} rounds")
    assert itt == int(itj) <= max_iters


@pytest.mark.parametrize("make", [
    lambda: rg.rmat_graph(scale=8, edge_factor=6, seed=2, n_cap=300,
                          m_cap=4000),
    lambda: rg.from_coo(5, np.array([], np.int32), np.array([], np.int32),
                        n_cap=8, m_cap=10),
], ids=["padded_rmat", "edgeless"])
def test_lpa_run_padded_graphs_equal_reference(make):
    """The port strips the ghost padding that the reference masks."""
    gj = make()
    Cj, itj = j_lpa_run(gj, seg_impl="xla")
    Ct, itt = t_lpa_run(_port(gj))
    _eq(Ct, Cj, "labels")
    assert itt == int(itj)


def test_lpa_entry_point_is_the_fast_tier():
    gj = GRAPHS["sbm"]()
    Cj, sj = jcore.lpa(gj)
    Ct, st = tcore.lpa(_port(gj), device="cpu")
    _eq(Ct, Cj, "labels")
    assert st == {k: int(v) for k, v in sj.items()}
    res = tcore.detect(_port(gj), options=tcore.DetectOptions(
        algorithm="fast"), device="cpu")
    assert torch.equal(res.labels, Ct) and res.stats == st
    # the algorithm field of the options given is overridden
    Co, _ = tcore.lpa(_port(gj), options=tcore.DetectOptions(
        algorithm="max-quality"), device="cpu")
    assert torch.equal(Co, Ct)


@pytest.mark.parametrize("nv", [1, 65, 1025])
def test_hash_key_rounds_on_vertex_ids(nv):
    """What ``lpa_run`` hashes: the vertex ids ``[0, nv)`` of a service
    bucket's width, every round up to the limit, each the reference's
    ``h`` minus ``2**31``."""
    ids = np.arange(nv, dtype=np.int64)
    for it in range(50):
        key = hash_key(torch.from_numpy(ids).to(torch.int32), it)
        np.testing.assert_array_equal(key.numpy().astype(np.int64) + 2**31,
                                      _reference_h(ids, it),
                                      err_msg=f"it={it}")
