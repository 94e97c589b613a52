"""The portfolio of the PyTorch port held against the JAX package, on the
CPU: every tier ('fast', 'standard', 'max-quality') and every split policy
of ``detect()``, and max-quality's pick between its two candidates.

Labels, integer stats and ``n_disconnected`` are compared exactly;
modularity within ``Q_ATOL`` (its flat float32 sums fold in another order
than the reference's ``jnp.sum``).  max-quality keeps the refined
candidate when ``q_r >= q_s``, so a near-tie could pick differently from
the reference: the probe cases below are pairs of different candidates
whose modularities lie within 1e-6 of each other (some equal in float32),
and each must make the reference's pick.

One departure from the reference is pinned here too: where its 'refine'
returns a community that is not connected, the port splits it (ROADMAP
C.7), so the standard and max-quality tiers keep zero disconnected.
"""
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import GRAPHS, Q_ATOL, _eq, _port, _t

import repro.core as jcore
import repro.graph as rg
import repro_torch.core as tcore
from repro.core.modularity import modularity as j_modularity
from repro_torch.core.modularity import modularity as t_modularity
from repro_torch.core._segments import renumber
from repro_torch.core.portfolio import _standard_config
from repro_torch.graph.container import strip_padding

SPLITS = ("none", "sp-lp", "sp-lpp", "sp-pj", "sl-lp", "sl-lpp", "sl-pj",
          "refine")
RUNS = [("standard", s) for s in SPLITS] + [("fast", "sp-pj"),
                                            ("max-quality", "sp-pj")]


def _both(gj, algorithm, split):
    ref = jcore.detect(gj, options=jcore.DetectOptions(
        algorithm=algorithm, scan="sort",
        louvain=jcore.LouvainConfig(split=split)))
    res = tcore.detect(_port(gj), options=tcore.DetectOptions(
        algorithm=algorithm, louvain=tcore.LouvainConfig(split=split)),
        device="cpu")
    return res, ref


@pytest.mark.parametrize("algorithm,split", RUNS,
                         ids=[f"{a}-{s}" for a, s in RUNS])
@pytest.mark.parametrize("family", sorted(GRAPHS))
def test_detect_tier_and_split_equal_reference(family, algorithm, split):
    res, ref = _both(GRAPHS[family](), algorithm, split)
    _eq(res.labels, ref.labels, f"{family} {algorithm} {split} labels")
    assert res.stats == {k: int(v) for k, v in ref.stats.items()}
    assert res.n_communities == int(ref.n_communities)
    assert res.n_disconnected == int(ref.n_disconnected)
    if tcore.contract_for(algorithm).zero_disconnected and split != "none":
        assert res.n_disconnected == 0
    assert abs(res.modularity - float(ref.modularity)) <= Q_ATOL
    assert res.contract == tcore.contract_for(algorithm)


def _candidates(gj):
    """``(q_r, q_s, C_r, C_s)`` of the port, then of the reference:
    max-quality's refined and GSP candidates and their modularities."""
    cfg_r = jcore.tier_config("max-quality", jcore.LouvainConfig())
    Cr, _ = jcore.louvain(gj, cfg_r)
    Cs, _ = jcore.louvain(gj, jcore.LouvainConfig())
    ref = (float(j_modularity(gj.src, gj.dst, gj.w, Cr)),
           float(j_modularity(gj.src, gj.dst, gj.w, Cs)),
           np.asarray(Cr), np.asarray(Cs))
    tg = _port(gj)
    live = strip_padding(tg.src, tg.dst, tg.w, tg.ghost)
    tCr, _ = tcore.louvain(tg, tcore.tier_config(
        "max-quality", tcore.LouvainConfig()), device="cpu")
    tCs, _ = tcore.louvain(tg, tcore.LouvainConfig(), device="cpu")
    got = (float(t_modularity(*live, tCr)), float(t_modularity(*live, tCs)),
           tCr, tCs)
    return got, ref


def _check_pick(gj):
    (tqr, tqs, tCr, tCs), (qr, qs, Cr, Cs) = _candidates(gj)
    _eq(tCr, Cr, "refined candidate")
    _eq(tCs, Cs, "GSP candidate")
    assert abs(tqr - qr) <= Q_ATOL and abs(tqs - qs) <= Q_ATOL
    assert (tqr >= tqs) == (qr >= qs), (tqr, tqs, qr, qs)
    res = tcore.detect(_port(gj), options=tcore.DetectOptions(
        algorithm="max-quality"), device="cpu")
    _eq(res.labels, tCr if tqr >= tqs else tCs, "max-quality pick")
    assert res.n_disconnected == 0
    return tqr, tqs, not torch.equal(tCr, tCs)


@pytest.mark.parametrize("family", sorted(GRAPHS))
def test_max_quality_pick_equals_reference(family):
    _check_pick(GRAPHS[family]())


# Near-tie probe (ring-of-cliques sizes and SBM seeds of the families
# above): different candidates whose modularities are equal in float32 or
# one ulp apart.  Found by ``scripts/torch_portfolio_probe.py``.
NEAR_TIES = {
    "ring_of_cliques(10, 3)": lambda: rg.ring_of_cliques(10, 3),
    "ring_of_cliques(13, 3)": lambda: rg.ring_of_cliques(13, 3),
    "ring_of_cliques(14, 3)": lambda: rg.ring_of_cliques(14, 3),
    "sbm seed 1": lambda: rg.sbm_graph(n_nodes=96, n_blocks=5, p_in=0.4,
                                       p_out=0.02, seed=1)[0],
    "sbm seed 8": lambda: rg.sbm_graph(n_nodes=96, n_blocks=5, p_in=0.4,
                                       p_out=0.02, seed=8)[0],
}


@pytest.mark.parametrize("case", sorted(NEAR_TIES))
def test_max_quality_near_tie_picks_as_reference(case):
    q_r, q_s, differ = _check_pick(NEAR_TIES[case]())
    assert differ and abs(q_r - q_s) < 1e-6, (q_r, q_s)


# Graphs where the reference's 'refine' returns one unconnected community,
# and so does its max-quality where it keeps the refined candidate (ROADMAP
# C.7); found by ``scripts/torch_portfolio_probe.py --unconnected``.
UNCONNECTED = {
    "rmat(10, ef=4, seed=3) standard/refine":
        (lambda: rg.rmat_graph(scale=10, edge_factor=4, seed=3),
         "standard", "refine"),
    "rmat(11, ef=4, seed=37) standard/refine":
        (lambda: rg.rmat_graph(scale=11, edge_factor=4, seed=37),
         "standard", "refine"),
    "rmat(11, ef=4, seed=37) max-quality":
        (lambda: rg.rmat_graph(scale=11, edge_factor=4, seed=37),
         "max-quality", "sp-pj"),
}


@pytest.mark.parametrize("case", sorted(UNCONNECTED))
def test_refine_splits_what_the_reference_leaves_unconnected(case):
    """The port's one departure from the reference: where the reference
    returns an unconnected community, the port returns the reference's
    labels with that community split into its connected pieces, so the
    tier keeps its zero-disconnected contract."""
    make, algorithm, split = UNCONNECTED[case]
    gj = make()
    res, ref = _both(gj, algorithm, split)
    assert int(ref.n_disconnected) == 1 and res.n_disconnected == 0
    tg = _port(gj)
    live = strip_padding(tg.src, tg.dst, tg.w, tg.ghost)
    pieces, _ = tcore.split_labels(*live, _t(ref.labels), mode="pj")
    want, _ = renumber(pieces, tg.node_mask(), tg.nv)
    assert torch.equal(res.labels, want)
    assert res.n_communities == int(ref.n_communities) + 1
    for k in ("passes", "li_last", "li_total"):
        assert res.stats[k] == int(ref.stats[k]), k
    assert res.stats["split_moved"] > int(ref.stats["split_moved"])
    assert res.modularity >= float(ref.modularity) - Q_ATOL


def test_tier_config_and_standard_candidate_match_reference():
    for split in SPLITS:
        cfg_t = tcore.LouvainConfig(split=split)
        cfg_j = jcore.LouvainConfig(split=split)
        for algorithm in tcore.ALGORITHMS:
            assert tcore.tier_config(algorithm, cfg_t).split == \
                jcore.tier_config(algorithm, cfg_j).split
        assert _standard_config(cfg_t).split == \
            ("sp-pj" if split == "refine" else split)
    with pytest.raises(ValueError):
        tcore.tier_config("best", tcore.LouvainConfig())


def test_max_quality_of_a_refine_config_compares_with_sp_pj():
    """max-quality given split='refine' pits refine against the paper's
    default, as the reference does."""
    gj = GRAPHS["rmat"]()
    res, ref = _both(gj, "max-quality", "refine")
    _eq(res.labels, ref.labels, "labels")
    assert res.stats == {k: int(v) for k, v in ref.stats.items()}


def test_phase_seconds_of_each_tier():
    g = _port(GRAPHS["grid"]())
    base = {"detector", "modularity"}
    want = {"fast": base | {"lpa"},
            "standard": base | {"local_move", "split", "aggregate", "other"},
            "max-quality": base | {"local_move", "split", "aggregate",
                                   "other", "select"}}
    for algorithm, keys in want.items():
        phases = {}
        tcore.detect(g, options=tcore.DetectOptions(algorithm=algorithm),
                     device="cpu", phase_seconds=phases)
        assert set(phases) == keys, algorithm
        assert all(v >= 0.0 for v in phases.values())
