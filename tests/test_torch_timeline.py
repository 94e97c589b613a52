"""Temporal tracking of the PyTorch port (``repro_torch.timeline``) held
against the JAX package's ``repro.timeline``, on the CPU.

* The id map, matcher, store and ``translate_window`` cases of
  tests/test_timeline.py, each also run through the reference where the
  two can be compared.
* ROADMAP C.9: the one-pass community cap evicts the reference's victims
  in the reference's order; a first snapshot of 2^17 communities ends in
  seconds (the reference's loop is quadratic there).
* A ``TimelineManager`` on each package's ``ResultStore`` commit hook
  (a detect put, then three windows of external-id events through
  ``translate_window``), with ``compact_window`` 0 and 4 and
  ``weight_by_degree`` both ways: ``state()`` arrays and meta, events,
  ``membership_at`` and ``timeline`` equal.
* The front-end cases of tests/test_timeline.py that need only a store
  and a tracker, through a holder object (the front end is ROADMAP A.11):
  the checkpoint round trip that resumes updates, store eviction keeping
  the timeline queryable, and three real compactions.  The planted
  lifecycle script, the async service, the empty-window and
  deferred-compaction service cases and the stream generators wait for
  the front end (A.11) and the event streams (A.13).
"""
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import _port

import repro.core as jcore
import repro.service as jservice
import repro.timeline as jt
from repro.data.streams import GraphEvent, graph_event_stream
from repro.graph import ring_of_cliques, sbm_graph
from repro.timeline import idmap as jidmap
import repro_torch.timeline as tt
from repro_torch.core.dynamic import GraphUpdate
from repro_torch.service import ResultStore
from repro_torch.timeline.idmap import ExternalIdMap, compose_batch_maps
from repro_torch.timeline.matcher import (
    LifecycleEvent, match_snapshots, weighted_jaccard,
)
from repro_torch.timeline.store import TimelineStore
from repro_torch.timeline.tracker import translate_window

from tests._hypothesis_compat import given, settings, st


# ---------------------------------------------------------------------------
# ExternalIdMap: the compaction contract in isolation
# ---------------------------------------------------------------------------

def _removal_map(n, removed):
    """UpdatePlan.id_map for removing ``removed``: survivors shift down."""
    alive = np.ones(n, bool)
    alive[list(removed)] = False
    shift = np.cumsum(alive) - 1
    return np.where(alive, shift, -1).astype(np.int64)


def _same_map(a, b):
    """Port and reference id maps in the same state."""
    (ea, na, ra), (eb, nb, rb) = a.state(), b.state()
    assert np.array_equal(ea, eb) and na == nb and np.array_equal(ra, rb)


def test_idmap_initial_identity_and_growth():
    m = ExternalIdMap(4)
    assert m.n_slots == 4 and m.n_live == 4
    assert [m.external_of(i) for i in range(4)] == [0, 1, 2, 3]
    fresh, retired = m.apply(None, 6)           # pure growth by 2
    assert fresh == [4, 5] and retired == []
    assert m.internal_of(4) == 4 and m.internal_of(5) == 5
    assert m.next_external == 6


def test_idmap_compaction_keeps_externals():
    m = ExternalIdMap(6)
    fresh, retired = m.apply(_removal_map(6, [1, 4]), 4)
    assert fresh == [] and retired == [1, 4]
    assert [m.internal_of(e) for e in (0, 2, 3, 5)] == [0, 1, 2, 3]
    assert m.internal_of(1) is None and m.is_retired(1)
    fresh, _ = m.apply(None, 5)                 # never a recycled id
    assert fresh == [6]
    assert m.retire_internal([0, 0]) == [0]
    with pytest.raises(KeyError):
        m.external_of(0)


def test_idmap_growth_with_lingering_tombstones_regression():
    for mod in (jidmap, None):
        m = (mod.ExternalIdMap if mod else ExternalIdMap)(6)
        m.retire_internal([1, 3])
        assert m.externals().tolist() == [0, -1, 2, -1, 4, 5]
        fresh, retired = m.apply(None, 8, fresh_ids=[100, 101])
        assert fresh == [100, 101] and retired == []
        assert m.internal_of(100) == 6 and m.internal_of(101) == 7
        assert m.externals().tolist() == [0, -1, 2, -1, 4, 5, 100, 101]
        assert m.is_retired(1) and m.is_retired(3)


def test_idmap_tombstone_survives_remap_not_fresh():
    m = ExternalIdMap(6)
    m.retire_internal([3])
    fresh, retired = m.apply(_removal_map(6, [5]), 5)
    assert fresh == [] and retired == [5]
    assert m.externals().tolist() == [0, 1, 2, -1, 4]
    assert m.is_retired(3)


def test_idmap_fresh_binding_rejected_wholesale_on_collision():
    m = ExternalIdMap(4)
    m.retire_internal([0])
    m.apply(_removal_map(4, [0]), 3)
    fresh, _ = m.apply(None, 5, fresh_ids=[0, 99])
    assert fresh == [4, 5]
    assert m.internal_of(0) is None and m.internal_of(99) is None


def test_idmap_state_roundtrip():
    m = ExternalIdMap(5)
    m.retire_internal([2])
    m.apply(None, 6, fresh_ids=[41])
    m2 = ExternalIdMap.from_state(*m.state())
    assert m2.externals().tolist() == m.externals().tolist()
    assert m2.next_external == m.next_external and m2.is_retired(2)
    assert m2.internal_of(41) == m.internal_of(41)
    _same_map(m2, jidmap.ExternalIdMap.from_state(*m.state()))


def test_compose_batch_maps_matches_the_reference():
    rng = np.random.default_rng(4)
    n = 40
    batches = []
    for _ in range(4):
        rem = np.sort(rng.choice(n, 3, replace=False))
        add = int(rng.integers(0, 4))
        batches.append(dict(u=np.empty(0, np.int32), v=np.empty(0, np.int32),
                            dw=np.empty(0, np.float32), add=add, remove=rem))
        n += add - 3
    got, n_got = compose_batch_maps(40, [GraphUpdate(**b) for b in batches])
    want, n_want = jidmap.compose_batch_maps(
        40, [jcore.GraphUpdate(**b) for b in batches])
    assert n_got == n_want == n and np.array_equal(got, want)
    # the reference test's hand-computed case
    two = [GraphUpdate(add=2, remove=np.asarray([1])),
           GraphUpdate(add=1, remove=np.asarray([0, 4]))]
    id_map, n_final = compose_batch_maps(4, two)
    assert n_final == 4 and id_map.tolist() == [-1, -1, 0, 1]
    with pytest.raises(ValueError):
        compose_batch_maps(3, [GraphUpdate(remove=np.asarray([5]))])


def _rounds(m_port, m_ref, ops):
    """Apply the same removal/addition rounds to both maps, holding them
    equal after each, and the stability contract on the port's."""
    n = m_port.n_slots
    alive = {e: i for i, e in enumerate(m_port.externals().tolist())}
    ever = set(alive)
    for internals, n_add in ops:
        internals = sorted({i for i in internals if i < n})[:max(n - 1, 0)]
        removed = {e for e, i in alive.items() if i in internals}
        id_map = _removal_map(n, internals) if internals else None
        n_new = n - len(internals) + n_add
        fresh, retired = m_port.apply(id_map, n_new)
        assert (fresh, retired) == m_ref.apply(id_map, n_new)
        _same_map(m_port, m_ref)
        assert set(retired) == removed
        shift = id_map if id_map is not None else np.arange(n_new)
        alive = {e: int(shift[i]) for e, i in alive.items()
                 if e not in removed}
        for e, i in alive.items():
            assert m_port.internal_of(e) == i
        assert not set(fresh) & ever               # never reused
        ever.update(fresh)
        alive.update({f: n - len(internals) + j for j, f in enumerate(fresh)})
        n = n_new


def test_idmap_stability_across_three_compaction_rounds():
    rng = np.random.default_rng(3)
    ops = [(rng.choice(16, size=int(rng.integers(1, 4)),
                       replace=False).tolist(), int(rng.integers(0, 3)))
           for _ in range(5)]
    _rounds(ExternalIdMap(16), jidmap.ExternalIdMap(16), ops)


@settings(max_examples=25, deadline=None)
@given(st.lists(
    st.tuples(st.lists(st.integers(0, 30), min_size=0, max_size=4),
              st.integers(0, 3)),
    min_size=3, max_size=8))
def test_idmap_stability_property(ops):
    _rounds(ExternalIdMap(8), jidmap.ExternalIdMap(8), ops)


# ---------------------------------------------------------------------------
# matcher: lifecycle decisions at one window boundary
# ---------------------------------------------------------------------------

def _mem(*ids, w=1.0):
    return {int(i): float(w) for i in ids}


def _minter():
    counter = [100]

    def mint():
        counter[0] += 1
        return counter[0]
    return mint


def _match(prev, new, **kw):
    """The port's match, held equal to the reference's on the same
    input."""
    kw.setdefault("t", 1.0)
    kw.setdefault("graph_id", "g")
    got = match_snapshots(prev, new, next_id=_minter(), **kw)
    want = jt.match_snapshots(prev, new, next_id=_minter(), **kw)
    assert got[0] == want[0]
    assert [e.__dict__ for e in got[1]] == [e.__dict__ for e in want[1]]
    return got


def test_weighted_jaccard():
    assert weighted_jaccard({}, {}) == 0.0
    assert weighted_jaccard(_mem(1, 2), _mem(3, 4)) == 0.0
    assert weighted_jaccard(_mem(1, 2), _mem(1, 2)) == 1.0
    a, b = {1: 2.0, 2: 1.0}, {1: 1.0, 3: 1.0}
    assert weighted_jaccard(a, b) == pytest.approx(1.0 / 4.0)
    assert weighted_jaccard(a, b) == jt.weighted_jaccard(a, b)


def test_match_empty_window_is_all_continuations():
    prev = {0: _mem(1, 2, 3), 1: _mem(4, 5, 6)}
    assigned, events = _match(prev, [_mem(1, 2, 3), _mem(4, 5, 6)])
    assert sorted(assigned) == [0, 1]
    assert all(e.kind == "continuation" and e.overlap == 1.0 for e in events)


def test_match_merge():
    prev = {0: _mem(*range(0, 8)), 1: _mem(*range(8, 16))}
    assigned, events = _match(prev, [_mem(*range(0, 16))])
    assert assigned == [0]
    (ev,) = [e for e in events if e.kind == "merge"]
    assert ev.community == 0 and ev.parents == (1,)


def test_match_split():
    prev = {7: _mem(*range(0, 8))}
    assigned, events = _match(prev, [_mem(*range(0, 5)), _mem(*range(5, 8))])
    assert assigned[0] == 7 and assigned[1] > 100
    (ev,) = [e for e in events if e.kind == "split"]
    assert ev.community == assigned[1] and ev.parents == (7,)


def test_match_simultaneous_merge_and_split():
    prev = {0: _mem(*range(0, 8)), 1: _mem(*range(8, 16)),
            2: _mem(*range(16, 24))}
    new = [_mem(*range(0, 16)), _mem(*range(16, 20)), _mem(*range(20, 24))]
    assigned, events = _match(prev, new)
    assert sorted(e.kind for e in events) == ["continuation", "merge",
                                              "split"]
    assert next(e for e in events if e.kind == "merge").parents == (1,)
    assert next(e for e in events if e.kind == "split").parents == (2,)
    assert 2 in assigned


def test_match_total_removal_is_death():
    prev = {5: _mem(1, 2, 3), 6: _mem(7, 8, 9)}
    assigned, events = _match(prev, [_mem(7, 8, 9)])
    assert assigned == [6]
    (death,) = [e for e in events if e.kind == "death"]
    assert death.community == 5 and death.size == 0


def test_match_birth_no_overlap():
    prev = {0: _mem(1, 2, 3)}
    assigned, events = _match(prev, [_mem(1, 2, 3), _mem(50, 51, 52)])
    assert assigned[0] == 0 and assigned[1] > 100
    (birth,) = [e for e in events if e.kind == "birth"]
    assert birth.community == assigned[1] and birth.size == 3


def test_match_deterministic_under_input_order():
    prev = {0: _mem(*range(0, 6)), 1: _mem(*range(6, 12))}
    new = [_mem(*range(0, 6)), _mem(*range(6, 12))]
    a1, e1 = _match(prev, new)
    a2, e2 = _match(dict(reversed(list(prev.items()))), new)
    assert a1 == a2 and e1 == e2


def test_match_jaccard_min_gates_relation():
    prev = {0: _mem(*range(0, 10))}
    assigned, events = _match(prev, [_mem(0, *range(100, 109))],
                              jaccard_min=0.1)
    assert sorted(e.kind for e in events) == ["birth", "death"]
    assert assigned[0] > 100


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_random_partitions_equal_the_reference(seed):
    """Weighted random re-partitions (ties included): the same ids,
    events, overlaps and order as the reference."""
    rng = np.random.default_rng(seed)
    n = 400
    w = rng.integers(1, 4, n).astype(float)
    old = rng.integers(0, 30, n)
    new = np.where(rng.random(n) < 0.3, rng.integers(0, 35, n), old)
    prev = {}
    for v in range(n):
        prev.setdefault(int(old[v]) * 3 + 1, {})[v] = float(w[v])
    groups = {}
    for v in range(n):
        if rng.random() < 0.95:
            groups.setdefault(int(new[v]), {})[v] = float(w[v])
    seen = []
    _match(prev, [groups[k] for k in sorted(groups)], jaccard_min=0.05,
           on_overlap=seen.append)
    assert seen


# ---------------------------------------------------------------------------
# TimelineStore: bisect semantics, every retention bound, the cap (C.9)
# ---------------------------------------------------------------------------

def _snap(store, gid, t, groups, events=()):
    store.record_snapshot(gid, t, [(cid, _mem(*mem)) for cid, mem in groups],
                          list(events))


def test_store_membership_bisect_semantics():
    s = TimelineStore()
    _snap(s, "g", 1.0, [(0, (1, 2)), (1, (3,))])
    _snap(s, "g", 2.0, [(0, (1,)), (1, (2, 3))])
    assert s.membership_at("g", 2, 0.5) is None
    assert s.membership_at("g", 2, 1.0) == 0
    assert s.membership_at("g", 2, 1.7) == 0
    assert s.membership_at("g", 2, 2.0) == 1
    assert s.membership_at("g", 2, 99.0) == 1
    assert s.membership_at("g", 2) == 1
    assert s.membership_at("g", 42, 1.5) is None
    assert s.membership_at("nope", 1) is None


def test_store_snapshot_retention_rolls_off():
    s = TimelineStore(max_snapshots=2)
    for t in (1.0, 2.0, 3.0):
        _snap(s, "g", t, [(0, (1,))])
    assert [x.t for x in s.snapshots("g")] == [2.0, 3.0]
    assert s.membership_at("g", 1, 1.0) is None
    assert s.n_snapshots == 3


def test_store_row_and_event_bounds():
    s = TimelineStore(max_rows=2, max_events=3)
    for t in (1.0, 2.0, 3.0, 4.0):
        _snap(s, "g", t, [(0, (1, 2))],
              [LifecycleEvent("continuation", t, "g", 0, size=2)])
    tl = s.timeline(0)
    assert len(tl.rows) == 2 and tl.rows[-1][0] == 4.0
    assert len(s.lifecycle_events("g")) == 3 and s.n_events == 4
    with pytest.raises(ValueError):
        TimelineStore(max_rows=0)
    with pytest.raises(ValueError):
        LifecycleEvent("rename", 0.0, "g", 0)


def test_store_community_cap_evicts_dead_first():
    s = TimelineStore(max_communities=2)
    _snap(s, "g", 1.0, [(0, (1,)), (1, (2,))],
          [LifecycleEvent("death", 1.0, "g", 0)])
    _snap(s, "g", 2.0, [(1, (2,)), (2, (3,))])
    assert s.timeline(0) is None
    assert s.timeline(1) is not None and s.timeline(2) is not None
    assert s.n_truncated_communities == 1


def test_store_drop_graph_scopes_by_graph():
    s = TimelineStore()
    _snap(s, "a", 1.0, [(0, (1,))], [LifecycleEvent("birth", 1.0, "a", 0,
                                                    size=1)])
    _snap(s, "b", 1.0, [(1, (1,))], [LifecycleEvent("birth", 1.0, "b", 1,
                                                    size=1)])
    assert s.drop_graph("a") == 1
    assert s.snapshots("a") == [] and s.timeline(0) is None
    assert s.lifecycle_events("a") == []
    assert len(s.snapshots("b")) == 1 and s.timeline(1) is not None


def _cap_script(seed):
    """Five snapshots of up to 600 communities a graph, two graphs: ids
    carried, born and killed at random, with death and split events."""
    rng = np.random.default_rng(seed)
    live = list(range(600))
    nxt = 600
    script = []
    for t in range(5):
        gid = "ab"[t % 2]
        dead = sorted(rng.choice(live, 40, replace=False).tolist())
        live = [c for c in live if c not in set(dead)]
        born = list(range(nxt, nxt + 50))
        nxt += 50
        live += born
        order = rng.permutation(live).tolist()
        members = [(c, _mem(*range(3 * c, 3 * c + 1 + c % 3))) for c in order]
        events = ([LifecycleEvent("death", float(t), gid, c) for c in dead]
                  + [LifecycleEvent("birth" if c % 2 else "split", float(t),
                                    gid, c, parents=(c - 1,)) for c in born])
        script.append((gid, float(t), members, events))
    return script


@pytest.mark.parametrize("seed", [0, 1])
def test_store_cap_evicts_the_reference_victims(seed):
    """C.9: the one-pass cap leaves the reference's timelines, in its
    order, with the same truncation count, after every snapshot."""
    port = TimelineStore(max_communities=256)
    ref = jt.TimelineStore(max_communities=256)
    for gid, t, members, events in _cap_script(seed):
        for s in (port, ref):
            s.record_snapshot(gid, t, members, events)
        assert list(port._comms) == list(ref._comms)
        assert port.n_truncated_communities == ref.n_truncated_communities
        for cid, tl in port._comms.items():
            r = ref._comms[cid]
            assert (tl.dead_t, tl.born_t, tl.parents, tl.origin,
                    list(tl.rows)) == (r.dead_t, r.born_t, r.parents,
                                       r.origin, list(r.rows))
    assert port.n_truncated_communities > 600


def test_store_cap_first_snapshot_is_linear():
    """2^17 communities at a first snapshot (every one alive): the
    reference's loop rescans the whole dict for each victim; the port's
    pass ends within seconds."""
    n = 1 << 17
    s = TimelineStore()
    members = [(c, {2 * c: 1.0, 2 * c + 1: 1.0}) for c in range(n)]
    events = [LifecycleEvent("birth", 0.0, "g", c, size=2) for c in range(n)]
    t0 = time.perf_counter()
    s.record_snapshot("g", 0.0, members, events)
    assert time.perf_counter() - t0 < 10.0
    assert len(s._comms) == 4096
    assert list(s._comms)[0] == n - 4096 and s.n_truncated_communities == \
        n - 4096
    assert s.membership_at("g", 7) == 3


# ---------------------------------------------------------------------------
# translate_window: window folding + the id-contract mirror
# ---------------------------------------------------------------------------

def _entry(n, n_cap=None, deferred=None):
    return SimpleNamespace(
        graph=SimpleNamespace(n_nodes=n, n_cap=n_cap or n + 8),
        deferred=(None if deferred is None
                  else np.asarray(deferred, np.int64)))


def _translate(evs, idmap_args, entry, **kw):
    """The port's translation, held equal to the reference's."""
    n, retire = idmap_args
    maps = []
    for cls in (ExternalIdMap, jidmap.ExternalIdMap):
        m = cls(n)
        m.retire_internal(retire)
        maps.append(m)
    got = translate_window(evs, idmap=maps[0], entry=entry, **kw)
    want = jt.translate_window(evs, idmap=maps[1], entry=entry, **kw)
    for name in ("u", "v", "dw", "remove"):
        a, b = np.asarray(getattr(got[0], name)), np.asarray(
            getattr(want[0], name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got[0].add == want[0].add and got[1] == want[1]
    return got


def test_translate_add_then_del_cancels_with_edges():
    evs = [GraphEvent(0.1, "vertex_add", u=10),
           GraphEvent(0.2, "edge_add", u=10, v=1, w=1.0),
           GraphEvent(0.3, "vertex_del", u=10)]
    upd, stats = _translate(evs, (4, []), _entry(4))
    assert upd.add == 0 and upd.remove.size == 0 and upd.u.size == 0
    assert stats["dropped_edges"] == 1 and stats["adds_ext"] == []


def test_translate_net_zero_edge_folds_away():
    evs = [GraphEvent(0.1, "edge_add", u=0, v=1, w=2.0),
           GraphEvent(0.2, "edge_del", u=0, v=1, w=2.0),
           GraphEvent(0.3, "edge_add", u=2, v=3, w=1.5)]
    upd, _ = _translate(evs, (4, []), _entry(4))
    assert upd.u.tolist() == [2] and upd.v.tolist() == [3]
    assert upd.dw.tolist() == [1.5]


def test_translate_immediate_mode_shifts_ids():
    evs = [GraphEvent(0.1, "vertex_del", u=1),
           GraphEvent(0.2, "edge_add", u=4, v=5, w=1.0),
           GraphEvent(0.3, "vertex_add", u=60)]
    upd, stats = _translate(evs, (6, []), _entry(6))
    assert upd.remove.tolist() == [1]
    assert (upd.u.tolist(), upd.v.tolist()) == ([3], [4])
    assert upd.add == 1 and stats["adds_ext"] == [60]
    assert stats["flush_predicted"] is False


def test_translate_deferred_mode_keeps_ids_and_mirrors_flush():
    evs = [GraphEvent(0.1, "vertex_del", u=1),
           GraphEvent(0.2, "edge_add", u=4, v=5, w=1.0),
           GraphEvent(0.3, "vertex_add", u=60)]
    upd, stats = _translate(evs, (6, []), _entry(6), compact_window=4)
    assert (upd.u.tolist(), upd.v.tolist()) == ([4], [5])
    assert upd.add == 1 and stats["flush_predicted"] is False
    upd2, stats2 = _translate([GraphEvent(0.1, "edge_add", u=4, v=5, w=1.0)],
                              (6, [0]), _entry(6, deferred=[0]),
                              compact_window=1)
    assert stats2["flush_predicted"] is True
    assert (upd2.u.tolist(), upd2.v.tolist()) == ([3], [4])


def test_translate_drops_unknown_and_retired_references():
    evs = [GraphEvent(0.1, "edge_add", u=0, v=99, w=1.0),
           GraphEvent(0.2, "edge_add", u=0, v=2, w=1.0),
           GraphEvent(0.3, "vertex_del", u=2),
           GraphEvent(0.4, "vertex_add", u=2)]
    upd, stats = _translate(evs, (4, [2]), _entry(4, deferred=[2]),
                            compact_window=8)
    assert upd.u.size == 0 and upd.add == 0 and upd.remove.size == 0
    assert stats["dropped_edges"] == 2 and stats["dropped_vertices"] == 2
    with pytest.raises(ValueError):
        translate_window([SimpleNamespace(kind="rename", u=0, v=0, w=0.0)],
                         idmap=ExternalIdMap(4), entry=_entry(4))


# ---------------------------------------------------------------------------
# a TimelineManager on each package's ResultStore commit hook
# ---------------------------------------------------------------------------

GRAPHS = {
    "ring": lambda: ring_of_cliques(n_cliques=6, clique_size=6, n_cap=64,
                                    m_cap=512),
    "sbm": lambda: sbm_graph(n_nodes=60, n_blocks=4, p_in=0.35, p_out=0.03,
                             seed=3, n_cap=96, m_cap=1024)[0],
}
MIX = (("edge_add", 0.35), ("edge_del", 0.15), ("vertex_add", 0.2),
       ("vertex_del", 0.3))


def _windows(gj, n_windows=3, seed=7, rate=12.0):
    out = [[] for _ in range(n_windows)]
    for e in graph_event_stream(gj, rate=rate, seed=seed, mix=MIX,
                                min_vertices=12):
        if e.t >= n_windows:
            break
        out[int(e.t)].append(e)
    return out


class Service:
    """One package's store and tracker, driven as the front end drives
    them: a detect put, then windows of external-id events through
    ``translate_window`` (the front end is ROADMAP A.11)."""

    def __init__(self, port, *, cw=0, wbd=False, max_entries=None):
        T = tt if port else jt
        self.port, self.cw, self.T = port, cw, T
        self.timelines = T.TimelineManager(
            T.TimelineConfig(weight_by_degree=wbd), clock=lambda: -1.0)
        kw = dict(compact_window=cw, max_entries=max_entries,
                  on_commit=self.timelines.observe_commit)
        self.store = (ResultStore(device="cpu", **kw) if port
                      else jservice.ResultStore(**kw))

    def put(self, gid, gj, det, t=0.0):
        self.timelines.set_time(gid, t)
        self.store.put(gid, _port(gj) if self.port else gj,
                       np.asarray(det.labels), n_communities=det.n_communities,
                       n_disconnected=det.n_disconnected, q=det.modularity)

    def ingest(self, gid, events, t):
        entry = self.store.get(gid)
        idmap = self.timelines.ensure_track(gid, int(entry.graph.n_nodes))
        upd, stats = self.T.translate_window(events, idmap=idmap, entry=entry,
                                             compact_window=self.cw)
        self.timelines.set_time(gid, t)
        if stats["adds_ext"]:
            self.timelines.register_pending_adds(gid, stats["adds_ext"])
        return self.store.apply_update(gid, upd)


def _same_state(a, b):
    """Two managers' ``state()``: the same arrays (dtype and bits) and
    meta."""
    (aa, am), (ba, bm) = a.state(), b.state()
    assert am == bm
    assert list(aa) == list(ba)
    for k in aa:
        assert aa[k].dtype == ba[k].dtype and np.array_equal(aa[k], ba[k]), k


def _same_queries(a, b, gid, times):
    """Events, memberships at each time and community rows equal."""
    assert [e.__dict__ for e in a.lifecycle_events()] == \
        [e.__dict__ for e in b.lifecycle_events()]
    exts = sorted({int(e) for s in b.snapshots(gid) for e in s.ext})
    for t in list(times) + [None]:
        assert [a.membership_at(gid, e, t) for e in exts + [10**6]] == \
            [b.membership_at(gid, e, t) for e in exts + [10**6]], t
    for tl in b.communities(gid):
        mine = a.timeline(tl.cid)
        assert (mine.born_t, mine.dead_t, mine.parents, mine.origin,
                list(mine.rows)) == (tl.born_t, tl.dead_t, tl.parents,
                                     tl.origin, list(tl.rows))
    assert [x.cid for x in a.communities(gid, alive_only=True)] == \
        [x.cid for x in b.communities(gid, alive_only=True)]


@pytest.mark.parametrize("wbd", [False, True])
@pytest.mark.parametrize("cw", [0, 4])
@pytest.mark.parametrize("family", sorted(GRAPHS))
def test_manager_on_the_commit_hook_equals_the_reference(family, cw, wbd):
    gj = GRAPHS[family]()
    det = jcore.detect(gj)
    port, ref = Service(True, cw=cw, wbd=wbd), Service(False, cw=cw, wbd=wbd)
    for svc in (port, ref):
        svc.put("g", gj, det)
    for i, evs in enumerate(_windows(gj)):
        a, b = port.ingest("g", evs, float(i + 1)), ref.ingest(
            "g", evs, float(i + 1))
        np.testing.assert_array_equal(a.C, np.asarray(b.C))
        np.testing.assert_array_equal(a.deferred, np.asarray(b.deferred))
        assert a.n_disconnected == b.n_disconnected == 0
    tp, tr = port.timelines, ref.timelines
    _same_state(tp, tr)
    _same_queries(tp, tr, "g", [0.0, 0.5, 1.0, 2.0, 2.5, 3.0])
    assert tp.n_snapshots == 4 and tp.n_lifecycle == tr.n_lifecycle
    assert tp.n_idmap_resets == tp.n_binding_mismatches == 0
    assert np.array_equal(tp.external_ids("g"), tr.external_ids("g"))


def test_subscribers_and_telemetry_see_each_commit():
    from repro_torch.telemetry import InMemorySink, Telemetry

    tel = Telemetry()
    sink = tel.register(InMemorySink())
    tm = tt.TimelineManager(telemetry=tel, clock=lambda: 5.0)
    seen = []
    tm.subscribe(seen.extend)
    bad = tm.subscribe(lambda evs: 1 / 0)
    gj = ring_of_cliques(n_cliques=3, clique_size=4)
    det = jcore.detect(gj)
    store = ResultStore(device="cpu", on_commit=tm.observe_commit)
    store.put("g", _port(gj), np.asarray(det.labels),
              n_communities=det.n_communities, n_disconnected=0,
              q=det.modularity)
    assert [e.kind for e in seen] == ["birth"] * 3 and seen[0].t == 5.0
    assert tm.n_subscriber_errors == 1 and tm.unsubscribe(bad)
    assert not tm.unsubscribe(bad)
    assert sink.counter_value("timeline_snapshots") == 1
    assert sink.counter_value("timeline_events", {"kind": "birth"}) == 3
    assert tm.internal_of("g", 5) == 5 and tm.internal_of("x", 5) is None
    with pytest.raises(ValueError):
        tt.TimelineConfig(jaccard_min=0.0)


# ---------------------------------------------------------------------------
# the store-and-tracker cases of the service tests, through a holder
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_preserves_membership_and_resumes():
    gj = GRAPHS["sbm"]()
    det = jcore.detect(gj)
    wins = _windows(gj, n_windows=4, seed=11)
    svc, svc2 = Service(True, cw=4), Service(True, cw=4)
    svc.put("g", gj, det)
    for i, evs in enumerate(wins[:3]):
        svc.ingest("g", evs, float(i + 1))
    with tempfile.TemporaryDirectory() as d:
        step = tt.save_service_checkpoint(svc, d)
        assert tt.restore_service_checkpoint(svc2, d) == step
    s1, s2 = svc.timelines.snapshots("g"), svc2.timelines.snapshots("g")
    assert len(s1) == len(s2) == 4
    for a, b in zip(s1, s2):
        assert a.t == b.t and np.array_equal(a.ext, b.ext) \
            and np.array_equal(a.cid, b.cid) \
            and (a.n_communities, a.n_disconnected) == (b.n_communities,
                                                        b.n_disconnected)
    _same_state(svc2.timelines, svc.timelines)
    _same_queries(svc2.timelines, svc.timelines, "g",
                  [s.t for s in s1] + [1.5, 2.5, 99.0])
    e1, e2 = svc.store.get("g"), svc2.store.get("g")
    assert e1.version == e2.version and np.array_equal(e1.C, e2.C)
    assert np.array_equal(e1.deferred, e2.deferred)
    for k in ("src", "dst", "w", "n_nodes"):
        assert np.array_equal(getattr(e1.graph, k).numpy(),
                              getattr(e2.graph, k).numpy())
    # both resume the warm path from the saved version, identically
    for s in (svc, svc2):
        s.ingest("g", wins[3], 4.0)
    assert len(svc2.timelines.snapshots("g")) == 5
    assert svc2.store.get("g").n_disconnected == 0
    _same_state(svc2.timelines, svc.timelines)


def test_service_checkpoint_reads_across_packages():
    """A service checkpoint written by either package restores in the
    other to the same store entry and tracker state."""
    gj = GRAPHS["ring"]()
    det = jcore.detect(gj)
    wins = _windows(gj, n_windows=2, seed=5)
    port, ref = Service(True, cw=4), Service(False, cw=4)
    for svc in (port, ref):
        svc.put("g", gj, det)
        for i, evs in enumerate(wins):
            svc.ingest("g", evs, float(i + 1))
    with tempfile.TemporaryDirectory() as d:
        jt.save_service_checkpoint(ref, d, step=0)
        tt.save_service_checkpoint(port, d, step=1)
        from_ref, from_port = Service(True, cw=4), Service(False, cw=4)
        assert tt.restore_service_checkpoint(from_ref, d, step=0) == 0
        assert jt.restore_service_checkpoint(from_port, d, step=1) == 1
    _same_state(from_ref.timelines, ref.timelines)
    _same_state(from_port.timelines, port.timelines)
    a, b = from_ref.store.get("g"), ref.store.get("g")
    assert a.version == b.version and np.array_equal(a.C, np.asarray(b.C))
    assert np.array_equal(a.graph.src.numpy(), np.asarray(b.graph.src))


def test_restore_rejects_another_kind_and_missing_keys(tmp_path):
    from repro_torch.checkpoint import CheckpointCorrupt, save_checkpoint

    holder = Service(True)
    assert tt.restore_service_checkpoint(holder, str(tmp_path / "no")) is None
    save_checkpoint(str(tmp_path), 0, {"x": np.zeros(1)}, extra={"kind": "x"})
    with pytest.raises(ValueError, match="not a timeline-service"):
        tt.restore_service_checkpoint(holder, str(tmp_path))
    save_checkpoint(str(tmp_path), 1, {"x": np.zeros(1)}, extra=dict(
        kind="timeline-service", graphs=[dict(index=0, graph_id="g")]))
    with pytest.raises(CheckpointCorrupt):
        tt.restore_service_checkpoint(holder, str(tmp_path))


def test_store_eviction_keeps_timeline_queryable():
    svc = Service(True, max_entries=2)
    for i in range(3):
        gj = ring_of_cliques(n_cliques=3, clique_size=5)
        svc.put(f"g{i}", gj, jcore.detect(gj), t=float(i))
    assert svc.store.get("g0") is None and svc.store.n_evicted == 1
    tl = svc.timelines
    assert len(tl.snapshots("g0")) == 1
    assert tl.membership_at("g0", 0) is not None
    assert tl.lifecycle_events("g0")
    assert tl.drop_graph("g0") == 1
    assert tl.snapshots("g0") == [] and tl.membership_at("g0", 0) is None
    assert tl.membership_at("g2", 0) is not None


def test_external_ids_stable_across_three_real_compactions():
    """Immediate mode: each window removes two low internal ids, so every
    surviving internal shifts every round; external ids never notice."""
    gj = ring_of_cliques(n_cliques=4, clique_size=6)
    svc = Service(True)
    svc.put("g", gj, jcore.detect(gj))
    doomed = [(0, 1), (2, 3), (4, 5)]
    for i, pair in enumerate(doomed):
        svc.ingest("g", [GraphEvent(i + 0.5, "vertex_del", u=x)
                         for x in pair], float(i + 1))
    gone = {x for pair in doomed for x in pair}
    tl = svc.timelines
    ext = tl.external_ids("g")
    assert sorted(ext.tolist()) == sorted(set(range(24)) - gone)
    for x in sorted(set(range(24)) - gone):
        assert tl.membership_at("g", x) is not None
    for x in gone:
        assert tl.membership_at("g", x) is None
        assert tl.internal_of("g", x) is None
    assert len(tl.snapshots("g")) == 4
    assert all(s.n_disconnected == 0 for s in tl.snapshots("g"))
