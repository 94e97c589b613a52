"""The dense scan of the PyTorch port (``scan='dense'``) held against the JAX
package and against the port's own sortscan, on the CPU: the dense
half-sweep, the dense split, the aggregate the dense scan calls (the
sort formulation, held to the reference's dense impl), and the
dense-vs-sortscan crossover that ``detect()`` consults for
``scan='auto'``.

Everything is compared bit for bit except the half-sweep's ``gain``, a
flat float32 sum that neither package feeds to a decision (the reference's
``jnp.sum``, the port's ``torch.sum``).  The reference's dense scan fills
its matrices with scatter-adds that follow edge order on XLA's CPU backend;
the port places the sortscan's in-order run sums instead, so equal bits
here show that the two formulations agree.
"""
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import GRAPHS, _eq, _louvain_membership, _port, \
    _sweep_inputs, _t

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import _segments as jseg
from repro.core.aggregate import aggregate as j_aggregate
from repro.core.detect import disconnected_communities as j_disconnected
from repro.core.local_move import _half_sweep_dense as j_half_sweep_dense
from repro.core.split import split_labels as j_split
from repro.service.buckets import choose_scan as j_choose_scan
from repro_torch.core import _segments as tseg
from repro_torch.core import portfolio as tportfolio
from repro_torch.core.aggregate import aggregate as t_aggregate
from repro_torch.core.detect import disconnected_communities as t_disconnected
from repro_torch.core.local_move import _half_sweep as t_half_sweep
from repro_torch.core.local_move import _half_sweep_dense as t_half_sweep_dense
from repro_torch.core.local_move import dense_adjacency
from repro_torch.core.split import split_labels as t_split
from repro_torch.service import buckets as tbuckets

SWEEP_CASES = [(True, True, False), (False, True, False),
               (False, False, False), (True, True, True)]


@pytest.mark.parametrize("target,anchored,zero_weights", SWEEP_CASES,
                         ids=["handshake", "parity", "all", "refine-masked"])
@pytest.mark.parametrize("seed", [5, 6])
def test_half_sweep_dense_bitwise_equals_reference(seed, target, anchored,
                                                   zero_weights):
    """One dense half-sweep on a seeded random state against the
    reference's ``_half_sweep_dense`` (``owned=None``) and the port's
    sortscan.  ``refine-masked`` zeroes the cross-community weights as
    refine does: those runs exist with a zero sum and are no candidates."""
    g, C, K, Sigma, movable, target_ok = _sweep_inputs(seed)
    w = np.asarray(g.w)
    if zero_weights:
        src, dst = np.asarray(g.src), np.asarray(g.dst)
        w = np.where(C[src] == C[dst], w, 0.0).astype(np.float32)
    two_m = jnp.sum(g.w)
    jt = jnp.asarray(target_ok) if target else None
    want = j_half_sweep_dense(g.src, g.dst, jnp.asarray(w), jnp.asarray(C),
                              jnp.asarray(K), jnp.asarray(Sigma), two_m, None,
                              jnp.asarray(movable), None, target_ok=jt,
                              anchored=anchored)
    tg = _port(g)
    args = (tg.src, tg.dst, _t(w), _t(C), _t(K), _t(Sigma),
            tg.total_weight_2m(), _t(movable))
    kw = dict(target_ok=_t(target_ok) if target else None, anchored=anchored)
    got = t_half_sweep_dense(*args, **kw)
    sort = t_half_sweep(*args, **kw)
    assert float(tg.total_weight_2m()) == float(two_m)
    for name, a, b, s in zip(("C", "Sigma", "moved", "gain", "want"), got,
                             want, sort):
        if name == "gain":   # a flat float32 sum that decides nothing
            assert abs(float(a) - float(b)) <= 1e-6 * max(1.0, abs(float(b)))
        else:
            _eq(a, b, name)
            _eq(a, s.numpy(), f"{name} (dense vs the port's sortscan)")
    if zero_weights:
        assert bool(got[1].isfinite().all())


@pytest.mark.parametrize("shared_adj", [False, True],
                         ids=["own-adjacency", "shared-adjacency"])
@pytest.mark.parametrize("mode", ["pj", "lp", "lpp"])
def test_split_labels_dense_equal(mode, shared_adj):
    gj = GRAPHS["rmat"]()
    C = _louvain_membership(gj)
    tg = _port(gj)
    j_adj = (jnp.zeros((gj.nv, gj.nv), bool).at[gj.src, gj.dst].set(True)
             if shared_adj else None)
    t_adj = dense_adjacency(tg.src, tg.dst, tg.nv) if shared_adj else None
    Lj, itj = j_split(gj.src, gj.dst, gj.w, jnp.asarray(C), mode=mode,
                      impl="dense", adj=j_adj)
    Lt, itt = t_split(tg.src, tg.dst, tg.w, _t(C), mode=mode, impl="dense",
                      adj=t_adj)
    Lc, itc = t_split(tg.src, tg.dst, tg.w, _t(C), mode=mode)
    _eq(Lt, Lj, f"labels ({mode})")
    _eq(Lt, Lc.numpy(), f"labels ({mode}, dense vs coo)")
    assert itt == int(itj) == itc


@pytest.mark.parametrize("family", ["sbm", "rmat", "grid"])
def test_aggregate_dense_equal(family):
    gj = GRAPHS[family]()
    C = _louvain_membership(gj)
    nv = gj.nv
    valid = np.arange(nv) < int(gj.n_nodes)
    Cd_j, _ = jseg.renumber(jnp.asarray(C), jnp.asarray(valid), nv)
    Cd_t, _ = tseg.renumber(_t(C), _t(valid), nv)
    want = j_aggregate(gj.src, gj.dst, gj.w, Cd_j, impl="dense")
    want_sort = j_aggregate(gj.src, gj.dst, gj.w, Cd_j, impl="sort")
    tg = _port(gj)
    got = t_aggregate(tg.src, tg.dst, tg.w, Cd_t)
    for name, a, b, s in zip(("src", "dst", "w"), got, want, want_sort):
        _eq(a, b, f"super-edge {name} (port vs reference dense)")
        _eq(a, s, f"super-edge {name} (port vs reference sort)")


def test_disconnected_communities_dense_equal():
    """The detector with the dense fixpoint flags the same communities."""
    gj = GRAPHS["grid"]()
    nv = gj.nv
    C = (np.arange(nv) % 5).astype(np.int32)   # stripes: disconnected
    C[nv - 1] = nv - 1
    want = j_disconnected(gj.src, gj.dst, gj.w, jnp.asarray(C), gj.n_nodes,
                          impl="dense")
    tg = _port(gj)
    adj = dense_adjacency(tg.src, tg.dst, tg.nv)
    for kw in (dict(impl="dense"), dict(impl="dense", adj=adj), {}):
        got = t_disconnected(tg.src, tg.dst, tg.w, _t(C), tg.n_nodes, **kw)
        assert int(got["n_disconnected"]) == int(want["n_disconnected"]) > 0
        _eq(got["disconnected"], want["disconnected"], f"flags {kw}")


def test_dense_rejects_unknown_impls():
    tg = _port(GRAPHS["grid"]())
    C = torch.arange(tg.nv, dtype=torch.int32)
    with pytest.raises(ValueError, match="impl"):
        t_split(tg.src, tg.dst, tg.w, C, impl="sparse")
    with pytest.raises(ValueError, match="scan"):
        tcore.louvain(tg, scan="hash", device="cpu")


# --- the crossover: choose_scan and DetectOptions.resolved_scan -------------

SHAPES = [(65, 512), (257, 2048), (257, 1024), (1025, 16384), (1025, 65536),
          (2049, 10**6), (129, 10), (130, 336), (130, 337), (1025, 21010),
          (1025, 21011), (1026, 10**6), (1, 0)]


@pytest.mark.parametrize("density", [0.02, 0.02227, 0.0155])
def test_choose_scan_equals_reference(density):
    """Every shape of tests/test_service.py's crossover test and the edges
    of each band, with an explicit density (the calibrations differ: the
    reference's is its CPU backend's, the port's its own)."""
    for nv, m_cap in SHAPES:
        want = j_choose_scan(nv, m_cap, dense_min_density=density)
        assert tbuckets.choose_scan(
            nv, m_cap, dense_min_density=density) == want, (nv, m_cap)
        for topts, jopts in (
                (tcore.DetectOptions(dense_min_density=density),
                 jcore.DetectOptions(dense_min_density=density)),
                (tcore.DetectOptions(dense_min_density=density,
                                     dense_max_nv=513, dense_small_nv=65),
                 jcore.DetectOptions(dense_min_density=density,
                                     dense_max_nv=513, dense_small_nv=65))):
            assert topts.resolved_scan(nv, m_cap) == jopts.resolved_scan(
                nv, m_cap), (nv, m_cap)
    assert tbuckets.choose_scan(65, 512, dense_min_density=density) == "dense"


def test_resolved_scan_keeps_an_explicit_scan_and_reads_the_calibration():
    assert tcore.DetectOptions().resolved_scan(129, 10**6) == "dense"
    assert tcore.DetectOptions(scan="sort").resolved_scan(65, 512) == "sort"
    assert tcore.DetectOptions(scan="dense").resolved_scan(
        4097, 10) == "dense"
    # a device type with no calibration on file takes the default
    assert tbuckets.calibrated_min_density("no-such-device") == \
        tbuckets.DEFAULT_DENSE_MIN_DENSITY == 0.02
    d = tbuckets.calibrated_min_density("cuda")
    assert 0.0 < d < 1.0
    nv = 1025
    m = int(np.ceil(d * nv * nv))
    assert tcore.DetectOptions().resolved_scan(nv, m) == "dense"
    assert tcore.DetectOptions().resolved_scan(nv, m - 1) == "sort"


def _calibration_script():
    path = (pathlib.Path(__file__).resolve().parent.parent / "scripts"
            / "torch_calibrate_dense_scan.py")
    spec = importlib.util.spec_from_file_location("torch_calib", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_calibration_fit_agrees_with_its_rows():
    """The fit misclassifies the fewest rows (ties: the least lost time),
    and every committed entry is the fit of its own measurements."""
    fit = _calibration_script().fit_threshold

    def row(d, dense_ms, sort_ms):
        return dict(density=d, t_dense_ms=dense_ms, t_sort_ms=sort_ms,
                    dense_wins=dense_ms < sort_ms)

    assert fit([]) == 0.02
    assert fit([row(0.01, 1, 2), row(0.1, 1, 2)]) == 0.01
    assert fit([row(0.01, 2, 1), row(0.1, 2, 1)]) == 0.2
    assert fit([row(0.01, 2, 1), row(0.03, 1, 2), row(0.1, 1, 2)]) == 0.03
    # one noisy sort win in a dense band does not move the threshold
    rows = [row(0.004, 5, 6), row(0.008, 6.1, 6), row(0.016, 5, 6),
            row(0.031, 5, 6), row(0.062, 5, 6)]
    assert fit(rows) == 0.004
    for entry in json.loads(tbuckets.CALIB_FILE.read_text()).values():
        assert entry["dense_min_density"] == round(
            fit(entry["measurements"]), 5)


def test_buckets_ladder():
    assert tbuckets.choose_bucket(40, 500) == tbuckets.Bucket(64, 512)
    assert tbuckets.choose_bucket(200, 3000) == tbuckets.Bucket(256, 8192)
    assert tbuckets.DEFAULT_BUCKETS[-1].nv == 1025
    with pytest.raises(ValueError, match="no bucket"):
        tbuckets.choose_bucket(2000, 10)


@pytest.mark.parametrize("family", sorted(GRAPHS))
def test_detect_auto_resolves_as_the_reference(family, monkeypatch):
    """``detect()`` with default options runs the scan that the reference's
    ``run_detection`` resolves for the graph's shape (here with the
    reference's default density, given explicitly), and its labels."""
    gj = GRAPHS[family]()
    density = tbuckets.DEFAULT_DENSE_MIN_DENSITY
    expect = jcore.DetectOptions(dense_min_density=density).resolved_scan(
        gj.nv, gj.m_cap)
    seen = []
    louvain_impl = tportfolio.louvain_impl

    def spy(g, cfg, *, scan, phase_seconds=None):
        seen.append(scan)
        return louvain_impl(g, cfg, scan=scan, phase_seconds=phase_seconds)

    monkeypatch.setattr(tportfolio, "louvain_impl", spy)
    res = tcore.detect(_port(gj), options=tcore.DetectOptions(
        dense_min_density=density), device="cpu")
    assert seen == [expect]
    ref = jcore.detect(gj, options=jcore.DetectOptions(
        dense_min_density=density))
    _eq(res.labels, ref.labels, f"{family} labels")
    assert res.stats == {k: int(v) for k, v in ref.stats.items()}
