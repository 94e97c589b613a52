"""The port's community-service CLI (``repro_torch.launch.serve_communities``)
held against the reference's ``repro.launch.serve_communities``, on the CPU.

* The synthetic traffic helpers give the reference's arrays over seeds
  0-7 (graphs, edge batches, churn and vertex-churn batches, live pairs,
  tenant specs).
* The default sync driver and the churn driver at smoke size (with their
  round trips) commit the reference's store entries: labels, community
  and disconnected counts, version, bucket, and Q within 1e-6
  (``test_torch_detect.Q_ATOL``'s reason), with the same counts of served
  detects and updates.  Both packages' services run on a scripted clock
  that never moves, so only full batches dispatch before the drain and
  the traffic is the same whatever either host's speed; latencies are not
  compared.
* ``--async``, ``--replay`` and ``--tiers`` at smoke size on the CPU pass
  their own assertions; the CLI without ``--device`` raises where there
  is no card, and ``--sub-batch`` is an argparse error.
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_service import FakeClock
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import _port

import repro.core as jcore
import repro.launch.serve_communities as jsc
import repro.service as jservice
import repro_torch.core as tcore
import repro_torch.launch.serve_communities as tsc
import repro_torch.service as tservice

ROOT = Path(__file__).resolve().parents[1]
SEEDS = range(8)
SMOKE = dict(batch_size=6, max_delay_s=0.025)    # main()'s --smoke values


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_arrays(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        assert x.tobytes() == y.tobytes(), (what, i)


def _entries(gj):
    """The same stored entry for both packages' helpers: a reference graph
    and labels that cut it into three groups."""
    C = (np.arange(gj.nv) % 3).astype(np.int32)
    return (types.SimpleNamespace(graph=gj, C=C),
            types.SimpleNamespace(graph=_port(gj), C=C))


@pytest.mark.parametrize("family", tsc.FAMILIES)
def test_synth_helpers_equal_reference(family):
    for seed in SEEDS:
        gj = jsc.synth_graph(family, seed)
        gt = tsc.synth_graph(family, seed, device="cpu")
        assert (gt.n_cap, gt.m_cap) == (gj.n_cap, gj.m_cap)
        _same_arrays([gt.src, gt.dst, gt.w, gt.n_nodes],
                     [gj.src, gj.dst, gj.w, gj.n_nodes], (family, seed))
        ej, et = _entries(gj)
        _same_arrays(tsc.synth_updates(et, seed),
                     jsc.synth_updates(ej, seed), "synth_updates")
        _same_arrays(tsc.live_pairs(et.graph), jsc.live_pairs(ej.graph),
                     "live_pairs")
        _same_arrays(tsc.synth_churn_updates(et, seed),
                     jsc.synth_churn_updates(ej, seed),
                     "synth_churn_updates")
        ut, uj = tsc.synth_vertex_churn(et, seed), \
            jsc.synth_vertex_churn(ej, seed)
        assert isinstance(ut, tservice.GraphUpdate)
        _same_arrays([ut.u, ut.v, ut.dw, ut.remove],
                     [uj.u, uj.v, uj.dw, uj.remove], "synth_vertex_churn")
        assert ut.add == uj.add


def test_tenant_specs_equal_reference():
    for n_tenants in (1, 3, 4):
        for n_requests in (12, 120, 200):
            assert tsc.tenant_specs(n_tenants, n_requests) == \
                jsc.tenant_specs(n_tenants, n_requests)


def _services(port, **cfg):
    """One sync service of either package on a scripted clock."""
    core, svc = (tcore, tservice) if port else (jcore, jservice)
    config = svc.ServiceConfig(
        detect=core.DetectOptions(louvain=core.LouvainConfig()), **cfg)
    kw = dict(device="cpu") if port else {}
    return svc.CommunityService(config=config, clock=FakeClock(), **kw)


def _assert_same_store(st, sj):
    gids = sorted(sj._entries)
    assert sorted(st._entries) == gids
    for gid in gids:
        et, ej = st.get(gid), sj.get(gid)
        np.testing.assert_array_equal(et.C, np.asarray(ej.C), err_msg=gid)
        assert (et.n_communities, et.n_disconnected, et.version) == \
            (ej.n_communities, ej.n_disconnected, ej.version), gid
        assert (et.bucket.n_cap, et.bucket.m_cap) == \
            (ej.bucket.n_cap, ej.bucket.m_cap), gid
        assert et.algorithm == ej.algorithm, gid
        assert abs(et.q - ej.q) <= 1e-6, (gid, et.q, ej.q)
        _same_arrays([et.graph.src, et.graph.dst, et.graph.w],
                     [ej.graph.src, ej.graph.dst, ej.graph.w], gid)


def test_sync_driver_commits_the_reference_entries():
    """``run_traffic`` at smoke size (36 requests, 35 % updates), as
    ``main(['--smoke'])`` runs it, through both packages."""
    reps, svcs = [], []
    for port in (False, True):
        svc = _services(port, **SMOKE)
        sc = tsc if port else jsc
        reps.append(sc.run_traffic(svc, n_requests=36, update_frac=0.35,
                                   seed=0, verbose=False))
        svcs.append(svc)
    (rj, rt), (sj, st) = reps, svcs
    assert (rt["n_detect"], rt["n_update"]) == (rj["n_detect"],
                                               rj["n_update"])
    assert rt["n_update"] > 0
    _assert_same_store(st.store, sj.store)
    assert len({k[0] for k in st.engine.cache_keys()}) >= 3
    assert all(st.store.get(g).n_disconnected == 0
               for g in list(st.store._entries))


def test_churn_driver_commits_the_reference_entries():
    """``run_churn_traffic`` at smoke size and both round trips, as
    ``main(['--churn', '--smoke'])`` runs them, through both packages."""
    reps, svcs = [], []
    for port in (False, True):
        svc = _services(port, update_batch_size=6, **SMOKE)
        sc = tsc if port else jsc
        reps.append(sc.run_churn_traffic(svc, n_graphs=9, n_rounds=6,
                                         seed=0, verbose=False))
        sc._assert_round_trip(svc, seed=10_000)
        sc._assert_vertex_round_trip(svc, seed=20_000)
        svcs.append(svc)
    (rj, rt), (sj, st) = reps, svcs
    for k in ("n_detect", "n_update", "n_deletions", "n_vertex_added",
              "n_vertex_removed"):
        assert rt[k] == rj[k], k
    assert rt["n_update_batches"] >= 1 and rt["update_batch_mean"] > 1.0
    _assert_same_store(st.store, sj.store)


@pytest.mark.parametrize("mode", ["--async", "--replay", "--tiers"])
def test_smoke_modes_pass_on_the_cpu(mode, capsys):
    rep = tsc.main([mode, "--smoke", "--device", "cpu"])
    assert rep is not None
    assert "SMOKE OK" in capsys.readouterr().out


def test_cli_without_a_card_raises(monkeypatch):
    """``--device`` defaults to CUDA; without a card the CLI raises rather
    than run on the CPU (in process, and as ``python -m``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tsc.main(["--smoke"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tsc.main(["--churn", "--smoke", "--device", "cuda"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_communities",
         "--smoke"], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and "--device cpu" in proc.stderr
    assert "SMOKE OK" not in proc.stdout


def test_sub_batch_reaches_the_engine(monkeypatch):
    """``--sub-batch``, the reference's flag, reaches the engine of the
    sync smoke, whose standard batches then run in tiles of that width."""
    widths, routes = [], []
    detect_batch = tservice.BatchedLouvainEngine.detect_batch

    def spy(self, graphs, **kw):
        out = detect_batch(self, graphs, **kw)
        widths.append(self.sub_batch)
        routes.append(self.last_detect_info.route)
        return out

    monkeypatch.setattr(tservice.BatchedLouvainEngine, "detect_batch", spy)
    report = tsc.main(["--smoke", "--sub-batch", "2", "--device", "cpu"])
    assert report["n_detect"] > 0
    assert widths and set(widths) == {2}
    assert "tile" in routes
