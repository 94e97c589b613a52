"""The port's sharded single-graph path (``core/distributed.py``) on CPU
meshes of 1, 2 and 4 ranks over gloo, held bit for bit against the
port's single-device labels and stats and against ``repro.core.louvain``
(the reference's ``louvain_sharded`` is its single-device partition).

The meshes start once a module; each mesh call has its own limit
(``CALL_S``), and each test its ``timeout`` mark.  The reference's
sharded telemetry runs in one JAX subprocess with two forced host
devices, as its own tests run it.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import _eq, _port, _t
from test_torch_portfolio import NEAR_TIES, UNCONNECTED
from test_torch_refine import REFERENCE_SPLIT_PARTS

import _torch_mesh_jobs as jobs
import repro.core as jcore
import repro.graph as rg
import repro_torch.core as tcore
from repro_torch.core.detect import disconnected_communities
from repro_torch.core.distributed import louvain_sharded
from repro_torch.core.local_move import local_move
from repro_torch.core.louvain import SPLITS, refine_labels
from repro_torch.core.modularity import modularity
from repro_torch.core.split import split_labels
from repro_torch.graph.container import strip_padding
from repro_torch.graph.partition import partition_edges_by_src, shard_vertex_roles
from repro_torch.launch import Mesh, MeshError, make_host_mesh, make_mesh
from repro_torch.service.engine import BatchedLouvainEngine
from repro_torch.telemetry.sinks import InMemorySink, MetricSink, Telemetry

ROOT = Path(__file__).resolve().parents[1]
CALL_S = 120.0         # each sharded call's own limit (Mesh.run)

# the reference's parity families (tests/test_sharded.py)
FAMILIES = {
    "ring": lambda: rg.ring_of_cliques(n_cliques=12, clique_size=6),
    "sbm": lambda: rg.sbm_graph(n_nodes=200, n_blocks=5, p_in=0.4,
                                p_out=0.02, seed=3)[0],
    "grid": lambda: rg.grid_graph(12, 12),
}
# ROADMAP C.11: q_s > q_r, so max-quality keeps the GSP candidate on one
# device; the reference's partition() with a mesh returns the refined one
C11_GRAPH = lambda: rg.grid_graph(10, 10)  # noqa: E731


@pytest.fixture(scope="module")
def meshes():
    ms = {n: make_host_mesh(n, device="cpu") for n in (1, 2, 4)}
    yield ms
    for m in ms.values():
        m.close()


def _sharded(g, cfg, mesh, **kw):
    """``louvain_sharded`` within ``CALL_S`` (the job's limit)."""
    t0 = time.perf_counter()
    out = louvain_sharded(g, cfg, mesh=mesh, **kw)
    assert time.perf_counter() - t0 < CALL_S
    return out


def _single(g, cfg):
    return tcore.louvain(g, cfg, device="cpu")


def _q(g, C):
    return float(modularity(*strip_padding(g.src, g.dst, g.w, g.ghost), C))


def _n_disconnected(g, C):
    live = strip_padding(g.src, g.dst, g.w, g.ghost)
    return int(disconnected_communities(*live, C, g.n_nodes)["n_disconnected"])


def _base(stats):
    return {k: stats[k] for k in ("passes", "li_last", "li_total",
                                  "split_moved", "n_communities")}


@pytest.mark.timeout(240)
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_equals_single_device_and_reference(meshes, family, n_shards):
    gj = FAMILIES[family]()
    g = _port(gj)
    cfg = tcore.LouvainConfig()
    C1, s1 = _single(g, cfg)
    Cs, ss = _sharded(g, cfg, meshes[n_shards])
    assert torch.equal(Cs, C1)
    _eq(Cs, jcore.louvain(gj, jcore.LouvainConfig())[0], "reference labels")
    assert _base(ss) == s1
    assert ss["n_shards"] == n_shards and ss["ghost_vertices"] == 0
    assert _q(g, Cs) == _q(g, C1)
    assert _n_disconnected(g, Cs) == 0


@pytest.mark.timeout(240)
@pytest.mark.parametrize("split", SPLITS)
def test_every_split_policy(meshes, split):
    """Each split policy on the reference's split-mode graph and on the
    graph where the reference's 'refine' leaves a community unconnected
    (ROADMAP C.7): the port's single-device labels and stats (which
    ``tests/test_torch_portfolio.py`` holds to the reference's, C.7's
    split aside)."""
    cfg = tcore.LouvainConfig(split=split)
    for gj in (rg.ring_of_cliques(n_cliques=10, clique_size=5),
               UNCONNECTED["rmat(10, ef=4, seed=3) standard/refine"][0]()):
        g = _port(gj)
        C1, s1 = _single(g, cfg)
        Cs, ss = _sharded(g, cfg, meshes[2])
        assert torch.equal(Cs, C1) and _base(ss) == s1
        if split != "none":
            assert _n_disconnected(g, Cs) == 0


@pytest.mark.timeout(240)
def test_refine_splits_what_the_reference_leaves_unconnected(meshes):
    """C.7 on 2 ranks: the reference's 'refine' labels with its one
    unconnected community split, as on one device."""
    gj = UNCONNECTED["rmat(10, ef=4, seed=3) standard/refine"][0]()
    Cj, sj = jcore.louvain(gj, jcore.LouvainConfig(split="refine"))
    g = _port(gj)
    Cs, ss = _sharded(g, tcore.LouvainConfig(split="refine"), meshes[2])
    assert _n_disconnected(g, _t(Cj)) == 1 and _n_disconnected(g, Cs) == 0
    assert ss["n_communities"] == int(sj["n_communities"]) + 1
    assert not np.array_equal(Cs.numpy(), np.asarray(Cj))


@pytest.mark.timeout(240)
@pytest.mark.parametrize("tau", [0.0, 1e6], ids=["0", "1e6"])
def test_refine_labels_on_shards(meshes, tau):
    """``refine_labels`` with the collectives, on the shards of 2 and 4
    ranks: the single-device refinement, parts the reference leaves
    unconnected included (``REFERENCE_SPLIT_PARTS``, held to the
    reference in ``tests/test_torch_refine.py``)."""
    assert ("rmat", tau) in REFERENCE_SPLIT_PARTS
    gj = rg.rmat_graph(scale=9, edge_factor=8, seed=11)
    g = _port(gj)
    C, _ = tcore.louvain(g, tcore.LouvainConfig(max_passes=1, split="none"),
                         device="cpu")
    live = [t.contiguous() for t in strip_padding(g.src, g.dst, g.w, g.ghost)]
    two_m = float(g.total_weight_2m())
    R1 = refine_labels(*live, C, g.total_weight_2m(), tau=np.float32(tau))
    for n in (2, 4):
        for R in meshes[n].run(jobs.refine_shards, *live, C, two_m, tau,
                               timeout=CALL_S):
            np.testing.assert_array_equal(R, R1.numpy())


@pytest.mark.timeout(240)
def test_halo_cut_edge_decides_tiebreak(meshes):
    """The reference's hand-built case: vertex 2 is pulled equally by its
    own triangle and, through the one cut edge, by the other shard's; the
    sharded labels are the single-device ones."""
    und = [(0, 1, 1.0), (0, 2, 1.0), (1, 2, 1.0), (3, 4, 1.0), (3, 5, 1.0),
           (4, 5, 1.0), (2, 3, 2.0)]
    src, dst, w = (np.array(c, dt) for c, dt in
                   zip(zip(*und), (np.int32, np.int32, np.float32)))
    g = _port(rg.from_undirected(6, src, dst, w))
    roles = shard_vertex_roles(partition_edges_by_src(g, 2), 0)
    assert roles["n_cut_edges"] == 1
    assert list(roles["boundary"]) == [2] and list(roles["ghosts"]) == [3]
    cfg = tcore.LouvainConfig()
    Cs, _ = _sharded(g, cfg, meshes[2])
    assert torch.equal(Cs, _single(g, cfg)[0])


_REFERENCE_TELEMETRY = """
import json
import numpy as np
from repro.core import DetectOptions, LouvainConfig, detect
from repro.core.distributed import louvain_sharded
from repro.graph import grid_graph, ring_of_cliques
from repro.telemetry.sinks import InMemorySink, MetricSink, Telemetry

class Spans(MetricSink):
    def __init__(self):
        self.spans = []
    def on_span(self, span):
        self.spans.append([span.name, span.labels])

def run(g, cfg):
    tel = Telemetry()
    mem, sp = tel.register(InMemorySink()), tel.register(Spans())
    C, stats = louvain_sharded(g, cfg, mesh=2, telemetry=tel)
    return dict(labels=np.asarray(C).tolist(),
                stats={k: int(v) for k, v in stats.items()},
                counters=sorted([n, sorted(lk), v]
                                for (n, lk), v in mem.counters.items()),
                gauges=sorted([n, sorted(lk), v]
                              for (n, lk), v in mem.gauges.items()),
                spans=sp.spans)

out = dict(ring=run(ring_of_cliques(n_cliques=8, clique_size=6),
                    LouvainConfig()),
           one_pass=run(grid_graph(12, 12), LouvainConfig(max_passes=1)))
out["c11"] = np.asarray(detect(grid_graph(10, 10), options=DetectOptions(
    algorithm="max-quality", mesh=2)).labels).tolist()
print(json.dumps(out))
"""


class _Spans(MetricSink):
    def __init__(self):
        self.spans = []

    def on_span(self, span):
        self.spans.append([span.name, span.labels])


def _port_telemetry(g, cfg, mesh):
    tel = Telemetry()
    mem, sp = tel.register(InMemorySink()), tel.register(_Spans())
    C, stats = _sharded(g, cfg, mesh, telemetry=tel)
    return dict(labels=C.tolist(), stats=stats,
                counters=sorted([n, sorted(map(list, lk)), v]
                                for (n, lk), v in mem.counters.items()),
                gauges=sorted([n, sorted(map(list, lk)), v]
                              for (n, lk), v in mem.gauges.items()),
                spans=sp.spans)


@pytest.mark.timeout(240)
def test_telemetry_equals_reference(meshes):
    """The ghost and cut-edge gauges, the device sweeps, the spans and the
    stats of the reference's ``louvain_sharded`` on 2 devices; the halo
    bytes too on an unpadded graph in a run of one pass (the port counts
    each pass's live edges, the reference the container's capacity).
    And C.11: the reference's ``detect()`` with a mesh returns the refined
    candidate where its single-device one keeps the GSP candidate."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, "-c",
                           textwrap.dedent(_REFERENCE_TELEMETRY)],
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    for key, gj, cfg in (
            ("ring", rg.ring_of_cliques(n_cliques=8, clique_size=6),
             tcore.LouvainConfig()),
            ("one_pass", rg.grid_graph(12, 12),
             tcore.LouvainConfig(max_passes=1))):
        got = _port_telemetry(_port(gj), cfg, meshes[2])
        want = ref[key]
        assert got["labels"] == want["labels"], key
        assert got["stats"] == want["stats"], key
        assert got["gauges"] == [[n, lk, float(v)]
                                 for n, lk, v in want["gauges"]], key
        assert got["spans"] == want["spans"], key
        halo = lambda c: [x for x in c if x[0] == "sharded_halo_bytes"]  # noqa
        sweeps = lambda c: [x for x in c if x[0] != "sharded_halo_bytes"]  # noqa
        assert sweeps(got["counters"]) == sweeps(want["counters"]), key
        if key == "one_pass":
            assert halo(got["counters"]) == halo(want["counters"]), key
    assert got["stats"]["ghost_vertices"] == 24
    # C.11, the reference's side: its sharded max-quality is the refined
    # candidate, its single-device detect() the GSP one (q_s > q_r)
    gj = C11_GRAPH()
    Cr = np.asarray(jcore.louvain(gj, jcore.tier_config(
        "max-quality", jcore.LouvainConfig()))[0])
    single = jcore.detect(gj, options=jcore.DetectOptions(
        algorithm="max-quality", scan="sort"))
    assert ref["c11"] == Cr.tolist()
    assert not np.array_equal(np.asarray(single.labels), Cr)


_DETECT_CASES = {
    "ring": FAMILIES["ring"],
    "sbm": FAMILIES["sbm"],
    "grid(10, 10), C.11": C11_GRAPH,
    "ring_of_cliques(13, 3), near tie": NEAR_TIES["ring_of_cliques(13, 3)"],
}


@pytest.mark.timeout(240)
@pytest.mark.parametrize("algorithm", ["standard", "max-quality"])
@pytest.mark.parametrize("case", sorted(_DETECT_CASES))
def test_detect_with_a_mesh_equals_detect_without(meshes, case, algorithm):
    g = _port(_DETECT_CASES[case]())
    opts = tcore.DetectOptions(algorithm=algorithm)
    want = tcore.detect(g, options=opts, device="cpu")
    got = tcore.detect(g, options=opts.replace(mesh=meshes[2]), device="cpu")
    assert torch.equal(got.labels, want.labels)
    assert got.modularity == want.modularity
    assert got.n_communities == want.n_communities
    assert got.n_disconnected == want.n_disconnected == 0
    assert _base(got.stats) == want.stats
    assert got.contract == want.contract


@pytest.mark.timeout(240)
def test_an_int_mesh_and_louvain_mesh(meshes):
    """``DetectOptions(mesh=2)`` is two ranks on the graph's device kind
    (the module's CPU mesh here); ``louvain(..., mesh=)`` routes too."""
    g = _port(FAMILIES["ring"]())
    want = tcore.detect(g, device="cpu")
    got = tcore.detect(g, options=tcore.DetectOptions(mesh=2), device="cpu")
    assert torch.equal(got.labels, want.labels)
    assert meshes[2].reports and meshes[2].reports[-1][0]["device"] == "cpu"
    C, st = tcore.louvain(g, device="cpu", mesh=meshes[2])
    assert torch.equal(C, want.labels) and _base(st) == want.stats


def test_degraded_tier_drops_the_mesh(meshes):
    """The LPA degraded tier runs on one device whatever the service's
    mesh, as the reference's ``lpa_result``."""
    from repro_torch.resilience.degrade import lpa_result

    g = _port(FAMILIES["sbm"]())
    n_calls = len(meshes[2].reports)
    got = lpa_result("g", g, options=tcore.DetectOptions(mesh=meshes[2]),
                     device="cpu")
    want = lpa_result("g", g, device="cpu")
    assert len(meshes[2].reports) == n_calls
    np.testing.assert_array_equal(got.C, want.C)
    assert got.q == want.q and got.mode == "lpa"


def test_fast_and_dense_raise_with_a_mesh(meshes):
    g = _port(FAMILIES["ring"]())
    with pytest.raises(ValueError, match="single-device only"):
        tcore.detect(g, options=tcore.DetectOptions(
            algorithm="fast", mesh=meshes[2]), device="cpu")
    with pytest.raises(ValueError, match="scan='dense' is single-device"):
        tcore.detect(g, options=tcore.DetectOptions(
            scan="dense", mesh=meshes[2]), device="cpu")
    with pytest.raises(ValueError, match="scan='dense' is single-device"):
        tcore.louvain(g, scan="dense", device="cpu", mesh=meshes[2])
    live = strip_padding(g.src, g.dst, g.w, g.ghost)
    ids = torch.arange(g.nv, dtype=torch.int32)
    K = g.vertex_weights()
    with pytest.raises(ValueError, match="single-device only"):
        local_move(*live, ids, K, K, g.total_weight_2m(), tau=0.01,
                   scan="dense", group=object())
    with pytest.raises(ValueError, match="single-device only"):
        split_labels(*live, ids, impl="dense", group=object())


@pytest.mark.timeout(240)
@pytest.mark.parametrize("algorithm", ["standard", "max-quality"])
def test_engine_detect_sharded_equals_detect_one(meshes, algorithm):
    g = _port(FAMILIES["sbm"]())
    tel = Telemetry()
    mem = tel.register(InMemorySink())
    eng = BatchedLouvainEngine(options=tcore.DetectOptions(
        algorithm=algorithm, mesh=meshes[2]), telemetry=tel, device="cpu")
    got = eng.detect_sharded(g)
    info = eng.last_detect_info
    assert info.kind == "detect" and info.n == 1 and info.algorithm == algorithm
    assert mem.counter_total("sharded_device_sweeps") > 0
    assert mem.counter_total("sharded_halo_bytes") > 0
    n_calls = len(meshes[2].reports)
    want = eng.detect_one(g)      # a batch runs on one device, mesh or not
    assert len(meshes[2].reports) == n_calls
    np.testing.assert_array_equal(got.C, want.C)
    for k in ("n_communities", "n_disconnected", "fraction", "passes", "q",
              "sweeps", "split_moved", "algorithm", "contract"):
        assert getattr(got, k) == getattr(want, k), k
    with pytest.raises(ValueError, match="requires a mesh"):
        BatchedLouvainEngine(device="cpu").detect_sharded(g)
    with pytest.raises(ValueError, match="single-device only"):
        BatchedLouvainEngine(options=tcore.DetectOptions(
            algorithm="fast", mesh=meshes[2]), device="cpu").detect_sharded(g)


@pytest.mark.timeout(120)
def test_failing_rank_raises_in_time_and_leaves_no_process():
    mesh = make_mesh(("cpu", "cpu"))
    try:
        assert [r["rank"] for r in mesh.run(jobs.where_am_i, timeout=60.0)
                ] == [0, 1]
        pids = mesh.pids()
        t0 = time.perf_counter()
        with pytest.raises(MeshError, match="ZeroDivisionError: rank 1 fails"):
            mesh.run(jobs.fail_on, 1, timeout=60.0)
        # rank 0 still waits in its collective: the caller does not
        assert time.perf_counter() - t0 < 30.0
        assert not mesh.alive and mesh.pids() == []
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
        # the next call starts the workers anew
        assert len(mesh.run(jobs.where_am_i, timeout=60.0)) == 2
    finally:
        mesh.close()
    assert mesh.pids() == []


def test_meshes_resolve_backend_and_refuse_what_they_cannot_run():
    assert make_mesh(("cuda:0", "cuda:0")).backend == "gloo"
    assert make_mesh(("cuda:0", "cuda:1")).backend == "nccl"
    assert make_mesh(("cuda",)).devices == ("cuda:0",)
    assert make_mesh(("cpu", "cpu")).backend == "gloo"
    assert make_mesh(("cpu", "cpu")) == Mesh(("cpu", "cpu"), "gloo")
    assert hash(make_mesh(("cpu",))) == hash(Mesh(("cpu",), "gloo"))
    with pytest.raises(ValueError, match="one device kind"):
        make_mesh(("cuda:0", "cpu"))
    with pytest.raises(ValueError, match="NCCL takes one CUDA device a rank"):
        Mesh(("cuda:0", "cuda:0"), "nccl")
    with pytest.raises(ValueError, match="at least one rank"):
        make_mesh(())
    # no card here: a CUDA mesh by count raises, never a CPU rank instead
    with pytest.raises(ValueError, match="CUDA devices available"):
        make_host_mesh(2)
    with pytest.raises(ValueError, match="CUDA devices available"):
        tcore.DetectOptions(mesh=2).resolved_mesh()
    assert tcore.DetectOptions(mesh=2).resolved_mesh("cpu") is \
        make_host_mesh(2, device="cpu")
    with pytest.raises(TypeError, match="mesh must be"):
        tcore.DetectOptions(mesh="2")
    opts = tcore.DetectOptions(mesh=2)
    assert opts.cache_key("b") == tcore.DetectOptions().cache_key("b")
    assert opts.result_key() == tcore.DetectOptions().result_key()
