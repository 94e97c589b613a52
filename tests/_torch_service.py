"""Shared pieces of the port's front-end tests: one scenario built from
numpy seeds runs through each package's service on the CPU, and the two
are compared.

The reference's engine compiles one executable per (bucket, batch, tier)
key and keeps it per engine, so reference services with the same
``DetectOptions`` share one dict of executables (:data:`_J_COMPILED`, by
options: the engine's key leaves out the algorithm config): a key
compiles once a process.  That changes only whether a reference dispatch
counts as a compile hit, which no comparison here reads.
"""
import numpy as np

from tests._service_helpers import overflow_updates  # noqa: F401
import repro.service as jservice
from repro.graph import sbm_graph
import repro_torch.core as tcore
import repro_torch.service as tservice
from test_torch_detect import Q_ATOL, _port

BUCKETS = ((64, 512), (64, 2048), (256, 2048))

_J_COMPILED: dict = {}


class FakeClock:
    """A scripted clock: time moves only when a test advances it."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def ego(seed, n=30):
    """The reference tests' ego-net, made by the reference's generator."""
    return sbm_graph(n_nodes=n, n_blocks=3, p_in=0.4, p_out=0.04,
                     seed=seed)[0]


def pkg(port):
    return tservice if port else jservice


def as_input(port, gj):
    """One reference graph as the given package's input."""
    return _port(gj) if port else gj


def config(port, **kw):
    """A ``ServiceConfig`` of either package; ``buckets`` as
    ``(n_cap, m_cap)`` pairs (default :data:`BUCKETS`)."""
    S = pkg(port)
    kw["buckets"] = tuple(S.Bucket(*b) for b in kw.get("buckets", BUCKETS))
    return S.ServiceConfig(**kw)


def share_compiles(obj):
    """Point a reference front end's engine at the shared executables."""
    fe = getattr(obj, "frontend", obj)
    fe.engine._compiled = _J_COMPILED.setdefault(fe.engine.options, {})
    return obj


def frontend(port, clock=None, **kw):
    """A ``ServiceFrontend`` of either package (the port on the CPU)."""
    if port:
        return tservice.ServiceFrontend(config(True, **kw), clock=clock,
                                        device="cpu")
    return share_compiles(jservice.ServiceFrontend(config(False, **kw),
                                                   clock=clock))


def sync_service(port, clock=None, **kw):
    """A ``CommunityService`` of either package built from ``config=``."""
    if port:
        return tservice.CommunityService(config=config(True, **kw),
                                         clock=clock, device="cpu")
    return share_compiles(jservice.CommunityService(
        config=config(False, **kw), clock=clock))


def record_batches(fe):
    """Log every batch ``fe.execute`` runs as (kind, (n_cap, m_cap),
    request ids), in dispatch order."""
    log = []
    execute = fe.execute

    def logged(batches):
        for kind, bucket, reqs in batches:
            log.append((kind, (bucket.n_cap, bucket.m_cap),
                        [r.future.req_id for r in reqs]))
        return execute(batches)

    fe.execute = logged
    return log


def same_entry(a, b):
    """A port entry against the reference's: the graph, labels, counts,
    version, bucket, tier and deferred tombstones equal; Q within
    ``Q_ATOL`` (ROADMAP C.8)."""
    for k in ("src", "dst", "w"):
        np.testing.assert_array_equal(getattr(a.graph, k).numpy(),
                                      np.asarray(getattr(b.graph, k)))
    assert int(a.graph.n_nodes) == int(b.graph.n_nodes)
    np.testing.assert_array_equal(a.C, np.asarray(b.C))
    assert (a.n_communities, a.n_disconnected, a.version) == \
        (int(b.n_communities), int(b.n_disconnected), b.version)
    assert (a.bucket.n_cap, a.bucket.m_cap) == (b.bucket.n_cap,
                                                b.bucket.m_cap)
    assert a.algorithm == b.algorithm
    np.testing.assert_array_equal(a.deferred, np.asarray(b.deferred))
    assert abs(a.q - float(b.q)) <= Q_ATOL


def q_is_detect(entry, options=None):
    """A detect entry is the port's own ``detect()`` of its admitted
    graph: labels, counts and Q's bits."""
    opts = (options or tcore.DetectOptions()).replace(
        algorithm=entry.algorithm)
    d = tcore.detect(entry.graph, options=opts, device="cpu")
    np.testing.assert_array_equal(entry.C, d.labels.numpy())
    assert (entry.n_communities, entry.n_disconnected) == \
        (d.n_communities, d.n_disconnected)
    assert entry.q == d.modularity


def span_names(fut):
    return [s.name for s in fut.trace.spans]


def edge_updates(entry, seed, n_edges=4):
    """Seeded edge insertions between live vertices (no self-loops)."""
    rng = np.random.default_rng(seed)
    n = int(entry.graph.n_nodes)
    u, v = rng.integers(0, n, n_edges), rng.integers(0, n, n_edges)
    keep = u != v
    return u[keep], v[keep], np.ones(int(keep.sum()), np.float32)


def report_counts(metrics):
    """``metrics.report()`` with the float rates dropped (the latencies
    come from the scripted clock, so they are compared as well)."""
    rep = metrics.report()
    rep.pop("graphs_per_s")
    rep.pop("edges_per_s")
    return rep
