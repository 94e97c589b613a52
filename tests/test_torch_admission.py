"""Admission control of the PyTorch port (``repro_torch.service.admission``)
held against the JAX package's ``repro.service.admission``, on the CPU.

Admission is host Python, so the port must pick exactly as the reference
does.  Each case drives both packages' controllers with one scripted
clock and the same submissions and holds the composed batches, their
order, the pending counts and the tenant bookkeeping equal; the
reference's own expectations are asserted as well.  Mirrors the five
``test_admission_*`` cases of tests/test_service.py, plus seeded DRR runs
that mix tenants, weights, priorities, deadlines and tiers.  The
reference's ``ServiceConfig`` comes with the front end that reads it
(ROADMAP A.11).
"""
import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import _port

import repro.core as jcore
import repro.service as jservice
import repro_torch.core as tcore
import repro_torch.service as tservice
from repro.graph import sbm_graph
from repro.service.buckets import admit as j_admit
from repro_torch.service.buckets import admit as t_admit

PACKAGES = {"repro": (jservice, jcore, j_admit),
            "repro_torch": (tservice, tcore, t_admit)}


def _ego(seed, n=30):
    return sbm_graph(n_nodes=n, n_blocks=3, p_in=0.4, p_out=0.04,
                     seed=seed)[0]


def _big(seed):
    return sbm_graph(n_nodes=100, n_blocks=4, p_in=0.2, p_out=0.02,
                     seed=seed)[0]


class Driver:
    """One package's controller, with the reference test's ``_req``."""

    def __init__(self, pkg, clock=None, **kw):
        self.svc, self.core, self.admit = PACKAGES[pkg]
        self.pkg = pkg
        self.buckets = (self.svc.Bucket(64, 512), self.svc.Bucket(64, 2048),
                        self.svc.Bucket(256, 2048))
        self.adm = self.svc.AdmissionController(self.buckets, clock=clock,
                                                **kw)

    def req(self, tenant, i, g, priority=0, deadline=None, t=0.0,
            algorithm="standard"):
        if self.pkg == "repro_torch":
            g = _port(g)
        padded, bucket = self.admit(g, self.buckets)
        return self.svc.PendingRequest(
            req_id=f"{tenant}-{i}", tenant=tenant, graph_id=f"{tenant}-{i}",
            graph=padded, bucket=bucket, priority=priority, t_submit=t,
            deadline=deadline, algorithm=algorithm, future=None)

    def submit(self, *args, **kw):
        try:
            self.adm.submit(self.req(*args, **kw))
            return "ok"
        except self.svc.QueueFull:
            return "QueueFull"

    def ready(self, now, force=False):
        return [(b.n_cap, b.m_cap, alg)
                for b, alg in self.adm.ready_groups(now, force=force)]

    def compose(self, force=False, now=0.0, **kw):
        """Compose every ready group in order: the batches' request ids."""
        out = []
        for b, alg in self.adm.ready_groups(now, force=force):
            out.append([r.req_id for r in
                        self.adm.compose(b, algorithm=alg, **kw)])
        return out


def _both(case, **kw):
    """Run ``case(driver)`` on both packages; return the reference's trace
    after checking the port's is equal."""
    traces = {pkg: case(Driver(pkg, **kw)) for pkg in PACKAGES}
    assert traces["repro_torch"] == traces["repro"]
    return traces["repro"]


# ---------------------------------------------------------------------------
# the cases of tests/test_service.py
# ---------------------------------------------------------------------------

def test_admission_full_batch_and_deadline_flush():
    t = [0.0]

    def case(d):
        t[0] = 0.0
        g = _ego(1)
        trace = [d.submit("a", 0, g), d.submit("a", 1, g),
                 d.ready(t[0])]
        t[0] = 0.5
        trace.append(d.ready(t[0]))
        trace.append(d.submit("a", 2, g))
        trace.append(d.compose(now=t[0]))
        d.submit("a", 3, g, t=0.5)
        t[0] = 2.0
        trace.append(d.compose(now=t[0]))
        d.submit("a", 4, g, t=2.0, deadline=2.1)
        trace += [d.ready(2.05), d.compose(now=2.15), d.adm.pending()]
        return trace

    trace = _both(case, clock=lambda: t[0], batch_size=3, max_delay_s=1.0)
    assert trace[5] == [["a-0", "a-1", "a-2"]]
    assert trace[6] == [["a-3"]]
    assert trace[7] == [] and trace[8] == [["a-4"]] and trace[9] == 0


def test_admission_queue_bound_per_tenant():
    def case(d):
        g = _ego(1)
        return [d.submit("a", 0, g), d.submit("a", 1, g),
                d.submit("a", 2, g), d.submit("b", 0, g),
                d.adm.pending("a"), d.adm.pending("b")]

    trace = _both(case, batch_size=4, max_pending_per_tenant=2)
    assert trace == ["ok", "ok", "QueueFull", "ok", 2, 1]


@pytest.mark.parametrize("weights,want", [(None, {"heavy": 4, "light": 4}),
                                          ({"heavy": 3.0},
                                           {"heavy": 6, "light": 2})])
def test_admission_drr_fairness_and_weights(weights, want):
    def case(d):
        g = _ego(1)
        for i in range(30):
            d.submit("heavy", i, g)
        for i in range(4):
            d.submit("light", i, g)
        return d.compose(force=True)

    [batch] = _both(case, batch_size=8, max_delay_s=0.0,
                    max_pending_per_tenant=64, weights=weights)
    counts = {t: sum(r.startswith(t) for r in batch) for t in want}
    assert counts == want


def test_admission_prunes_idle_tenants():
    def case(d):
        g = _ego(1)
        d.submit("a", 0, g)
        d.submit("b", 0, g)
        trace = [d.compose(force=True), d.adm.pending(), d.adm.tenants()]
        d.submit("a", 1, g)
        return trace + [d.adm.tenants(), d.adm.pending("a")]

    trace = _both(case, batch_size=4)
    assert trace[1:] == [0, [], ["a"], 1]


def test_admission_priority_within_tenant():
    def case(d):
        g = _ego(1)
        d.submit("a", 0, g, priority=0)
        d.submit("a", 1, g, priority=5)
        d.submit("a", 2, g, priority=5)
        return d.compose(force=True)

    assert _both(case, batch_size=4) == [["a-1", "a-2", "a-0"]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_seeded_drr_runs_pick_alike(seed):
    """Many tenants, weights, priorities, deadlines, two buckets and three
    tiers; submissions and composes interleaved by a seeded script."""
    t = [0.0]
    graphs = [_ego(1), _big(1)]

    def case(d):
        rng = np.random.default_rng(seed)
        t[0] = 0.0
        for tenant, w in (("t1", 2.0), ("t3", 0.5)):
            d.adm.set_weight(tenant, w)
        trace = []
        for step in range(120):
            t[0] += float(rng.exponential(0.01))
            if rng.random() < 0.8:
                tenant = f"t{int(rng.integers(0, 5))}"
                deadline = (t[0] + float(rng.uniform(0, 0.05))
                            if rng.random() < 0.3 else None)
                trace.append(d.submit(
                    tenant, step, graphs[int(rng.integers(0, 2))],
                    priority=int(rng.integers(0, 3)), deadline=deadline,
                    t=t[0],
                    algorithm=("fast", "standard", "max-quality")[
                        int(rng.integers(0, 3))]))
            else:
                trace.append(d.ready(t[0]))
                trace.append(d.compose(now=t[0],
                                       max_n=int(rng.integers(1, 6))))
            trace.append((d.adm.pending(), d.adm.tenants()))
        trace.append(d.compose(force=True))
        trace.append([r.req_id for r in d.adm.evict_all()])
        return trace

    trace = _both(case, clock=lambda: t[0], batch_size=4, max_delay_s=0.03,
                  max_pending_per_tenant=3)
    assert any(x == "QueueFull" for x in trace)
    assert any(isinstance(x, list) and x and isinstance(x[0], list)
               for x in trace)


def test_legacy_compose_by_bucket_picks_oldest_group():
    def case(d):
        g = _ego(1)
        d.submit("a", 0, g, t=1.0, algorithm="fast")
        d.submit("b", 1, g, t=0.5, algorithm="max-quality")
        d.submit("a", 2, g, t=0.7, algorithm="fast")
        [b] = d.adm.ready_buckets(0.0, force=True)
        return [[r.req_id for r in d.adm.compose(b)] for _ in range(3)]

    assert _both(case, batch_size=4) == [["b-1"], ["a-0", "a-2"], []]
