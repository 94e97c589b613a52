"""The resilience layer of the PyTorch port (``repro_torch.resilience``)
held against the JAX package's ``repro.resilience``, on the CPU.

* The fault, policy, breaker and degrade cases of tests/test_resilience.py,
  with the firing sequences of one plan and the state sequences of one
  breaker script equal to the reference's, and ``lpa_result`` equal to
  the reference's (labels, ``n_disconnected``; Q within ``Q_ATOL``).
* The manager, driven by a ``SimpleNamespace`` config beside the
  reference's manager (the service's config record comes with the front
  end, ROADMAP A.11).
* The auto-checkpointer through a holder object (``.store`` and
  ``.timelines``): the dirty threshold, write-back of evicted entries,
  and recovery that skips a snapshot the ``checkpoint.io`` seam tore.
* The engine's fault seams under ``run_with_policy``.

Time comes from injected clocks; a real sleep stays under 0.2 s.  The
front-end cases (deadline fast-fail, poison batches split in half, the
breaker shedding a bucket, tenant opt-in, startup recovery through the
service config) wait for the front end (A.11).
"""
import os
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import Q_ATOL, _port

import repro.core as jcore
import repro.resilience as jr
import repro.service as jservice
from repro.graph import rmat_graph, ring_of_cliques, sbm_graph
from repro.resilience import degrade as jdegrade
import repro_torch.resilience as tr
from repro_torch.core import DetectOptions
from repro_torch.core.dynamic import CapacityError
from repro_torch.resilience import (
    AutoCheckpointer, BreakerBoard, BreakerConfig, CircuitBreaker,
    DeadlineExceeded, DegradedResult, DispatchTimeout, FaultError, FaultPlan,
    FaultSpec, FaultySink, ResilienceManager, RetryPolicy,
    TransientCapacityError, call_with_timeout, lpa_result, run_with_policy,
    stale_result,
)
from repro_torch.service import BatchedLouvainEngine, Bucket, ResultStore
from repro_torch.telemetry import InMemorySink, Telemetry
from repro_torch.timeline import TimelineManager


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _ego(seed, n=30):
    """An ego-net of the reference service's tests, admitted to its
    bucket (with free edge slots for updates)."""
    g = sbm_graph(n_nodes=n, n_blocks=3, p_in=0.4, p_out=0.04, seed=seed)[0]
    return jservice.buckets.admit(g, (jservice.Bucket(64, 512),))[0]


# ---------------------------------------------------------------------------
# fault plan: determinism, triggers, scoping, the reference's sequences
# ---------------------------------------------------------------------------

def _outcome(plan, seam, ids=None):
    try:
        plan.perturb(seam, ids=ids)
        return "ok"
    except Exception as e:                               # noqa: BLE001
        return type(e).__name__


def _fire_pattern(plan, seam, n):
    return [_outcome(plan, seam) == "FaultError" for _ in range(n)]


def test_fault_plan_deterministic_and_resettable():
    mk = lambda: FaultPlan({"engine.detect": FaultSpec(p=0.5)}, seed=42)
    a = _fire_pattern(mk(), "engine.detect", 40)
    assert a == _fire_pattern(mk(), "engine.detect", 40)
    assert True in a and False in a
    plan = mk()
    first = _fire_pattern(plan, "engine.detect", 40)
    plan.reset()
    assert _fire_pattern(plan, "engine.detect", 40) == first
    assert plan.injected["engine.detect"] == sum(first)
    ref = jr.FaultPlan({"engine.detect": jr.FaultSpec(p=0.5)}, seed=42)
    assert [_outcome(ref, "engine.detect") == "FaultError"
            for _ in range(40)] == first


SPECS = {
    "engine.detect": [dict(p=0.3, skip=2), dict(p=0.5, count=4,
                                                error="capacity")],
    "store.commit": [dict(p=0.7, graph_ids=("a", "c"))],
    "engine.update": [dict(p=1.0, count=3, skip=5)],
    "checkpoint.io": [dict(p=0.25)],
}


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_sequences_equal_the_reference(seed):
    """One plan, one call script: the same firings at the same calls, the
    same error types and the same injection counts as the reference."""
    def plan(mod):
        return mod.FaultPlan({s: [mod.FaultSpec(**kw) for kw in specs]
                              for s, specs in SPECS.items()}, seed=seed)

    port, ref = plan(tr), plan(jr)
    hooked = []
    port.on_inject = hooked.append
    rng = random.Random(seed)
    seams = list(SPECS) + ["unknown.seam"]
    got, want = [], []
    for _ in range(300):
        seam = rng.choice(seams)
        ids = rng.choice([None, ["a"], ["b"], ["b", "c"]])
        got.append(_outcome(port, seam, ids))
        want.append(_outcome(ref, seam, ids))
    assert got == want
    assert port.injected == ref.injected and port.injected_total() == \
        ref.injected_total() == len(hooked) > 0
    assert set(got) == {"ok", "FaultError", "TransientCapacityError"}
    assert port.seams == ref.seams
    assert repr(port) == repr(ref)


def test_fault_spec_skip_count_and_validation():
    plan = FaultPlan({"s": FaultSpec(p=1.0, skip=2, count=3)})
    assert _fire_pattern(plan, "s", 8) == [False, False, True, True, True,
                                           False, False, False]
    assert plan.injected_total() == 3
    for bad in (dict(p=1.5), dict(count=-1), dict(skip=-1), dict(hang_s=-1),
                dict(error="nonsense")):
        with pytest.raises(ValueError):
            FaultSpec(**bad)
    plan.perturb("unknown.seam")
    assert plan.spec("s") == (FaultSpec(p=1.0, skip=2, count=3),)


def test_fault_graph_id_scoping_and_capacity():
    plan = FaultPlan({
        "engine.detect": FaultSpec(p=1.0, graph_ids=("poison",)),
        "cap": FaultSpec(p=1.0, error="capacity"),
    })
    plan.perturb("engine.detect", ids=["clean-1", "clean-2"])
    plan.perturb("engine.detect", ids=None)
    with pytest.raises(FaultError) as e:
        plan.perturb("engine.detect", ids=["clean-1", "poison"])
    assert e.value.seam == "engine.detect"
    with pytest.raises(TransientCapacityError) as e:
        plan.perturb("cap")
    # the port's production capacity error, and a ValueError
    assert isinstance(e.value, CapacityError)


def test_fault_hang_sleeps_instead_of_raising():
    plan = FaultPlan({"h": FaultSpec(hang_s=0.05, count=1)})
    t0 = time.perf_counter()
    plan.perturb("h")
    assert time.perf_counter() - t0 >= 0.04
    plan.perturb("h")
    assert plan.injected["h"] == 1


def test_faulty_sink_raises_into_the_hub_guard():
    plan = FaultPlan({"telemetry.sink": FaultSpec(p=1.0, count=2)})
    tel = Telemetry()
    tel.register(FaultySink(plan))
    tel.counter("faults_injected", 1)          # bookkeeping: never perturbs
    tel.counter("requests", 1)
    tel.gauge("depth", 3.0)
    tel.span(None)
    assert plan.injected["telemetry.sink"] == 2 and tel.n_sink_errors == 2


# ---------------------------------------------------------------------------
# retry policy: backoff, budgets, watchdog
# ---------------------------------------------------------------------------

def test_retry_policy_delay_and_retryable():
    pol = RetryPolicy(max_attempts=4, backoff_s=0.1, backoff_factor=2.0,
                      jitter=0.5)
    ref = jr.RetryPolicy(max_attempts=4, backoff_s=0.1, backoff_factor=2.0,
                         jitter=0.5)
    for a in (1, 2, 3):
        for u in (0.0, 0.25, 1.0):
            assert pol.delay_s(a, u) == ref.delay_s(a, u)
    assert pol.delay_s(1, u=1.0) == pytest.approx(0.15)
    assert pol.retryable(RuntimeError("x"))
    assert pol.retryable(TransientCapacityError("full"))
    assert not pol.retryable(CapacityError("full"))
    assert not pol.retryable(ValueError("bad input"))
    assert not pol.retryable(DeadlineExceeded("late"))
    for bad in (dict(max_attempts=0), dict(backoff_s=-1),
                dict(backoff_factor=0.5), dict(jitter=2.0),
                dict(watchdog_s=0.0), dict(budget_s=0.0)):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)


def _flaky(fail_first):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fail_first:
            raise RuntimeError("transient")
        return "ok"
    return fn, calls


def test_run_with_policy_retries_then_succeeds():
    fn, calls = _flaky(2)
    sleeps, retried = [], []
    pol = RetryPolicy(max_attempts=3, backoff_s=0.1, jitter=0.0)
    out = run_with_policy(fn, pol, clock=FakeClock(), sleep=sleeps.append,
                          on_retry=lambda a, e: retried.append(a))
    assert out == "ok" and len(calls) == 3 and retried == [1, 2]
    assert sleeps == pytest.approx([0.1, 0.2])
    # with jitter, the same seeded draws give the reference's sleeps
    got, want = [], []
    for mod, out in ((tr, got), (jr, want)):
        fn, _ = _flaky(3)
        mod.run_with_policy(fn, mod.RetryPolicy(max_attempts=4, jitter=0.7),
                            clock=FakeClock(), sleep=out.append,
                            rng=random.Random(5))
    assert got == want and len(got) == 3


def test_run_with_policy_non_retryable_raises_immediately():
    calls = []

    def bad():
        calls.append(1)
        raise ValueError("poison")

    with pytest.raises(ValueError):
        run_with_policy(bad, RetryPolicy(max_attempts=5), sleep=lambda s: 0)
    assert len(calls) == 1
    assert run_with_policy(lambda: 3, None) == 3


def test_run_with_policy_budget_and_deadline():
    clock = FakeClock()

    def failing():
        clock.advance(0.3)
        raise RuntimeError("slow failure")

    pol = RetryPolicy(max_attempts=10, backoff_s=0.0, budget_s=0.5)
    with pytest.raises(RuntimeError):
        run_with_policy(failing, pol, clock=clock, sleep=lambda s: 0)
    assert clock.t == pytest.approx(0.6)        # two attempts fit
    with pytest.raises(DeadlineExceeded):
        run_with_policy(lambda: "never", RetryPolicy(max_attempts=2),
                        clock=FakeClock(t=10.0), deadline=9.0)


def test_watchdog_bounds_hung_dispatch():
    release = threading.Event()
    pol = RetryPolicy(max_attempts=1, watchdog_s=0.05)
    t0 = time.perf_counter()
    try:
        with pytest.raises(DispatchTimeout):
            run_with_policy(lambda: release.wait(2.0), pol)
    finally:
        release.set()
    assert time.perf_counter() - t0 < 1.0
    assert run_with_policy(lambda: "fast", pol) == "fast"
    with pytest.raises(KeyError):
        call_with_timeout(lambda: {}["x"], 1.0)


# ---------------------------------------------------------------------------
# circuit breaker FSM
# ---------------------------------------------------------------------------

def test_breaker_opens_half_opens_recloses():
    clock = FakeClock()
    br = CircuitBreaker(BreakerConfig(failure_threshold=3, cooldown_s=1.0),
                        clock=clock)
    assert br.state == "closed" and br.allow()
    for _ in range(3):
        br.record_failure()
    assert br.state == "open" and not br.allow() and br.n_opens == 1
    clock.advance(1.5)
    assert br.allow() and br.state == "half-open"
    assert not br.allow()
    br.record_success()
    assert br.state == "closed" and br.allow()


def test_breaker_probe_failure_reopens():
    clock = FakeClock()
    br = CircuitBreaker(BreakerConfig(failure_threshold=1, cooldown_s=1.0),
                        clock=clock)
    br.record_failure()
    clock.advance(1.5)
    assert br.allow()
    br.record_failure()
    assert br.state == "open" and br.n_opens == 2


def test_breaker_latency_counts_as_failure():
    br = CircuitBreaker(BreakerConfig(failure_threshold=2, cooldown_s=1.0,
                                      latency_threshold_s=0.5),
                        clock=FakeClock())
    br.record_success(latency_s=0.1)
    br.record_success(latency_s=2.0)
    br.record_success(latency_s=2.0)
    assert br.state == "open"
    for bad in (dict(failure_threshold=0), dict(cooldown_s=0.0),
                dict(latency_threshold_s=0.0), dict(half_open_probes=0)):
        with pytest.raises(ValueError):
            BreakerConfig(**bad)


def test_breaker_board_states_and_gauge():
    tel = Telemetry()
    sink = tel.register(InMemorySink())
    board = BreakerBoard(BreakerConfig(failure_threshold=2), clock=FakeClock(),
                         telemetry=tel)
    b = Bucket(64, 512)
    board.record_failure(b)
    board.record_success(b)
    board.record_failure(b)
    assert board.states() == {"64x512": "closed"}
    board.record_failure(b)
    assert board.states() == {"64x512": "open"} and board.n_opens == 1
    assert board.state("other") == "closed" and not board.allow(b)
    assert sink.gauges[("breaker_state", (("bucket", "64x512"),))] == 2.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_breaker_state_sequence_equals_the_reference(seed):
    """A random script of admissions, outcomes, latencies and clock steps:
    the same states, admissions and open counts as the reference."""
    cfg = dict(failure_threshold=3, cooldown_s=1.0, latency_threshold_s=0.4,
               half_open_probes=2)
    clocks = FakeClock(), FakeClock()
    moves = []
    port = CircuitBreaker(BreakerConfig(**cfg), clock=clocks[0],
                          on_transition=moves.append)
    ref = jr.CircuitBreaker(jr.BreakerConfig(**cfg), clock=clocks[1])
    rng = random.Random(seed)
    for _ in range(400):
        op = rng.choice(["allow", "ok", "slow", "fail", "tick", "state"])
        outs = []
        for br, clock in ((port, clocks[0]), (ref, clocks[1])):
            out = []
            outs.append(out)
            if op == "allow":
                out.append(br.allow())
            elif op == "ok":
                out.append(br.record_success(latency_s=0.1))
            elif op == "slow":
                out.append(br.record_success(latency_s=0.9))
            elif op == "fail":
                out.append(br.record_failure())
            elif op == "tick":
                out.append(clock.advance(0.35))
            out.append((br.state, br.n_opens))
        assert outs[0] == outs[1], op
    assert port.n_opens > 1 and set(moves) == {"open", "half-open", "closed"}


# ---------------------------------------------------------------------------
# degraded tiers never carry the guarantee
# ---------------------------------------------------------------------------

def test_stale_result_serves_the_committed_entry():
    gj = _ego(3)
    d = jcore.detect(gj)
    store = ResultStore(device="cpu", clock=FakeClock(2.0))
    entry = store.put("g", _port(gj), np.asarray(d.labels),
                      n_communities=d.n_communities, n_disconnected=0,
                      q=d.modularity)
    st = stale_result("g", entry, now=entry.t_stored + 7.5)
    assert st.stale and st.staleness_s == pytest.approx(7.5)
    assert st.quality == "stale" and st.guarantee is False
    assert np.array_equal(st.C, entry.C) and st.version == 1
    assert st.contract is not None and st.contract.tier == "standard"
    assert stale_result("g", entry, now=0.0).staleness_s == 0.0


LPA_GRAPHS = {
    "ring": lambda: ring_of_cliques(n_cliques=4, clique_size=5),
    "ego": lambda: _ego(5),
    "rmat": lambda: rmat_graph(scale=8, edge_factor=6, seed=2),
}


@pytest.mark.parametrize("name", sorted(LPA_GRAPHS))
def test_lpa_result_equals_the_reference(name):
    gj = LPA_GRAPHS[name]()
    want = jdegrade.lpa_result("g", gj)
    got = lpa_result("g", _port(gj), device="cpu")
    assert isinstance(got, DegradedResult)
    assert got.C.dtype == np.int32 and np.array_equal(got.C,
                                                      np.asarray(want.C))
    assert abs(got.q - want.q) <= Q_ATOL
    assert (got.n_communities, got.n_disconnected) == (want.n_communities,
                                                       want.n_disconnected)
    assert (got.mode, got.quality, got.stale, got.guarantee) == (
        "lpa", "degraded", False, False)
    assert got.contract.tier == "fast" and not got.contract.zero_disconnected
    # the service's other options carry over; the tier is forced to fast
    again = lpa_result("g", _port(gj), device="cpu",
                       options=DetectOptions(algorithm="max-quality",
                                             scan="sort"))
    assert np.array_equal(again.C, got.C) and again.q == got.q


# ---------------------------------------------------------------------------
# the manager, from any object with its seven fields
# ---------------------------------------------------------------------------

def _config(mod, **kw):
    base = dict(
        fault_plan=mod.FaultPlan({
            "engine.detect": mod.FaultSpec(p=0.5),
            "store.commit": mod.FaultSpec(count=1)}, seed=3),
        retry=mod.RetryPolicy(max_attempts=2, backoff_s=0.0),
        breaker=mod.BreakerConfig(failure_threshold=2, cooldown_s=1.0),
        degrade_enabled=True, degrade_modes=("stale", "lpa"),
        detect=None, degrade_tenants=("premium",))
    base.update(kw)
    return SimpleNamespace(**base)


def test_manager_dispatch_and_commit_equal_the_reference():
    runs = []
    for mod in (tr, jr):
        clock = FakeClock()
        tel = Telemetry()
        sink = tel.register(InMemorySink())
        cfg = _config(mod, detect=(DetectOptions() if mod is tr
                                   else jcore.DetectOptions()))
        mgr = mod.ResilienceManager(cfg, telemetry=tel, clock=clock)
        plan = cfg.fault_plan
        log = []
        for i in range(30):
            def work():
                plan.perturb("engine.detect")
                return i
            try:
                log.append(mgr.dispatch("detect", "b64", work))
            except Exception as e:                       # noqa: BLE001
                log.append(type(e).__name__)
            log.append(mgr.allow("b64"))
            log.append(mgr.breaker_state("b64"))
            clock.advance(0.4)
        log.append(mgr.commit(lambda: "stored"))
        runs.append((log, mgr.n_retries, plan.injected,
                     sink.counter_total("resilience_retries"),
                     sink.counter_total("faults_injected")))
    assert runs[0] == runs[1]
    assert runs[0][1] > 0 and "FaultError" in runs[0][0]


def test_manager_fast_path_and_degraded_modes():
    off = ResilienceManager(SimpleNamespace(
        fault_plan=None, retry=None, breaker=None, degrade_enabled=False,
        degrade_modes=(), detect=DetectOptions(), degrade_tenants=None))
    assert not off.enabled and off.dispatch("d", "b", lambda: 5) == 5
    assert off.commit(lambda: 6) == 6 and off.allow("b")
    assert off.breaker_state("b") is None
    assert off.degraded("g", None, None, now=0.0) is None

    gj = _ego(8)
    d = jcore.detect(gj)
    store = ResultStore(device="cpu", clock=FakeClock(1.0))
    mgr = ResilienceManager(_config(
        tr,
        detect=DetectOptions()))
    assert mgr.can_degrade("premium") and not mgr.can_degrade("strict")
    assert mgr.degraded("g", _port(gj), store, now=4.0,
                        tenant="strict") is None
    lp = mgr.degraded("g", _port(gj), store, now=4.0, tenant="premium")
    assert lp.mode == "lpa"                    # nothing stored: lpa next
    want = jdegrade.lpa_result("g", gj)
    assert np.array_equal(lp.C, np.asarray(want.C))
    store.put("g", _port(gj), np.asarray(d.labels),
              n_communities=d.n_communities, n_disconnected=0, q=d.modularity)
    st = mgr.degraded("g", _port(gj), store, now=4.0, tenant="premium")
    assert st.mode == "stale" and st.staleness_s == 3.0
    assert mgr.n_degraded == 2
    mgr.note_split()
    assert mgr.n_batch_splits == 1


# ---------------------------------------------------------------------------
# the auto-checkpointer, through a holder (.store, .timelines)
# ---------------------------------------------------------------------------

def _holder(**store_kw):
    tl = TimelineManager(clock=lambda: 0.0)
    store = ResultStore(device="cpu", on_commit=tl.observe_commit,
                        **store_kw)
    return SimpleNamespace(store=store, timelines=tl)


def _put(holder, gid, gj):
    d = jcore.detect(gj)
    return holder.store.put(gid, _port(gj), np.asarray(d.labels),
                            n_communities=d.n_communities,
                            n_disconnected=d.n_disconnected, q=d.modularity)


def _upd(entry, seed, n_edges=3):
    rng = np.random.default_rng(seed)
    n = int(entry.graph.n_nodes)
    u, v = rng.integers(0, n, n_edges), rng.integers(0, n, n_edges)
    keep = u != v
    return u[keep], v[keep], np.ones(int(keep.sum()), np.float32)


def test_autockpt_dirty_threshold_triggers_background_snapshot(tmp_path):
    holder = _holder()
    _put(holder, "g", _ego(12))
    ac = AutoCheckpointer(holder, ckpt_dir=str(tmp_path), period_s=999.0,
                          dirty_threshold=2)
    ac.start()
    try:
        ac.note_commit("g")
        assert not ac._wake.is_set()            # below the threshold
        ac.note_commit("g")
        deadline = time.perf_counter() + 10.0
        while ac.n_snapshots == 0 and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert ac.n_snapshots == 1 and ac.last_step == 0, ac.last_error
        assert ac._dirty == 0 and ac.age_s() < 60.0
        assert ac.snapshot() is None            # nothing new to save
    finally:
        ac.close(flush=False)
    assert ac._thread is None


def test_autockpt_writes_back_evicted_entries(tmp_path):
    ckdir = str(tmp_path / "wb")
    holder = _holder(max_entries=2)
    ac = AutoCheckpointer(holder, ckpt_dir=ckdir, period_s=999.0)
    holder.store.on_evict = ac.note_evicted
    entries = [_put(holder, f"g{i}", _ego(30 + i)) for i in range(3)]
    assert holder.store.get("g0") is None
    ac.snapshot(force=True)
    assert ac.n_written_back == 1
    fresh = _holder()
    assert AutoCheckpointer(fresh, ckpt_dir=ckdir).recover() == 0
    # the evicted entry comes back, and the residents rank after it
    assert fresh.store.graph_ids() == ["g0", "g1", "g2"]
    ent = fresh.store.get("g0")
    assert np.array_equal(ent.C, entries[0].C)
    assert ent.version == entries[0].version
    ac.note_commit("g0")                        # resident again
    assert not ac._evicted


def test_recover_falls_back_past_a_torn_snapshot(tmp_path):
    ckdir = str(tmp_path / "auto")
    plan = FaultPlan({"checkpoint.io": FaultSpec(skip=1, count=1)})
    holder = _holder()
    e0 = _put(holder, "g", _ego(11))
    ac = AutoCheckpointer(holder, ckpt_dir=ckdir, faults=plan, keep=3)
    state0 = holder.timelines.state()
    assert ac.snapshot(force=True) == 0 and ac.n_torn == 0
    holder.store.apply_update("g", _upd(e0, 3))
    assert ac.snapshot(force=True) == 1 and ac.n_torn == 1   # torn
    fresh = _holder()
    ac2 = AutoCheckpointer(fresh, ckpt_dir=ckdir)
    assert ac2.recover() == 0 and ac2.n_corrupt_skipped == 1
    ent = fresh.store.get("g")
    assert ent.version == e0.version and np.array_equal(ent.C, e0.C)
    assert fresh.timelines.state()[1] == state0[1]
    # keep-last-k, and an empty directory recovers nothing
    for _ in range(3):
        ac.snapshot(force=True)
    assert sorted(os.listdir(ckdir)) == [f"step-{s:010d}" for s in (2, 3, 4)]
    assert AutoCheckpointer(_holder(), ckpt_dir=str(tmp_path / "none")
                            ).recover() is None


def test_autockpt_close_flushes_a_final_snapshot(tmp_path):
    holder = _holder()
    _put(holder, "g", _ego(13))
    ac = AutoCheckpointer(holder, ckpt_dir=str(tmp_path), period_s=999.0)
    ac.start()
    ac.close()
    assert ac.n_snapshots == 1 and ac.last_step == 0
    empty = AutoCheckpointer(_holder(), ckpt_dir=str(tmp_path / "e"))
    assert empty.snapshot(force=True) is None


# ---------------------------------------------------------------------------
# the engine's fault seams under the retry policy
# ---------------------------------------------------------------------------

def _engine_graphs():
    return [_port(_ego(40 + i)) for i in range(3)]


def _same_batch(a, b):
    return all(np.array_equal(x.C, y.C) and x.q == y.q
               and x.n_communities == y.n_communities for x, y in zip(a, b))


def test_engine_detect_fault_is_retried_to_the_clean_batch():
    graphs = _engine_graphs()
    clean = BatchedLouvainEngine(device="cpu").detect_batch(graphs)
    plan = FaultPlan({"engine.detect": FaultSpec(count=1)})
    engine = BatchedLouvainEngine(device="cpu", faults=plan)
    retried = []
    got = run_with_policy(lambda: engine.detect_batch(graphs),
                          RetryPolicy(max_attempts=3, backoff_s=0.0),
                          on_retry=lambda a, e: retried.append(type(e)))
    assert retried == [FaultError] and plan.injected["engine.detect"] == 1
    assert _same_batch(got, clean)


def test_engine_hang_trips_the_watchdog():
    """The hung attempt is abandoned; a second call goes through.  The
    abandoned attempt then fails at ``engine.detect`` (scoped to its
    ids), so no torch work outlives the test."""
    graphs = _engine_graphs()[:1]
    plan = FaultPlan({
        "engine.detect.hang": FaultSpec(hang_s=0.1, count=1),
        "engine.detect": FaultSpec(graph_ids=("hung",))})
    engine = BatchedLouvainEngine(device="cpu", faults=plan)
    with pytest.raises(DispatchTimeout):
        call_with_timeout(lambda: engine.detect_batch(
            graphs, fault_ids=["hung"]), 0.03)
    assert plan.injected["engine.detect.hang"] == 1
    out = call_with_timeout(lambda: engine.detect_batch(graphs), 60.0)
    assert len(out) == 1 and out[0].n_disconnected == 0
    deadline = time.perf_counter() + 5.0
    while not plan.injected["engine.detect"] and \
            time.perf_counter() < deadline:
        time.sleep(0.01)
    assert plan.injected["engine.detect"] == 1
