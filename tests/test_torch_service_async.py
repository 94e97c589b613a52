"""The asyncio front end of the PyTorch port
(``repro_torch.service.AsyncCommunityService``) on the CPU: resolution,
backpressure (reject and block), fairness under skewed load, deadline
dispatch, shutdown, batched and re-bucketed updates, and sync/async
parity.

These cases run on the wall clock (the dispatcher's poll tick, the
deadline flush), so each holds the port to the reference test's own
assertions (tests/test_service_async.py, all ten cases, and the async
case of tests/test_dynamic_vertices.py).  What does not depend on the
clock is compared with the reference as well: every detect entry equals
the reference service's entry for the same graph (graph, labels, counts;
Q within ``Q_ATOL``), and the port's own ``detect()`` bit for bit.
"""
import asyncio

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_service import (
    FakeClock, as_input, config, ego, overflow_updates, q_is_detect,
    same_entry, sync_service,
)

import repro.core as jcore
from repro.graph import sbm_graph
import repro_torch.core as tcore
from repro_torch.core import GraphUpdate
from repro_torch.service import (
    AsyncCommunityService, CommunityService, QueueFull, ServiceConfig,
)
from repro_torch.service.buckets import admit

CPU = "cpu"


def _cfg(**kw):
    return config(True, **kw)


def _run(coro):
    return asyncio.run(coro)


@pytest.fixture(scope="module")
def reference():
    """The reference service's detect entry for ``ego(seed)`` (one
    reference service for the module, one dispatch a call)."""
    svc = sync_service(False, clock=FakeClock(), batch_size=32,
                       max_delay_s=10.0)
    cache = {}

    def entry(seed):
        if seed not in cache:
            gid = f"ref{seed}"
            svc.submit_detect(gid, ego(seed))
            svc.drain()
            cache[seed] = svc.result(gid)
        return cache[seed]

    return entry


def _same_as_reference(entry, reference, seed):
    ref = reference(seed)
    assert entry.version == 1
    same_entry(entry, ref)


# ---------------------------------------------------------------------------
# futures resolve to store entries
# ---------------------------------------------------------------------------

def test_futures_resolve_to_store_entries(reference):
    async def go():
        async with AsyncCommunityService(_cfg(batch_size=4, max_delay_s=0.01),
                                         device=CPU) as svc:
            futs = [await svc.submit_detect(f"g{i}", as_input(True, ego(i)),
                                            tenant="t0")
                    for i in range(4)]
            entries = await asyncio.gather(*futs)
            for i, e in enumerate(entries):
                assert e.n_disconnected == 0
                assert e.version == 1
                assert svc.result(f"g{i}") is e
            assert all(f.done() for f in futs)
            assert len({f.req_id for f in futs}) == 4
            return entries

    for i, e in enumerate(_run(go())):
        _same_as_reference(e, reference, i)
        q_is_detect(e)


# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------

def test_backpressure_reject_counted_no_deadlock(reference):
    async def go():
        cfg = _cfg(batch_size=2, max_delay_s=0.01, max_pending_per_tenant=2)
        async with AsyncCommunityService(cfg, device=CPU) as svc:
            futs, rejected = [], 0
            # no awaits between submissions -> the dispatcher cannot
            # drain, so exactly bound=2 are accepted and 4 are rejected
            for i in range(6):
                try:
                    futs.append(await svc.submit_detect(
                        f"a{i}", as_input(True, ego(i)), tenant="a",
                        block=False))
                except QueueFull:
                    rejected += 1
            assert rejected == 4
            assert svc.metrics.tenants["a"].n_rejected == 4
            entries = await asyncio.gather(*futs)
            assert all(e.n_disconnected == 0 for e in entries)
            assert svc.pending() == 0
            return entries

    for i, e in enumerate(_run(go())):
        _same_as_reference(e, reference, i)


def test_backpressure_block_awaits_slot(reference):
    async def go():
        cfg = _cfg(batch_size=2, max_delay_s=0.01, max_pending_per_tenant=2)
        async with AsyncCommunityService(cfg, device=CPU) as svc:
            futs = [await svc.submit_detect(f"b{i}", as_input(True, ego(i)),
                                            tenant="b")
                    for i in range(6)]
            entries = await asyncio.gather(*futs)
            assert len(entries) == 6
            assert all(e.n_disconnected == 0 for e in entries)
            assert svc.metrics.n_rejected == 0
            return entries

    for i, e in enumerate(_run(go())):
        _same_as_reference(e, reference, i)


# ---------------------------------------------------------------------------
# fairness: a flooding tenant cannot starve a light one
# ---------------------------------------------------------------------------

def test_fairness_light_tenant_not_starved():
    async def go():
        cfg = _cfg(batch_size=4, max_delay_s=0.005,
                   max_pending_per_tenant=8)
        async with AsyncCommunityService(cfg, device=CPU) as svc:
            done_order = []

            def record(f):
                done_order.append(f.req_id)

            async def heavy():
                futs = []
                for i in range(20):
                    f = await svc.submit_detect(
                        f"h{i}", as_input(True, ego(i)), tenant="heavy")
                    f.add_done_callback(record)
                    futs.append(f)
                return futs

            async def light():
                futs = []
                for i in range(5):
                    f = await svc.submit_detect(
                        f"l{i}", as_input(True, ego(100 + i)),
                        tenant="light")
                    f.add_done_callback(record)
                    futs.append(f)
                    await asyncio.sleep(0.002)
                return futs

            hf, lf = await asyncio.gather(heavy(), light())
            await asyncio.gather(*(hf + lf))
            served = {t: m.n_detect for t, m in svc.metrics.tenants.items()}
            assert served == {"heavy": 20, "light": 5}
            last_light = max(i for i, r in enumerate(done_order)
                             if r.startswith("d") and "-l" in r)
            last_heavy = max(i for i, r in enumerate(done_order)
                             if r.startswith("d") and "-h" in r)
            assert last_light < last_heavy
    _run(go())


# ---------------------------------------------------------------------------
# deadline dispatch
# ---------------------------------------------------------------------------

def test_deadline_forces_partial_flush(reference):
    async def go():
        # the batch never fills (64) and max_delay is far away (30 s): only
        # the request's own deadline can flush it
        cfg = _cfg(batch_size=64, max_delay_s=30.0)
        async with AsyncCommunityService(cfg, poll_s=0.005,
                                         device=CPU) as svc:
            t0 = asyncio.get_running_loop().time()
            fut = await svc.submit_detect("g", as_input(True, ego(0)),
                                          deadline_s=0.05)
            entry = await asyncio.wait_for(asyncio.ensure_future(
                _await(fut)), timeout=60.0)
            dt = asyncio.get_running_loop().time() - t0
            assert entry.version == 1
            assert dt < 25.0
            return entry

    _same_as_reference(_run(go()), reference, 0)


async def _await(fut):
    return await fut


# ---------------------------------------------------------------------------
# parity: sync adapter and async front end serve identical results
# ---------------------------------------------------------------------------

def test_sync_adapter_and_async_parity_with_louvain(reference):
    graphs = {f"g{i}": as_input(True, ego(i)) for i in range(4)}
    svc = CommunityService(buckets=_cfg().buckets, batch_size=4,
                           max_delay_s=10.0, device=CPU)
    ids = [svc.submit_detect(gid, g) for gid, g in graphs.items()]
    assert len(set(ids)) == len(ids)
    svc.drain()

    async def go():
        cfg = _cfg(batch_size=4, max_delay_s=10.0)
        async with AsyncCommunityService(cfg, device=CPU) as svc2:
            futs = [await svc2.submit_detect(gid, g)
                    for gid, g in graphs.items()]
            return list(await asyncio.gather(*futs))

    entries = _run(go())
    for i, ((gid, g), e) in enumerate(zip(graphs.items(), entries)):
        padded, _ = admit(g, svc.config.buckets)
        C_ref, stats = tcore.louvain(padded, device=CPU)
        np.testing.assert_array_equal(e.C, C_ref.numpy())
        np.testing.assert_array_equal(svc.result(gid).C, e.C)
        assert e.n_communities == int(stats["n_communities"])
        # and the reference's louvain() of the same admitted graph
        jpadded = reference(i).graph
        C_j, _ = jcore.louvain(jpadded, jcore.LouvainConfig())
        np.testing.assert_array_equal(e.C, np.asarray(C_j))


def test_close_without_drain_cancels_queued_futures():
    async def go():
        cfg = _cfg(batch_size=64, max_delay_s=30.0)
        svc = await AsyncCommunityService(cfg, device=CPU).start()
        fut = await svc.submit_detect("g", as_input(True, ego(0)),
                                      tenant="a")
        await svc.close(drain=False)
        assert fut.done()
        with pytest.raises(asyncio.CancelledError):
            await fut
    _run(go())


def test_async_batched_updates_resolve_on_dispatch():
    async def go():
        cfg = _cfg(batch_size=4, max_delay_s=0.01, update_batch_size=4,
                   update_max_delay_s=0.01)
        async with AsyncCommunityService(cfg, device=CPU) as svc:
            futs = [await svc.submit_detect(f"g{i}", as_input(True, ego(i)),
                                            tenant="u")
                    for i in range(4)]
            await asyncio.gather(*futs)
            rng = np.random.default_rng(5)
            ufuts, upds = [], []
            for i in range(4):
                n = int(svc.result(f"g{i}").graph.n_nodes)
                u, v = rng.integers(0, n, 3), rng.integers(0, n, 3)
                keep = u != v
                upds.append((u[keep], v[keep],
                             np.ones(int(keep.sum()), np.float32)))
                ufuts.append(await svc.submit_update(f"g{i}", upds[-1],
                                                     tenant="u"))
            entries = await asyncio.gather(*ufuts)
            assert all(e.version == 2 for e in entries)
            assert all(e.n_disconnected == 0 for e in entries)
            assert svc.metrics.n_update_batches >= 1
            assert svc.frontend.pending_updates() == 0
            return entries, upds

    entries, upds = _run(go())
    # however the clock batched them, each equals the immediate path
    imm = CommunityService(buckets=_cfg().buckets, batch_size=4,
                           max_delay_s=10.0, device=CPU)
    for i in range(4):
        imm.submit_detect(f"g{i}", as_input(True, ego(i)))
    imm.drain()
    for i, e in enumerate(entries):
        imm.submit_update(f"g{i}", upds[i])
        ei = imm.result(f"g{i}")
        np.testing.assert_array_equal(e.C, ei.C)
        assert e.q == ei.q and e.version == ei.version


def test_async_close_cancels_queued_updates():
    async def go():
        cfg = _cfg(batch_size=2, max_delay_s=0.01, update_batch_size=64,
                   update_max_delay_s=30.0)
        svc = await AsyncCommunityService(cfg, device=CPU).start()
        fut = await svc.submit_detect("g", as_input(True, ego(0)),
                                      tenant="a")
        await fut
        n = int(svc.result("g").graph.n_nodes)
        upd = await svc.submit_update(
            "g", (np.array([0]), np.array([n - 1]),
                  np.ones(1, np.float32)), tenant="a")
        assert not upd.done()
        await svc.close(drain=False)
        assert upd.done()
        with pytest.raises(asyncio.CancelledError):
            await upd
    _run(go())


def test_async_updates_and_rebucket_future():
    async def go():
        cfg = _cfg(batch_size=2, max_delay_s=0.01)
        async with AsyncCommunityService(cfg, device=CPU) as svc:
            futs = [await svc.submit_detect(f"g{i}", as_input(True, ego(i)),
                                            tenant="u")
                    for i in range(2)]
            await asyncio.gather(*futs)
            e = svc.result("g0")
            n = int(e.graph.n_nodes)
            rng = np.random.default_rng(3)
            upd = await svc.submit_update(
                "g0", (rng.integers(0, n, 4), rng.integers(0, n, 4),
                       np.ones(4, np.float32)), tenant="u")
            assert upd.kind == "update" and upd.done()
            assert (await upd).version == 2
            e = svc.result("g0")
            u, v, w = overflow_updates(e.graph)
            fut = await svc.submit_update("g0", (u, v, w), tenant="u")
            assert fut.kind == "detect"
            e3 = await fut
            assert e3.version == 3
            assert svc.metrics.n_rebucketed == 1
            with pytest.raises(KeyError):
                await svc.submit_update("nope", (u, v, w))
            return e3

    q_is_detect(_run(go()))


def test_async_vertex_update_round_trip():
    async def go():
        cfg = ServiceConfig(batch_size=4, max_delay_s=0.01,
                            update_batch_size=2)
        async with AsyncCommunityService(cfg, device=CPU) as svc:
            fut = await svc.submit_detect("g", as_input(
                True, sbm_graph(n_nodes=40, n_blocks=3, seed=1)[0]))
            e0 = await fut
            n = int(e0.graph.n_nodes)
            C = np.asarray(e0.C)
            peers = [i for i in range(n) if C[i] == C[0]][:2]
            grow = GraphUpdate(u=np.full(len(peers), n), v=np.array(peers),
                               dw=np.ones(len(peers), np.float32), add=1)
            f1 = await svc.submit_update("g", grow)
            f2 = await svc.submit_update("g", GraphUpdate(
                remove=np.array([n])))
            await svc.drain()
            e2 = await f2
            await f1
            assert int(e2.graph.n_nodes) == n
            np.testing.assert_array_equal(e2.graph.src.numpy(),
                                          e0.graph.src.numpy())
            assert e2.n_disconnected == 0

    _run(go())
