"""Scenario: serving community detection to live multi-tenant traffic, on
the PyTorch port.

A feed/recommendation stack wants communities of each user's ego-network:
requests arrive continuously from several product surfaces (tenants),
graphs are small and varied, and follower edges keep changing.  This
walks the futures front end end to end:

1. two tenants submit detect requests concurrently; each submission
   returns an awaitable future resolving to the stored result —
   admission buckets the graphs, weighted DRR composes fair batches, and
   the batched engine solves them (results are exactly ``louvain()``'s);
2. backpressure: tenant queues are bounded — ``block=False`` rejects the
   overflow explicitly, ``block=True`` awaits a freed slot;
3. edge updates hit the delta-screening warm path — no full recompute —
   and the no-disconnected-communities guarantee survives;
4. per-tenant metrics break down served/rejected/latency.

The sync ``CommunityService`` remains as a thin adapter over the same
front end (see ``main_sync_adapter`` below) — same admission, fairness,
store, and metrics; only the driving style differs.  Every service and
graph lives on ``--device`` (default ``cuda``).

  PYTHONPATH=src python examples/torch_community_service.py [--device cpu]
"""
import argparse
import asyncio

import numpy as np

from repro_torch.core import DetectOptions, LouvainConfig, louvain
from repro_torch.graph import sbm_graph
from repro_torch.service import (
    AsyncCommunityService, CommunityService, QueueFull, ServiceConfig,
)
from repro_torch.service.buckets import admit


def ego(uid: int, device):
    n = 30 + 3 * (uid % 5)
    return sbm_graph(n_nodes=n, n_blocks=3, p_in=0.45, p_out=0.04,
                     seed=uid, device=device)[0]


async def main_async(dev):
    config = ServiceConfig(
        detect=DetectOptions(louvain=LouvainConfig()),
        batch_size=8, max_delay_s=0.02,
        max_pending_per_tenant=6, store_max_entries=64,
        tenant_weights=(("feed", 2.0), ("ads", 1.0)),  # feed gets 2x share
    )
    async with AsyncCommunityService(config, device=dev) as svc:
        # -- 1. concurrent tenants, futures resolve to store entries ------
        async def burst(tenant, uids):
            futs = [await svc.submit_detect(f"{tenant}/u{u}", ego(u, dev),
                                            tenant=tenant)
                    for u in uids]
            return await asyncio.gather(*futs)

        feed, ads = await asyncio.gather(burst("feed", range(6)),
                                         burst("ads", range(6, 10)))
        e = feed[3]
        print(f"feed/u3: {e.n_communities} communities, "
              f"{e.n_disconnected} disconnected, Q={e.q:.3f}, v{e.version}")
        assert e.n_disconnected == 0

        # engine results are the single-graph API's results, exactly
        padded, _ = admit(ego(3, dev))
        C_ref, _ = louvain(padded, LouvainConfig(), device=dev)
        assert np.array_equal(e.C, C_ref.cpu().numpy())
        print("served partition == louvain() partition: exact")

        # -- 2. backpressure: the queue bound is explicit ------------------
        rejected = 0
        futs = []
        for i in range(10):                     # 10 > bound of 6
            try:
                futs.append(await svc.submit_detect(
                    f"ads/burst{i}", ego(20 + i, dev), tenant="ads",
                    block=False))
            except QueueFull:
                rejected += 1
        await asyncio.gather(*futs)
        print(f"burst of 10 into a bound-6 queue: {len(futs)} accepted, "
              f"{rejected} rejected (QueueFull)")
        assert rejected > 0

        # -- 3. the graph changes: warm update, not recompute --------------
        rng = np.random.default_rng(7)
        n = int(e.graph.n_nodes)
        upd = await svc.submit_update(
            "feed/u3", (rng.integers(0, n, 5), rng.integers(0, n, 5),
                        np.ones(5, np.float32)), tenant="feed")
        e2 = upd.result()                        # already resolved
        print(f"after update: v{e2.version}, {e2.n_communities} communities,"
              f" {e2.n_disconnected} disconnected "
              f"({svc.store.n_warm_updates} warm updates served)")
        assert e2.version == 2 and e2.n_disconnected == 0

        # -- 4. per-tenant metrics ----------------------------------------
        rep = svc.metrics.report()
        for name, t in rep["tenants"].items():
            print(f"tenant {name:<6} served {t['served']:>3} "
                  f"rejected {t['n_rejected']:>2} "
                  f"p50 {t['p50_ms']:6.1f} ms")
        print(f"dispatch keys: {len(svc.engine.cache_keys())}")


def main_sync_adapter(dev):
    """The pump API still works — a thin adapter over the same front end
    (admission, fairness, and store eviction included)."""
    svc = CommunityService(LouvainConfig(), batch_size=4, max_delay_s=0.02,
                           device=dev)
    for uid in range(4):
        svc.submit_detect(f"legacy/u{uid}", ego(uid, dev))
    served = svc.drain()
    e = svc.result("legacy/u0")
    print(f"sync adapter: served {served}, legacy/u0 has "
          f"{e.n_communities} communities, v{e.version}")
    assert e.n_disconnected == 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    asyncio.run(main_async(dev))
    main_sync_adapter(dev)


if __name__ == "__main__":
    main()
