"""Community-detection service entrypoint + synthetic traffic drivers (port
of ``repro/launch/serve_communities.py``; run it as ``python -m
repro_torch.launch.serve_communities``).

Three drivers share the synthetic request families (three graph sizes
landing in three buckets, plus warm edge updates):

* default (sync pump): PR-1 style closed-loop traffic through the
  ``CommunityService`` adapter — submit, pump, drain, report latency
  percentiles and throughput.
* ``--async``: a multi-tenant **open-loop** load generator against
  ``AsyncCommunityService``.  Tenants submit at skewed rates with
  ``block=False`` — arrivals do not slow down because the service is
  busy, so queue overflow is *rejected* (counted per tenant), heavy
  tenants cannot starve light ones (weighted DRR), and the report breaks
  served/rejected/latency down per tenant.
* ``--replay``: the open-loop **load-replay harness**
  (:mod:`repro_torch.service.replay`) — Poisson arrivals with heavy-tailed
  graph sizes, Zipf tenant skew and an update/detect mix at a configured
  rate, against a service with telemetry + the Prometheus exporter
  attached.  Prints the per-phase latency breakdown (queue / engine /
  host shares).  ``--replay --smoke`` scrapes the live ``/metrics``
  endpoint mid-run and asserts the body parses as Prometheus text with
  per-tenant served counters, per-phase latency histograms and compile
  hit/miss counters.  ``--sweep R1,R2,...`` replays a rate ladder and
  reports the saturation knee instead.
* ``--churn``: a fully-dynamic update-dominated workload — every graph
  is detected once, then churned with mixed batches of edge additions,
  weight deltas and **deletions** served through the *batched* warm path
  (``update_batch_size > 1``), followed by a **vertex churn** phase:
  combined ``GraphUpdate`` batches that remove a random vertex (its
  incident edges deleted, its id compacted away) and add a fresh one
  wired into a surviving community.  ``--churn --smoke`` asserts the
  dynamic invariants: zero internally-disconnected communities across
  the whole store after every delete and every vertex rewrite, update
  batches actually dispatched batched, deletions freeing capacity, an
  add-then-delete round trip restoring the original partition stats, and
  a vertex add-then-remove round trip restoring the COO bit-for-bit with
  the freed vertex slots reusable (capacity reclaim).

* ``--stream``: the temporal-tracking driver — a streaming-graph
  workload against the async service with
  ``ServiceConfig(timeline_enabled=True)``.  Phase 1 replays the
  *planted* lifecycle script (:func:`repro_torch.data.streams.
  planted_timeline_script`) window by window and checks the emitted
  lifecycle events against ground truth; phase 2 ingests a
  removal-heavy synthetic event stream with deferred compaction
  (``--compact-window``) and reports events/s through the windowed
  path.  ``--stream --smoke`` asserts the acceptance contract: the
  exact merge -> split -> death -> birth event sequence, correct
  ``membership_at`` answers in external-id space across >= 3
  vertex-compaction rounds, zero internally-disconnected communities
  at every snapshot, and a live exporter scrape carrying the stream
  counters (``repro_stream_events_ingested_total``,
  ``repro_timeline_snapshots_total``, ``repro_timeline_events_total``,
  ``repro_stream_lag_seconds_bucket``).

* ``--sharded``: the distributed single-graph driver — detection sharded
  over a 2-rank mesh through the engine's ``detect_sharded`` mode: two
  CPU ranks with ``--device cpu``, two ranks sharing the card over gloo
  on a machine of one card, one card a rank over NCCL where there are
  two.  ``--sharded --smoke`` asserts bit-identical
  partitions vs the single-device driver on every graph family, zero
  internally-disconnected communities, and a live exporter scrape
  carrying the halo-exchange counters.

* ``--chaos``: the resilience driver — the detect workload replayed
  fault-free and then under a deterministic :class:`FaultPlan` (engine
  raises + a watchdog-bounded hang + store-commit failures + transient
  capacity errors + a crashing telemetry sink) with retries, a
  per-bucket circuit breaker and degraded fallbacks armed, followed by
  a breaker open/half-open/reclose cycle and a kill-and-restore round
  trip through the automatic checkpointer whose newest snapshot is
  torn.  ``--chaos --smoke`` asserts goodput >= 0.8x fault-free, no
  permanently-pending future, bit-identical non-degraded results with
  zero internally-disconnected communities, flagged degraded results,
  breaker recovery, and warm updates resuming at the restored version.

* ``--tiers``: the SLO-tier driver — three tenants pinned to the three
  portfolio tiers (``fast`` / ``standard`` / ``max-quality``) via
  ``ServiceConfig.tenant_tiers`` submit the SAME graphs through the
  async service, so per-tier quality and latency are directly
  comparable, plus deadline-driven auto-selection
  (``deadline_tiers``) and an explicit ``algorithm=`` pin that
  overrides the tenant mapping.  ``--tiers --smoke`` asserts the
  acceptance contract: every entry is stamped with its requested tier,
  zero internally-disconnected communities for standard AND
  max-quality, max-quality modularity >= standard on every shared
  graph, the fast tier under a latency bound, tight deadlines landing
  on fast / loose on the default, and a live ``/metrics`` scrape
  carrying tier-labeled served + compile counters.

Every driver runs on ``--device`` (default ``cuda``; it raises when
there is no card, and ``--device cpu`` runs on the CPU): each service,
graph and mesh is built there.  ``--sub-batch`` is the engine's tile
width, as in the reference (default: the auto width, 1 on the CPU and 8
on CUDA).  Printed times are wall times of the run on that device.

  PYTHONPATH=src python -m repro_torch.launch.serve_communities --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_communities --async --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_communities --churn --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_communities --replay --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_communities --stream --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_communities --sharded --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_communities --chaos --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_communities --tiers --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_communities \
      --async --tenants 4 --requests 200 --max-pending 12 --batch 16
  PYTHONPATH=src python -m repro_torch.launch.serve_communities --smoke \
      --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import time

import numpy as np
import torch

from repro_torch.core import DetectOptions, LouvainConfig
from repro_torch.graph import grid_graph, sbm_graph
from repro_torch.service import (
    AsyncCommunityService, CommunityService, GraphUpdate, QueueFull,
    ServiceConfig,
)


FAMILIES = ("ego_small", "ego_dense", "road")


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def synth_graph(kind: str, seed: int, device=None):
    """One request graph per family; families land in distinct buckets.
    ``device`` as for the generators (``None`` = CUDA)."""
    rng = np.random.default_rng(seed)
    if kind == "ego_small":           # sparse ego-net -> (64, 512)
        n = int(rng.integers(28, 52))
        return sbm_graph(n_nodes=n, n_blocks=3, p_in=0.35, p_out=0.03,
                         seed=seed, device=device)[0]
    if kind == "ego_dense":           # dense ego-net -> (64, 2048)
        n = int(rng.integers(48, 60))
        return sbm_graph(n_nodes=n, n_blocks=4, p_in=0.7, p_out=0.08,
                         seed=seed, device=device)[0]
    # road-like subgraph -> (256, 2048)
    r = int(rng.integers(10, 15))
    return grid_graph(r, 16, device=device)


def synth_updates(entry, seed: int, n_edges: int = 4):
    """A small undirected edge batch inside the stored graph's vertex set."""
    rng = np.random.default_rng(seed)
    n = int(entry.graph.n_nodes)
    u = rng.integers(0, n, n_edges)
    v = rng.integers(0, n, n_edges)
    keep = u != v
    return u[keep], v[keep], np.ones(int(keep.sum()), np.float32)


def live_pairs(graph):
    """Host-side (u, v, w) of the live undirected pairs (u < v)."""
    src, dst, w = (_host(t) for t in (graph.src, graph.dst, graph.w))
    mask = (src < graph.n_cap) & (src < dst)
    return src[mask], dst[mask], w[mask]


def synth_churn_updates(entry, seed: int):
    """A mixed fully-dynamic batch: delete 1-2 live edges outright
    (negative full weight), halve another's weight, add 1-2 new edges."""
    rng = np.random.default_rng(seed)
    n = int(entry.graph.n_nodes)
    lu, lv, lw = live_pairs(entry.graph)
    us, vs, ws = [], [], []
    if len(lu) > 8:
        idx = rng.choice(len(lu), int(rng.integers(2, 4)), replace=False)
        dele, half = idx[:-1], idx[-1:]
        us += [lu[dele], lu[half]]
        vs += [lv[dele], lv[half]]
        ws += [-lw[dele], -lw[half] / 2]
    au = rng.integers(0, n, int(rng.integers(1, 3)))
    av = rng.integers(0, n, len(au))
    keep = au != av
    us.append(au[keep])
    vs.append(av[keep])
    ws.append(np.ones(int(keep.sum()), np.float32))
    return (np.concatenate(us), np.concatenate(vs),
            np.concatenate(ws).astype(np.float32))


def synth_vertex_churn(entry, seed: int) -> GraphUpdate:
    """One combined vertex+edge batch: remove a random vertex, add one
    wired into a surviving community.  Endpoint ids follow the
    order-preserving compaction contract — survivors above the removed id
    shift down by one, and the fresh vertex claims id ``n - 1``."""
    rng = np.random.default_rng(seed)
    n = int(entry.graph.n_nodes)
    C = _host(entry.C)
    rem = int(rng.integers(0, n))
    survivors = np.array([i for i in range(n) if i != rem])
    anchor = int(rng.choice(survivors))
    peers = [i for i in survivors if C[i] == C[anchor]][:3]
    new_id = n - 1                      # n - 1 removed + 1 added
    v = np.array([p - (p > rem) for p in peers])
    return GraphUpdate(u=np.full(len(peers), new_id), v=v,
                       dw=np.ones(len(peers), np.float32),
                       add=1, remove=np.array([rem]))


# ---------------------------------------------------------------------------
# sync pump driver (PR-1 API, now a thin adapter over the front end)
# ---------------------------------------------------------------------------

def run_traffic(svc: CommunityService, *, n_requests: int, update_frac: float,
                seed: int, warmup: bool = True, verbose: bool = True):
    """Feed the request mix, pumping as traffic arrives; returns the report.

    With ``warmup`` every bucket's detect and update paths run once on a
    throwaway prologue (kernels loaded, allocator warm) so the reported
    latencies reflect the steady state a long-running service sees.
    Graphs are made on the service's device.
    """
    rng = np.random.default_rng(seed)
    dev = svc.frontend.device
    if warmup:
        for i, fam in enumerate(FAMILIES):
            svc.submit_detect(f"warm-{fam}",
                              synth_graph(fam, 10_000 + i, device=dev))
        svc.drain()
        for fam in FAMILIES:            # the update path, per bucket
            e = svc.result(f"warm-{fam}")
            svc.submit_update(f"warm-{fam}", synth_updates(e, 1))
            # every configured tier dispatched once on the bucket
            svc.engine.warm(e.bucket)
        svc.metrics.reset()             # reset counters after warmup

    served_ids: list[str] = []
    n_updates = 0
    for i in range(n_requests):
        stored = [gid for gid in served_ids if svc.result(gid) is not None]
        if stored and rng.random() < update_frac:
            gid = stored[int(rng.integers(0, len(stored)))]
            svc.submit_update(gid, synth_updates(svc.result(gid), seed + i))
            n_updates += 1
        else:
            fam = FAMILIES[int(rng.integers(0, len(FAMILIES)))]
            gid = f"g{i}-{fam}"
            svc.submit_detect(gid, synth_graph(fam, seed + i, device=dev))
            served_ids.append(gid)
        svc.pump()                       # deadline/full-batch dispatch
    svc.drain()

    report = svc.metrics.report()
    if verbose:
        buckets = sorted({k[0] for k in svc.engine.cache_keys()})
        print(f"requests: {report['n_detect']} detect + "
              f"{report['n_update']} warm updates "
              f"({report['n_rebucketed']} re-bucketed)")
        print(f"buckets in play: {[(b.n_cap, b.m_cap) for b in buckets]}")
        print(f"latency    p50 {report['p50_ms']:8.1f} ms   "
              f"p99 {report['p99_ms']:8.1f} ms")
        print(f"  detect   p50 {report['p50_detect_ms']:8.1f} ms")
        print(f"  update   p50 {report['p50_update_ms']:8.1f} ms (warm path)")
        print(f"throughput {report['graphs_per_s']:8.1f} graphs/s   "
              f"{report['edges_per_s']:,.0f} edges/s")
    return report


# ---------------------------------------------------------------------------
# churn driver: fully-dynamic update-dominated traffic (batched warm path)
# ---------------------------------------------------------------------------

def run_churn_traffic(svc: CommunityService, *, n_graphs: int = 9,
                      n_rounds: int = 10, vertex_rounds: int = 4,
                      seed: int = 0, verbose: bool = True):
    """Detect ``n_graphs`` once, then serve ``n_rounds`` churn rounds of
    mixed add/delta/delete edge batches followed by ``vertex_rounds`` of
    combined vertex+edge rewrites, all through the batched warm path."""
    rng = np.random.default_rng(seed)
    dev = svc.frontend.device
    gids = []
    for i in range(n_graphs):
        fam = FAMILIES[i % len(FAMILIES)]
        gid = f"c{i}-{fam}"
        svc.submit_detect(gid, synth_graph(fam, seed + i, device=dev))
        gids.append(gid)
    svc.drain()
    svc.metrics.reset()          # churn metrics exclude the seeding phase

    for r in range(n_rounds):
        order = rng.permutation(len(gids))
        for j in order:
            gid = gids[int(j)]
            entry = svc.result(gid)
            if entry is None:        # evicted/re-bucketing in flight
                continue
            svc.submit_update(gid, synth_churn_updates(
                entry, seed + 997 * r + int(j)))
        svc.pump()                   # full update batches dispatch batched

    # vertex churn: remove a random vertex / add a wired one per graph per
    # round — the same batched warm path serves the combined rewrites
    for r in range(vertex_rounds):
        order = rng.permutation(len(gids))
        for j in order:
            gid = gids[int(j)]
            entry = svc.result(gid)
            if entry is None:
                continue
            svc.submit_update(gid, synth_vertex_churn(
                entry, seed + 7919 * r + int(j)))
        svc.pump()
    svc.drain()

    report = svc.metrics.report()
    if verbose:
        print(f"churn: {report['n_update']} updates in "
              f"{report['n_update_batches']} batches "
              f"(mean width {report['update_batch_mean']:.1f}), "
              f"{report['n_deletions']} directed deletions, "
              f"{report['n_vertex_added']} vertices added / "
              f"{report['n_vertex_removed']} removed, "
              f"{report['n_rebucketed']} re-bucketed")
        print(f"update latency p50 {report['p50_update_ms']:8.1f} ms   "
              f"throughput {report['graphs_per_s']:8.1f} graphs/s")
    return report


def _assert_round_trip(svc: CommunityService, seed: int):
    """Add a batch, delete the same batch: the graph (and its partition
    stats) must come back exactly — deletions are true inverses and the
    freed slots are reusable."""
    gid = "round-trip"
    svc.submit_detect(gid, synth_graph("ego_small", seed,
                                       device=svc.frontend.device))
    svc.drain()
    e0 = svc.result(gid)
    n = int(e0.graph.n_nodes)
    lu, lv, _ = live_pairs(e0.graph)
    have = set(zip(lu.tolist(), lv.tolist()))
    # intra-community non-edges: adding them reinforces the partition
    # (no membership change), so deleting them must restore it exactly
    C = _host(e0.C)
    pairs = [(u, v) for u in range(n) for v in range(u + 1, n)
             if (u, v) not in have and C[u] == C[v]][:5]
    u = np.array([p[0] for p in pairs])
    v = np.array([p[1] for p in pairs])
    w = np.ones(len(pairs), np.float32)
    svc.submit_update(gid, (u, v, w))
    svc.drain()
    assert float(svc.result(gid).graph.total_weight_2m()) \
        == float(e0.graph.total_weight_2m()) + 2 * len(pairs)
    svc.submit_update(gid, (u, v, -w))
    svc.drain()
    e2 = svc.result(gid)
    assert float(e2.graph.total_weight_2m()) \
        == float(e0.graph.total_weight_2m()), "round trip weight drifted"
    assert np.array_equal(_host(e2.graph.src),
                          _host(e0.graph.src)), "edge layout drifted"
    assert e2.n_communities == e0.n_communities
    assert e2.n_disconnected == 0
    assert abs(e2.q - e0.q) <= 1e-6, (e2.q, e0.q)


def _assert_vertex_round_trip(svc: CommunityService, seed: int):
    """Add wired vertices, remove them again: ``n_nodes``, the COO and
    the partition stats must come back exactly — vertex removals are true
    inverses of additions — and the freed vertex slots must be reusable
    (the same addition re-admits without re-bucketing)."""
    gid = "v-round-trip"
    svc.submit_detect(gid, synth_graph("ego_small", seed,
                                       device=svc.frontend.device))
    svc.drain()
    e0 = svc.result(gid)
    n = int(e0.graph.n_nodes)
    C = _host(e0.C)
    # wire each new vertex into one existing community (intra edges
    # reinforce the partition, so removal must restore it exactly)
    peers = [i for i in range(n) if C[i] == C[0]][:3]
    u = np.concatenate([np.full(len(peers), n), np.full(len(peers), n + 1)])
    v = np.array(peers * 2)
    w = np.ones(len(u), np.float32)
    grow = GraphUpdate(u=u, v=v, dw=w, add=2)
    svc.submit_update(gid, grow)
    svc.drain()
    e1 = svc.result(gid)
    assert int(e1.graph.n_nodes) == n + 2
    assert e1.n_disconnected == 0
    svc.submit_update(gid, GraphUpdate(remove=np.array([n, n + 1])))
    svc.drain()
    e2 = svc.result(gid)
    assert int(e2.graph.n_nodes) == n, "vertex capacity not reclaimed"
    assert np.array_equal(_host(e2.graph.src),
                          _host(e0.graph.src)), "edge layout drifted"
    assert np.array_equal(_host(e2.graph.w),
                          _host(e0.graph.w)), "weights drifted"
    assert e2.n_communities == e0.n_communities
    assert e2.n_disconnected == 0
    assert abs(e2.q - e0.q) <= 1e-6, (e2.q, e0.q)
    # capacity reuse: the freed slots admit the same addition again in
    # the same bucket
    svc.submit_update(gid, grow)
    svc.drain()
    e3 = svc.result(gid)
    assert e3.bucket == e2.bucket, "remove-then-add re-bucketed"
    assert int(e3.graph.n_nodes) == n + 2
    assert e3.n_disconnected == 0


# ---------------------------------------------------------------------------
# async driver: multi-tenant open-loop load generator
# ---------------------------------------------------------------------------

def tenant_specs(n_tenants: int, n_requests: int):
    """Skewed open-loop mix: tenant 0 is a burst-heavy whale submitting
    ~2^i x the rate of tenant i.  Returns (name, n, burst, gap_s)."""
    weights = [2 ** (n_tenants - 1 - i) for i in range(n_tenants)]
    total = sum(weights)
    specs = []
    for i, w in enumerate(weights):
        n = max(4, round(n_requests * w / total))
        burst = 12 if i == 0 else 1       # the whale slams, others trickle
        gap = 0.004 * (i + 1)
        specs.append((f"t{i}", n, burst, gap))
    return specs


async def run_async_traffic(svc: AsyncCommunityService, specs, *,
                            update_frac: float = 0.25, seed: int = 0,
                            verbose: bool = True):
    """Open-loop multi-tenant generator against the futures front end.

    Each tenant submits with ``block=False`` — overflow of its bounded
    queue is REJECTED and counted, never buffered, because open-loop
    arrivals don't slow down for a busy service.  A fraction of traffic
    becomes warm edge updates against that tenant's already-served
    graphs.  Returns per-tenant (name, submitted, accepted, rejected,
    updates) rows after a full drain.
    """
    dev = svc.frontend.device

    async def one_tenant(idx, spec):
        name, n, burst, gap = spec
        rng = np.random.default_rng(seed + idx)
        futs, rejected, updates = [], 0, 0
        for i in range(n):
            done = [f.graph_id for f in futs
                    if f.done() and f.exception() is None]
            if done and rng.random() < update_frac:
                gid = done[int(rng.integers(0, len(done)))]
                entry = svc.result(gid)
                if entry is not None:
                    await svc.submit_update(
                        gid, synth_updates(entry, seed + i), tenant=name)
                    updates += 1
            else:
                fam = FAMILIES[int(rng.integers(0, len(FAMILIES)))]
                gid = f"{name}-g{i}-{fam}"
                try:
                    futs.append(await svc.submit_detect(
                        gid, synth_graph(fam, seed + 131 * idx + i,
                                         device=dev),
                        tenant=name, block=False))
                except QueueFull:
                    rejected += 1
            if burst == 1 or (i + 1) % burst == 0:
                await asyncio.sleep(gap)
        return name, n, futs, rejected, updates

    outs = await asyncio.gather(
        *(one_tenant(i, s) for i, s in enumerate(specs)))
    await svc.drain()
    rows = []
    for name, n, futs, rejected, updates in outs:
        for f in futs:
            await f                       # every accepted request resolves
        rows.append((name, n, len(futs), rejected, updates))

    if verbose:
        rep = svc.metrics.report()
        print(f"{'tenant':<8}{'submitted':>10}{'accepted':>10}"
              f"{'rejected':>10}{'served':>8}{'p50_ms':>9}")
        for name, n, accepted, rejected, updates in rows:
            t = rep["tenants"][name]
            print(f"{name:<8}{n:>10}{accepted + updates:>10}"
                  f"{rejected:>10}{t['served']:>8}{t['p50_ms']:>9.1f}")
        print(f"aggregate: {rep['n_detect']} detect + {rep['n_update']} "
              f"updates, {rep['n_rejected']} rejected, "
              f"{rep['n_rebucketed']} re-bucketed, "
              f"{rep['graphs_per_s']:.1f} graphs/s")
    return rows


async def warm_async(svc: AsyncCommunityService):
    """Run every bucket's detect and update paths once before traffic."""
    dev = svc.frontend.device
    for i, fam in enumerate(FAMILIES):
        await svc.submit_detect(f"warm-{fam}",
                                synth_graph(fam, 10_000 + i, device=dev),
                                tenant="warm")
    await svc.drain()
    for fam in FAMILIES:
        e = svc.result(f"warm-{fam}")
        await svc.submit_update(f"warm-{fam}", synth_updates(e, 1),
                                tenant="warm")
        svc.engine.warm(e.bucket)
    svc.metrics.reset()


async def main_async(args):
    if args.smoke:
        # whale bursts 12 > bound 8: rejections are guaranteed; light
        # tenants keep >= bound accepted, so served ratio <= 40/8 = 5
        specs = [("whale", 40, 12, 0.004), ("mid", 24, 1, 0.004),
                 ("light", 12, 1, 0.008)]
    else:
        specs = tenant_specs(args.tenants, args.requests)
    config = ServiceConfig(
        sub_batch=args.sub_batch,
        detect=DetectOptions(louvain=LouvainConfig()), batch_size=args.batch,
        max_delay_s=args.max_delay_ms / 1e3,
        max_pending_per_tenant=args.max_pending,
    )
    async with AsyncCommunityService(config, device=args.device) as svc:
        await warm_async(svc)
        t0 = time.perf_counter()
        rows = await run_async_traffic(svc, specs,
                                       update_frac=args.update_frac,
                                       seed=args.seed)
        dt = time.perf_counter() - t0
        rep = svc.metrics.report()
        print(f"wall time {dt:.1f}s (after the warm-up)")

        if args.smoke:
            served = {name: rep["tenants"][name]["served"]
                      for name, *_ in rows}
            assert len(served) >= 3, f"expected >= 3 tenants, saw {served}"
            assert min(served.values()) > 0, f"starved tenant: {served}"
            ratio = max(served.values()) / min(served.values())
            assert ratio <= 6.0, f"served skew {ratio:.1f} > 6: {served}"
            assert rep["n_rejected"] > 0, "queue bound never enforced"
            assert svc.pending() == 0, "drain left work queued"
            # the paper's guarantee must survive the whole mixed workload
            bad = [gid for gid in list(svc.store._entries)
                   if svc.store.get(gid).n_disconnected != 0]
            assert not bad, f"disconnected communities served: {bad}"
            print(f"ASYNC SMOKE OK (served skew {ratio:.1f}x, "
                  f"{rep['n_rejected']} rejections)")
    return rep


# ---------------------------------------------------------------------------
# replay driver: open-loop harness + live exporter scrape
# ---------------------------------------------------------------------------

def _print_replay_report(rep: dict):
    p50 = rep["p50_ms"]
    p99 = rep["p99_ms"]
    print(f"replay @ {rep['rate']:.1f}/s: offered {rep['offered']}, "
          f"served {rep['served']}, rejected {rep['rejected']}, "
          f"failed {rep['failed']} (goodput {rep['goodput']:.2f}, "
          f"{rep['late_arrivals']} late arrivals)")
    if p50 is not None:
        print(f"latency    p50 {p50:8.1f} ms   p99 {p99:8.1f} ms")
    bd = rep.get("phase_breakdown")
    if bd:
        print("phase breakdown: " + "  ".join(
            f"{k} {v * 100:.1f}%" for k, v in sorted(bd.items())))
    for name, ph in rep.get("phases", {}).items():
        print(f"  {name:<16} ({ph['group']:<6}) "
              f"p50 {ph['p50_ms']:9.3f} ms   p99 {ph['p99_ms']:9.3f} ms   "
              f"n={ph['count']}")


def _assert_replay_scrape(parsed: dict, names: set):
    """The acceptance contract for a live mid-replay scrape: per-tenant
    served counters, per-phase latency histograms, compile hit/miss.

    The port's dispatch key is (bucket, tier, scan), with no batch width,
    so the replay's warm seed dispatches every key of the window once and
    the window records hits only; the reference's key carries the width,
    and its window records misses too.  So the scrape must carry the
    counter with its ``result`` label, and the caller checks the engine's
    own miss count, which the seed's first dispatches raise."""
    assert "repro_requests_served_total" in names, sorted(names)
    tenants = {dict(lk).get("tenant")
               for name, lk in parsed
               if name == "repro_requests_served_total"}
    assert len(tenants - {None}) >= 2, \
        f"expected per-tenant served counters, saw tenants {tenants}"
    assert "repro_span_duration_seconds_bucket" in names, sorted(names)
    phases = {dict(lk).get("phase")
              for name, lk in parsed
              if name == "repro_span_duration_seconds_count"}
    for want in ("submit", "queue-wait", "engine-dispatch", "resolve"):
        assert want in phases, f"phase {want!r} missing from {phases}"
    assert "repro_engine_compile_total" in names, sorted(names)
    results = {dict(lk).get("result")
               for name, lk in parsed
               if name == "repro_engine_compile_total"}
    assert results and results <= {"hit", "miss"}, \
        f"no compile hit/miss recorded: {results}"
    assert "repro_request_latency_seconds_count" in names, sorted(names)


async def main_replay_async(args):
    import urllib.request

    from repro_torch.service.replay import ReplayConfig, replay, sweep_rates
    from repro_torch.telemetry.prometheus import (metric_names,
                                                  parse_prometheus)

    base = ReplayConfig(
        rate=args.rate, duration_s=args.duration_s, seed=args.seed,
        n_tenants=max(2, args.tenants), update_frac=args.update_frac,
        pool_size=8 if args.smoke else 24,
    )
    config = ServiceConfig(
        sub_batch=args.sub_batch,
        detect=DetectOptions(louvain=LouvainConfig()), batch_size=args.batch,
        max_delay_s=args.max_delay_ms / 1e3,
        max_pending_per_tenant=args.max_pending,
        telemetry_enabled=True, exporter_port=0,
    )

    if args.sweep:
        rates = [float(r) for r in args.sweep.split(",")]
        out = sweep_rates(rates, base, config, log=print,
                          device=args.device)
        knee = out["knee_rate"]
        print("saturation knee: "
              + (f"{knee:.1f}/s" if knee is not None
                 else f"not reached up to {max(rates):.1f}/s"))
        return out

    async with AsyncCommunityService(config, device=args.device) as svc:
        rep = await replay(svc, base)
        # scrape the LIVE endpoint before teardown: the smoke contract is
        # that an external Prometheus could have collected this run
        url = svc.frontend.exporter.url
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        n_misses = svc.engine.n_compile_misses
    parsed = parse_prometheus(body)       # raises on malformed lines
    names = metric_names(parsed)
    _print_replay_report(rep)
    print(f"scraped {url}: {len(parsed)} samples, "
          f"{len(names)} metric families")

    if args.smoke:
        assert rep["offered"] > 0 and rep["served"] > 0, rep
        assert rep["failed"] == 0, f"{rep['failed']} requests failed"
        assert rep["p99_ms"] is not None, "no latency recorded"
        assert set(rep["phase_breakdown"]) == {"queue", "engine", "host"}
        assert abs(sum(rep["phase_breakdown"].values()) - 1.0) < 1e-6
        _assert_replay_scrape(parsed, names)
        assert n_misses > 0, "no compile miss recorded"
        print(f"REPLAY SMOKE OK ({rep['served']} served, "
              f"{len(parsed)} samples scraped)")
    return rep


# ---------------------------------------------------------------------------
# stream driver: temporal tracking over a streaming graph (async service)
# ---------------------------------------------------------------------------

async def _stream_planted(svc, *, smoke: bool):
    """Replay the planted lifecycle script window by window; returns the
    per-window lifecycle kinds actually observed."""
    from repro_torch.data.streams import planted_timeline_script

    g0, windows, expected = planted_timeline_script(
        device=svc.frontend.device)
    seen: list = []
    svc.subscribe_lifecycle(lambda evs: seen.extend(evs))
    # stamp the seed detect at t=0 so window snapshots start at t=1
    svc.frontend.set_snapshot_time("planted", 0.0)
    await svc.submit_detect("planted", g0)
    await svc.drain()
    for i, evs in enumerate(windows):
        fut = await svc.ingest_window("planted", evs, t=float(i + 1))
        await fut
    await svc.drain()

    snaps = svc.timeline_snapshots("planted")
    got = [sorted(e.kind for e in svc.lifecycle_events("planted")
                  if e.t == s.t and e.kind != "continuation")
           for s in snaps if s.t > 0]
    exp = [sorted(k) for k in expected]
    print(f"planted: {len(snaps)} snapshots, lifecycle per window "
          f"{[k or ['-'] for k in got]}")
    if smoke:
        assert got == exp, f"lifecycle mismatch: got {got}, want {exp}"
        assert all(s.n_disconnected == 0 for s in snaps), \
            [(s.t, s.n_disconnected) for s in snaps]
        m = svc.membership_at
        # mover (3) absorbed into target (0) at t=2, separated again at
        # t=3; clique 2 (vertex 2) dies at t=4; the t=5 newcomer exists
        assert m("planted", 3, 2.0) == m("planted", 0, 2.0)
        assert m("planted", 3, 1.5) != m("planted", 0, 1.5)
        assert m("planted", 3, 3.0) != m("planted", 0, 3.0)
        assert m("planted", 2, 3.0) is not None
        assert m("planted", 2, 4.0) is None
        assert m("planted", int(g0.n_nodes), None) is not None
        assert len(seen) >= 4, f"subscriber saw {len(seen)} events"
    return got


async def _stream_churn(svc, args, *, smoke: bool):
    """Removal-heavy event stream under deferred compaction; returns the
    events/s report."""
    from repro_torch.data.streams import graph_event_stream
    from repro_torch.graph import ring_of_cliques

    g0 = ring_of_cliques(n_cliques=6, clique_size=6,
                         device=svc.frontend.device)
    svc.frontend.set_snapshot_time("churn", 0.0)
    await svc.submit_detect("churn", g0)
    await svc.drain()
    horizon = 8.0 if smoke else args.duration_s
    window = 1.0
    stream = graph_event_stream(
        g0, rate=args.rate, seed=args.seed + 7,
        mix=(("edge_add", 0.3), ("edge_del", 0.1), ("vertex_add", 0.2),
             ("vertex_del", 0.4)),
        min_vertices=12)
    flushes0 = svc.store.n_compaction_flushes
    n_events = 0
    end = window
    buf: list = []
    t0 = time.perf_counter()
    for e in stream:
        if e.t >= horizon:
            break
        while e.t >= end:                  # commit every elapsed window
            fut = await svc.ingest_window("churn", buf, t=end)
            await fut
            buf, end = [], end + window
        buf.append(e)
        n_events += 1
    fut = await svc.ingest_window("churn", buf, t=end)
    await fut
    await svc.drain()
    dt = time.perf_counter() - t0

    snaps = svc.timeline_snapshots("churn")
    flushes = svc.store.n_compaction_flushes - flushes0
    report = dict(
        n_events=n_events, n_windows=len(snaps) - 1,
        events_per_s=n_events / dt if dt > 0 else 0.0,
        n_compaction_flushes=flushes,
        n_deferred_removed=int(svc.store.n_deferred_removed))
    print(f"churn stream: {n_events} events in {len(snaps) - 1} windows, "
          f"{report['events_per_s']:,.0f} events/s end-to-end, "
          f"{flushes} compaction flushes "
          f"({report['n_deferred_removed']} removals deferred)")
    if smoke:
        assert all(s.n_disconnected == 0 for s in snaps), \
            [(s.t, s.n_disconnected) for s in snaps]
        if svc.config.compact_window > 0:
            assert flushes >= 3, \
                f"want >= 3 compaction rounds, got {flushes}"
        # external-id contract: the latest snapshot answers membership_at
        # for every live external id, and retired ids answer None
        final = snaps[-1]
        for x, c in zip(final.ext.tolist(), final.cid.tolist()):
            assert svc.membership_at("churn", x) == c, (x, c)
        retired = ({int(x) for x in snaps[0].ext.tolist()}
                   - {int(x) for x in final.ext.tolist()})
        assert retired, "removal-heavy stream retired no vertices"
        for x in sorted(retired)[:8]:
            assert svc.membership_at("churn", x) is None, x
    return report


async def main_stream_async(args):
    import urllib.request

    from repro_torch.telemetry.prometheus import (metric_names,
                                                  parse_prometheus)

    config = ServiceConfig(
        sub_batch=args.sub_batch,
        detect=DetectOptions(louvain=LouvainConfig()), batch_size=4,
        max_delay_s=args.max_delay_ms / 1e3,
        update_batch_size=1,             # one window -> one snapshot
        timeline_enabled=True, compact_window=args.compact_window,
        telemetry_enabled=True, exporter_port=0,
    )
    async with AsyncCommunityService(config, device=args.device) as svc:
        got = await _stream_planted(svc, smoke=args.smoke)
        report = await _stream_churn(svc, args, smoke=args.smoke)
        # scrape the LIVE endpoint before teardown, like --replay --smoke
        url = svc.frontend.exporter.url
        body = urllib.request.urlopen(url, timeout=10).read().decode()
    parsed = parse_prometheus(body)
    names = metric_names(parsed)
    print(f"scraped {url}: {len(parsed)} samples, "
          f"{len(names)} metric families")

    if args.smoke:
        for want in ("repro_stream_events_ingested_total",
                     "repro_timeline_snapshots_total",
                     "repro_timeline_events_total",
                     "repro_stream_lag_seconds_bucket"):
            assert want in names, f"{want} missing from scrape"
        kinds = {dict(lk).get("kind") for name, lk in parsed
                 if name == "repro_timeline_events_total"}
        for want in ("merge", "split", "death", "birth"):
            assert want in kinds, f"no {want} events counted: {kinds}"
        print(f"STREAM SMOKE OK ({sum(len(k) for k in got)} planted "
              f"lifecycle events, {report['n_events']} churn events, "
              f"{report['n_compaction_flushes']} compaction flushes)")
    return report


# ---------------------------------------------------------------------------
# tiers driver: SLO-tiered portfolio — per-request quality/latency contracts
# ---------------------------------------------------------------------------

async def main_tiers_async(args):
    """Three tenants pinned to the three portfolio tiers submit the SAME
    graphs through the async service; per-tier contracts are checked on
    the stamped store entries and the live Prometheus scrape."""
    import urllib.request

    from repro_torch.core.portfolio import contract_for
    from repro_torch.telemetry.prometheus import (metric_names,
                                                  parse_prometheus)

    n_each = 6 if args.smoke else max(6, args.requests // 3)
    tiers = {"speed": "fast", "std": "standard", "quality": "max-quality"}
    config = ServiceConfig(
        sub_batch=args.sub_batch,
        detect=DetectOptions(louvain=LouvainConfig()),
        batch_size=args.batch, max_delay_s=args.max_delay_ms / 1e3,
        tenant_tiers=tuple(tiers.items()),
        deadline_tiers=(("fast", 0.02), ("standard", 0.5)),
        telemetry_enabled=True, exporter_port=0,
    )
    dev = args.device
    async with AsyncCommunityService(config, device=dev) as svc:
        # warm prologue: one detect per (family, tier) so reported
        # latencies reflect the steady state, not first dispatches
        for i, fam in enumerate(FAMILIES):
            for tname in tiers:
                await svc.submit_detect(
                    f"warm-{tname}-{fam}",
                    synth_graph(fam, 10_000 + i, device=dev), tenant=tname)
        await svc.drain()
        for fam in FAMILIES:
            # every configured tier dispatched once on this bucket
            # (engine.algorithms covers the three)
            e = svc.result(f"warm-std-{fam}")
            svc.engine.warm(e.bucket)
        svc.metrics.reset()

        t0 = time.perf_counter()
        futs = []
        for i in range(n_each):
            fam = FAMILIES[i % len(FAMILIES)]
            g = synth_graph(fam, args.seed + i, device=dev)
            for tname in tiers:        # the SAME graph at every tier
                futs.append((tname, i, await svc.submit_detect(
                    f"{tname}-g{i}-{fam}", g, tenant=tname)))
        await svc.drain()
        entries = {}
        for tname, i, fut in futs:
            entries[(tname, i)] = await fut
        dt = time.perf_counter() - t0

        # deadline auto-selection for an unpinned tenant: a tight
        # deadline lands on the fast tier, a loose one on the default
        f_tight = await svc.submit_detect(
            "anon-tight", synth_graph("ego_small", args.seed + 777,
                                      device=dev),
            tenant="anon", deadline_s=0.02)
        f_loose = await svc.submit_detect(
            "anon-loose", synth_graph("ego_small", args.seed + 778,
                                      device=dev),
            tenant="anon", deadline_s=30.0)
        # an explicit algorithm pin overrides the tenant mapping
        f_pin = await svc.submit_detect(
            "pin-maxq", synth_graph("ego_small", args.seed + 779,
                                    device=dev),
            tenant="speed", algorithm="max-quality")
        await svc.drain()
        e_tight, e_loose, e_pin = await f_tight, await f_loose, await f_pin

        rep = svc.metrics.report()
        url = svc.frontend.exporter.url
        body = urllib.request.urlopen(url, timeout=10).read().decode()
    parsed = parse_prometheus(body)
    names = metric_names(parsed)

    per_tier = {}
    print(f"{'tier':<12}{'tenant':<9}{'mean q':>9}{'disc':>6}{'p50_ms':>9}")
    for tname, tier in tiers.items():
        es = [entries[(tname, i)] for i in range(n_each)]
        row = dict(
            q=float(np.mean([e.q for e in es])),
            n_disconnected=int(sum(e.n_disconnected for e in es)),
            p50_ms=rep["tenants"][tname]["p50_ms"])
        per_tier[tier] = row
        print(f"{tier:<12}{tname:<9}{row['q']:>9.4f}"
              f"{row['n_disconnected']:>6}{row['p50_ms']:>9.1f}")
    print(f"{3 * n_each} tiered detects in {dt:.1f}s; deadline routing: "
          f"tight->{e_tight.algorithm} loose->{e_loose.algorithm} "
          f"pin->{e_pin.algorithm}")
    print(f"scraped {url}: {len(parsed)} samples, "
          f"{len(names)} metric families")

    if args.smoke:
        for tname, tier in tiers.items():
            for i in range(n_each):
                e = entries[(tname, i)]
                assert e.algorithm == tier, (tname, i, e.algorithm)
                c = contract_for(e.algorithm)
                if tier != "fast":
                    # the paper's invariant, per the tier contract
                    assert c.zero_disconnected and e.n_disconnected == 0, \
                        (tier, i, e.n_disconnected)
        # best-of-two makes this structural, not merely empirical
        for i in range(n_each):
            q_max = entries[("quality", i)].q
            q_std = entries[("std", i)].q
            assert q_max >= q_std - 1e-9, (i, q_max, q_std)
        assert e_tight.algorithm == "fast", e_tight.algorithm
        assert e_loose.algorithm == "standard", e_loose.algorithm
        assert e_pin.algorithm == "max-quality", e_pin.algorithm
        # the fast tier must actually be fast in steady state
        assert per_tier["fast"]["p50_ms"] <= 500.0, per_tier["fast"]
        # tier-labeled counters survive the live render -> HTTP -> parse
        assert "repro_detect_served_tier_total" in names, sorted(names)[:20]
        served_tiers = {dict(lk).get("tier") for name, lk in parsed
                        if name == "repro_detect_served_tier_total"}
        assert set(tiers.values()) <= served_tiers, served_tiers
        compile_tiers = {dict(lk).get("tier") for name, lk in parsed
                         if name == "repro_engine_compile_total"}
        assert set(tiers.values()) <= compile_tiers, compile_tiers
        print(f"TIERS SMOKE OK ({3 * n_each} tiered detects, "
              f"q_max {per_tier['max-quality']['q']:.4f} >= "
              f"q_std {per_tier['standard']['q']:.4f}, "
              f"fast p50 {per_tier['fast']['p50_ms']:.1f} ms)")
    return per_tier


# ---------------------------------------------------------------------------

def sharded_mesh(device: str):
    """The 2-rank mesh of ``--sharded`` on ``device``: two CPU ranks over
    gloo, two ranks sharing the one card over gloo (NCCL refuses two ranks
    on one card), or one card a rank over NCCL where there are two."""
    from repro_torch.launch import make_host_mesh, make_mesh

    if torch.device(device).type == "cpu":
        return make_host_mesh(2, device="cpu")
    if torch.cuda.device_count() < 2:
        return make_mesh(("cuda:0", "cuda:0"))
    return make_host_mesh(2)


def main_sharded(args):
    """Sharded single-graph detection end-to-end on a 2-rank mesh
    (:func:`sharded_mesh`): the engine's ``detect_sharded`` mode vs the
    single-device driver, with live halo telemetry through the Prometheus
    exporter.  The mesh's workers are closed before it returns.

    ``--sharded --smoke`` asserts the tentpole acceptance contract:
    bit-identical partitions (labels AND modularity) on every graph
    family, zero internally-disconnected communities on the reassembled
    labeling, and a live ``/metrics`` scrape carrying the halo-exchange
    counters (``repro_sharded_halo_bytes_total``,
    ``repro_sharded_ghost_vertices``,
    ``repro_sharded_device_sweeps_total``).
    """
    mesh = sharded_mesh(args.device)
    try:
        return _sharded_run(args, mesh)
    finally:
        mesh.close()


def _sharded_run(args, mesh):
    import urllib.request

    from repro_torch.core import (
        DetectOptions, disconnected_communities, louvain, modularity,
    )
    from repro_torch.graph import ring_of_cliques
    from repro_torch.graph.container import strip_padding
    from repro_torch.service.engine import BatchedLouvainEngine
    from repro_torch.telemetry.prometheus import (
        MetricsExporter, metric_names, parse_prometheus,
    )
    from repro_torch.telemetry.sinks import InMemorySink, Telemetry

    dev = args.device
    tel = Telemetry()
    sink = tel.register(InMemorySink())
    exporter = MetricsExporter(sink, port=0)
    cfg = LouvainConfig()
    engine = BatchedLouvainEngine(
        options=DetectOptions(louvain=cfg, mesh=mesh), telemetry=tel,
        sub_batch=args.sub_batch, device=dev)
    graphs = [
        ("ring", ring_of_cliques(n_cliques=12, clique_size=6, device=dev)),
        ("sbm", sbm_graph(n_nodes=220, n_blocks=5, p_in=0.4, p_out=0.02,
                          seed=args.seed, device=dev)[0]),
        ("grid", grid_graph(12, 16, device=dev)),
    ]
    report = {"graphs": [], "halo_bytes": 0.0}
    mesh.reports.clear()
    for name, g in graphs:
        t0 = time.perf_counter()
        res = engine.detect_sharded(g)
        t_sharded = time.perf_counter() - t0
        t0 = time.perf_counter()
        C1, _ = louvain(g, cfg, device=dev)
        t_single = time.perf_counter() - t0
        match = bool(np.array_equal(_host(C1), res.C))
        live = strip_padding(g.src, g.dst, g.w, g.ghost)
        q1 = float(modularity(*live, C1))
        det = disconnected_communities(
            *live, torch.from_numpy(res.C).to(g.device), g.n_nodes)
        row = dict(graph=name, match=match, n_communities=res.n_communities,
                   n_disconnected=int(det["n_disconnected"]),
                   q_sharded=res.q, q_single=q1,
                   t_sharded_s=t_sharded, t_single_s=t_single)
        report["graphs"].append(row)
        print(f"{name:>6}: parity={'OK' if match else 'MISMATCH'} "
              f"comms={res.n_communities} disc={row['n_disconnected']} "
              f"q={res.q:.4f} sharded={t_sharded * 1e3:.0f}ms "
              f"single={t_single * 1e3:.0f}ms")

    # scrape the LIVE endpoint (not sink internals): the counters must
    # survive the full render -> HTTP -> parse loop operators rely on
    body = urllib.request.urlopen(exporter.url, timeout=10).read().decode()
    parsed = parse_prometheus(body)
    names = metric_names(parsed)
    halo = sum(v for (n, lk), v in parsed.items()
               if n == "repro_sharded_halo_bytes_total")
    report["halo_bytes"] = halo
    # each rank's segment-reduce launches over the run (counted in the
    # worker; 0 on CPU ranks)
    report["rank_segreduce_launches"] = [
        sum(call[r]["segreduce_launches"] for call in mesh.reports)
        for r in range(mesh.size)]
    print(f"scraped {exporter.url}: {len(parsed)} samples, "
          f"halo bytes {halo:.0f}")
    exporter.close()

    if args.smoke:
        assert all(r["match"] for r in report["graphs"]), report["graphs"]
        assert all(r["q_sharded"] == r["q_single"]
                   for r in report["graphs"]), report["graphs"]
        assert all(r["n_disconnected"] == 0 for r in report["graphs"])
        for want in ("repro_sharded_halo_bytes_total",
                     "repro_sharded_ghost_vertices",
                     "repro_sharded_cut_edges",
                     "repro_sharded_device_sweeps_total"):
            assert want in names, f"{want} missing from scrape: {sorted(names)[:20]}"
        assert halo > 0, "halo-exchange byte counter never incremented"
        print(f"SHARDED SMOKE OK ({len(report['graphs'])} graphs "
              f"bit-identical on a 2-rank mesh)")
    return report


def main_churn(args):
    n_graphs = 9 if args.smoke else max(9, args.requests // 4)
    n_rounds = 6 if args.smoke else args.rounds
    update_batch = args.update_batch or args.batch
    config = ServiceConfig(
        sub_batch=args.sub_batch,
        detect=DetectOptions(louvain=LouvainConfig()), batch_size=args.batch,
        max_delay_s=args.max_delay_ms / 1e3,
        update_batch_size=update_batch,
    )
    svc = CommunityService(config=config, device=args.device)
    t0 = time.perf_counter()
    report = run_churn_traffic(svc, n_graphs=n_graphs, n_rounds=n_rounds,
                               seed=args.seed)
    print(f"wall time {time.perf_counter() - t0:.1f}s (first dispatches "
          "included)")

    if args.smoke:
        assert report["n_update"] >= n_graphs * n_rounds * 0.8, \
            f"churn served too few updates: {report['n_update']}"
        assert report["n_update_batches"] >= 1, \
            "no batched update dispatched"
        assert report["update_batch_mean"] > 1.0, \
            "update batches never exceeded width 1"
        assert report["n_deletions"] > 0, "no deletions applied"
        assert report["n_vertex_added"] > 0, "no vertices added"
        assert report["n_vertex_removed"] > 0, "no vertices removed"
        assert svc.frontend.pending_updates() == 0, \
            "drain left updates queued"
        # the paper's guarantee must survive deletions AND vertex churn,
        # not just additions
        bad = [gid for gid in list(svc.store._entries)
               if svc.store.get(gid).n_disconnected != 0]
        assert not bad, f"disconnected communities served: {bad}"
        _assert_round_trip(svc, seed=args.seed + 10_000)
        _assert_vertex_round_trip(svc, seed=args.seed + 20_000)
        print(f"CHURN SMOKE OK ({report['n_update']} updates, "
              f"{report['n_deletions']} deletions, "
              f"{report['n_vertex_added']}+/"
              f"{report['n_vertex_removed']}- vertices, "
              f"{report['n_update_batches']} batches)")
    return report


def main_chaos(args):
    """Resilient-serving driver: the same synthetic request families
    replayed twice — once fault-free for reference partitions, once under
    a deterministic :class:`FaultPlan` (engine raises, a hang bounded by
    the retry watchdog, store-commit failures, transient capacity errors,
    a crashing telemetry sink) with retries, a per-bucket circuit breaker
    and degraded fallbacks armed.  Then two focused phases: breaker
    open -> degraded stale serving -> half-open probe -> recovery, and a
    kill-and-restore round trip through the automatic checkpointer where
    the newest snapshot is torn (truncated ``arrays.npz``) and startup
    recovery must fall back to the previous durable step.

    ``--chaos --smoke`` asserts the acceptance contract: goodput under
    faults >= 0.8x the fault-free run, no permanently-pending future,
    every non-degraded result bit-identical to its fault-free partition
    with zero internally-disconnected communities, degraded results
    explicitly flagged (``quality='degraded'``, ``guarantee=False``),
    the breaker re-closing after cooldown with a fresh full-quality
    result, and post-restore warm updates resuming at the saved version.
    """
    import shutil
    import tempfile

    from repro_torch.service import (
        BreakerConfig, DegradedResult, FaultPlan, FaultSpec, RetryPolicy,
        ServiceFrontend,
    )

    dev = args.device
    n = 24 if args.smoke else args.requests
    workload = [(f"x{i}-{FAMILIES[i % 3]}",
                 synth_graph(FAMILIES[i % 3], args.seed + i, device=dev))
                for i in range(n)]

    # -- phase 1: fault-free reference run ---------------------------------
    cfg = ServiceConfig(
        sub_batch=args.sub_batch,
        detect=DetectOptions(louvain=LouvainConfig()),
        batch_size=args.batch, max_delay_s=args.max_delay_ms / 1e3)
    fe = ServiceFrontend(cfg, device=dev)
    futs = [(gid, fe.submit_detect(gid, g)) for gid, g in workload]
    fe.drain()
    base = {}
    for gid, fut in futs:
        e = fut.result(timeout=120)
        base[gid] = dict(C=np.asarray(e.C).copy(),
                         n_communities=e.n_communities, q=e.q,
                         n_disconnected=e.n_disconnected)
    fe.close()
    n_base = len(base)
    print(f"baseline: {n_base}/{n} served fault-free")

    # -- phase 2: the same workload under a deterministic fault plan -------
    plan = FaultPlan({
        "engine.detect": (FaultSpec(p=0.25, count=4),
                          FaultSpec(p=0.2, count=2, error="capacity")),
        "engine.detect.hang": FaultSpec(hang_s=5.0, count=1),
        "store.commit": FaultSpec(p=1.0, count=2),
        "telemetry.sink": FaultSpec(p=0.5, count=3),
    }, seed=args.seed)
    cfg = ServiceConfig(
        sub_batch=args.sub_batch,
        detect=DetectOptions(louvain=LouvainConfig()),
        batch_size=args.batch, max_delay_s=args.max_delay_ms / 1e3,
        telemetry_enabled=True,
        fault_plan=plan,
        retry=RetryPolicy(max_attempts=3, backoff_s=0.01, watchdog_s=1.5),
        breaker=BreakerConfig(failure_threshold=6, cooldown_s=0.3),
        degrade_enabled=True)
    fe = ServiceFrontend(cfg, device=dev)
    # fault-free warm prologue: chaos must not fire on first dispatches (a
    # cold start would trip the watchdog), so the engine's fault hook is
    # detached while every bucket runs once
    fe.engine.faults = None
    for i, fam in enumerate(FAMILIES):
        fe.submit_detect(f"warm-{fam}",
                         synth_graph(fam, 10_000 + i, device=dev))
    fe.drain()
    fe.engine.faults = plan
    fe.metrics.reset()

    futs = [(gid, fe.submit_detect(gid, g)) for gid, g in workload]
    fe.drain()
    good = degraded = failed = mismatched = not_done = 0
    for gid, fut in futs:
        if not fut.done():
            not_done += 1
            continue
        if fut.exception(timeout=5) is not None:
            failed += 1
            continue
        r = fut.result()
        if isinstance(r, DegradedResult):
            degraded += 1
            if args.smoke:
                assert r.guarantee is False, r
                assert r.stale or r.quality == "degraded", r
            continue
        good += 1
        b = base[gid]
        if (not np.array_equal(np.asarray(r.C), b["C"])
                or r.n_disconnected != 0):
            mismatched += 1
    n_retries = fe.resilience.n_retries
    n_splits = fe.resilience.n_batch_splits
    n_sink_errors = fe.telemetry.n_sink_errors
    print(f"chaos replay: {good} full-quality + {degraded} degraded + "
          f"{failed} failed of {n} ({not_done} pending), "
          f"{plan.injected_total()} faults injected "
          f"{dict(plan.injected)}, {n_retries} retries, "
          f"{n_splits} batch splits, {n_sink_errors} sink errors")
    fe.close()
    if args.smoke:
        assert not_done == 0, f"{not_done} futures permanently pending"
        assert good >= 0.8 * n_base, \
            f"goodput under faults {good}/{n_base} below the 0.8 floor"
        assert mismatched == 0, \
            f"{mismatched} non-degraded results differ from fault-free run"
        assert plan.injected_total() > 0, "fault plan never fired"
        assert n_retries > 0, "no retry recorded under an injecting plan"
        assert n_sink_errors > 0, "crashing sink never isolated"

    # -- phase 3: breaker opens, sheds stale, probes half-open, recloses ---
    g = synth_graph("ego_small", args.seed + 500, device=dev)
    thr = 3
    plan3 = FaultPlan(
        {"engine.detect": FaultSpec(p=1.0, count=thr, skip=1)}, seed=1)
    cfg3 = ServiceConfig(
        sub_batch=args.sub_batch,
        detect=DetectOptions(louvain=LouvainConfig()), batch_size=1,
        max_delay_s=0.0, fault_plan=plan3,
        retry=RetryPolicy(max_attempts=1),
        breaker=BreakerConfig(failure_threshold=thr, cooldown_s=0.4),
        degrade_enabled=True, degrade_modes=("stale",))
    fe3 = ServiceFrontend(cfg3, device=dev)
    f0 = fe3.submit_detect("brk", g)
    fe3.drain()
    e0 = f0.result(timeout=120)          # skip=1: the seed detect is clean
    stale_served = 0
    for i in range(thr + 1):             # thr failures open the breaker,
        fi = fe3.submit_detect("brk", g)  # the +1 is shed while open
        fe3.drain()
        ri = fi.result(timeout=120)
        if isinstance(ri, DegradedResult) and ri.mode == "stale":
            stale_served += 1
    states_open = dict(fe3.resilience.board.states())
    time.sleep(0.5)                      # past cooldown -> half-open probe
    f1 = fe3.submit_detect("brk", g)     # fault count exhausted: probe OK
    fe3.drain()
    e1 = f1.result(timeout=120)
    states_closed = dict(fe3.resilience.board.states())
    n_opens = fe3.resilience.board.n_opens
    print(f"breaker: {stale_served} stale-degraded while failing/open "
          f"{states_open} -> after cooldown {states_closed} "
          f"({n_opens} opens)")
    fe3.close()
    if args.smoke:
        assert stale_served == thr + 1, \
            f"expected {thr + 1} stale-degraded serves, got {stale_served}"
        assert "open" in states_open.values(), states_open
        assert set(states_closed.values()) == {"closed"}, states_closed
        assert not isinstance(e1, DegradedResult), \
            "post-recovery result still degraded"
        assert np.array_equal(np.asarray(e1.C), np.asarray(e0.C)), \
            "post-recovery partition differs from the healthy one"

    # -- phase 4: kill-and-restore through the automatic checkpointer ------
    ckdir = tempfile.mkdtemp(prefix="chaos-ckpt-")
    try:
        plan4 = FaultPlan(
            {"checkpoint.io": FaultSpec(p=1.0, count=1, skip=1)}, seed=2)
        cfg4 = ServiceConfig(
            sub_batch=args.sub_batch,
            detect=DetectOptions(louvain=LouvainConfig()), batch_size=4,
            fault_plan=plan4, autockpt_dir=ckdir, autockpt_period_s=999.0,
            autockpt_recover=False)
        fe4 = ServiceFrontend(cfg4, device=dev)
        gids = []
        for i, fam in enumerate(FAMILIES):
            gid = f"k{i}-{fam}"
            gids.append(gid)
            fe4.submit_detect(gid, synth_graph(fam, args.seed + 40 + i,
                                               device=dev))
        fe4.drain()
        fu = fe4.submit_update(gids[0], synth_updates(
            fe4.store.get(gids[0]), args.seed + 99))
        fe4.drain()
        fu.result(timeout=120)
        fe4.autockpt.snapshot(force=True)         # durable step (skip=1)
        saved = {gid: (fe4.store.get(gid).version,
                       np.asarray(fe4.store.get(gid).C).copy())
                 for gid in gids}
        fu = fe4.submit_update(gids[1], synth_updates(
            fe4.store.get(gids[1]), args.seed + 123))
        fe4.drain()
        fu.result(timeout=120)
        fe4.autockpt.snapshot(force=True)         # torn: arrays.npz cut
        n_torn = fe4.autockpt.n_torn
        fe4.autockpt.close(flush=False)           # simulated crash
        fe4.telemetry.close()

        cfg5 = ServiceConfig(
            sub_batch=args.sub_batch,
            detect=DetectOptions(louvain=LouvainConfig()), batch_size=4,
            autockpt_dir=ckdir, autockpt_period_s=999.0)
        fe5 = ServiceFrontend(cfg5, device=dev)
        restored = fe5.restored_step
        skipped = fe5.autockpt.n_corrupt_skipped
        entries_ok = all(
            fe5.store.get(gid) is not None
            and fe5.store.get(gid).version == saved[gid][0]
            and np.array_equal(np.asarray(fe5.store.get(gid).C),
                               saved[gid][1])
            for gid in gids)
        fu = fe5.submit_update(gids[0], synth_updates(
            fe5.store.get(gids[0]), args.seed + 7))
        fe5.drain()
        r = fu.result(timeout=120)
        print(f"restore: {n_torn} torn snapshot skipped "
              f"({skipped} corrupt steps), resumed at step {restored}, "
              f"entries intact={entries_ok}, warm update -> "
              f"v{r.version} disc={r.n_disconnected}")
        fe5.close()
        if args.smoke:
            assert n_torn == 1, "checkpoint.io fault never tore a snapshot"
            assert restored is not None and skipped >= 1, (restored, skipped)
            assert entries_ok, "restored entries differ from the saved step"
            assert r.version == saved[gids[0]][0] + 1, \
                f"warm update resumed at v{r.version}, " \
                f"want v{saved[gids[0]][0] + 1}"
            assert r.n_disconnected == 0
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    report = dict(n=n, good=good, degraded=degraded, failed=failed,
                  n_retries=n_retries, n_injected=plan.injected_total(),
                  n_opens=n_opens, restored_step=restored)
    if args.smoke:
        print(f"CHAOS SMOKE OK ({good}/{n} full-quality under "
              f"{report['n_injected']} injected faults, {degraded} "
              f"degraded, {n_retries} retries, breaker recovered, "
              f"kill-and-restore resumed at step {restored})")
    return report


def _check_device(device: str) -> str:
    """``device`` as given, after checking it can run: CUDA without a card
    raises rather than fall back to the CPU."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {device}: no CUDA device is available; pass "
            "--device cpu to run on the CPU")
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"--device must be cpu or cuda, got {device!r}")
    return device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small fixed workload + invariant checks (CI)")
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="futures front end + multi-tenant open-loop load")
    ap.add_argument("--churn", action="store_true",
                    help="fully-dynamic update-dominated workload with "
                         "deletions through the batched warm path")
    ap.add_argument("--replay", action="store_true",
                    help="open-loop load-replay harness with telemetry + "
                         "live exporter scrape")
    ap.add_argument("--stream", action="store_true",
                    help="temporal-tracking driver: planted lifecycle "
                         "script + removal-heavy event stream with "
                         "deferred compaction (async service)")
    ap.add_argument("--sharded", action="store_true",
                    help="sharded single-graph detection on a 2-rank "
                         "mesh: bit-identical parity vs the single-device "
                         "driver + live halo-telemetry scrape")
    ap.add_argument("--chaos", action="store_true",
                    help="resilience driver: deterministic fault injection "
                         "with retries/breaker/degraded fallbacks vs a "
                         "fault-free reference run, plus breaker recovery "
                         "and a kill-and-restore checkpoint round trip")
    ap.add_argument("--tiers", action="store_true",
                    help="SLO-tier driver: three tenants pinned to the "
                         "fast/standard/max-quality portfolio tiers over "
                         "the same graphs, deadline auto-selection, and "
                         "tier-labeled telemetry (async service)")
    ap.add_argument("--compact-window", type=int, default=4,
                    help="deferred-compaction threshold for --stream "
                         "(0 = compact immediately)")
    ap.add_argument("--rate", type=float, default=60.0,
                    help="offered arrival rate for --replay (req/s)")
    ap.add_argument("--duration-s", type=float, default=3.0,
                    help="arrival window for --replay (seconds)")
    ap.add_argument("--sweep", type=str, default=None,
                    help="comma-separated rate ladder for --replay; "
                         "reports the saturation knee")
    ap.add_argument("--update-batch", type=int, default=None,
                    help="warm-update batch width (--churn; default: "
                         "--batch)")
    ap.add_argument("--rounds", type=int, default=10,
                    help="churn rounds over the resident graphs (--churn)")
    ap.add_argument("--requests", type=int, default=120)
    ap.add_argument("--tenants", type=int, default=3,
                    help="tenant count for the --async load mix")
    ap.add_argument("--max-pending", type=int, default=12,
                    help="per-tenant queue bound (--async only; the sync "
                         "pump driver is closed-loop and keeps the "
                         "ServiceConfig default)")
    ap.add_argument("--update-frac", type=float, default=0.3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-delay-ms", type=float, default=25.0)
    ap.add_argument("--sub-batch", type=int, default=None,
                    help="the engine's tile width (default: auto, 1 on "
                         "the CPU and 8 on CUDA)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where every service, graph and mesh runs "
                         "('cuda', the default, raises without a card; "
                         "'cpu' for the CPU)")
    args = ap.parse_args(argv)
    args.device = _check_device(args.device)

    if args.smoke:
        args.batch = 6
        args.update_frac = 0.35
        if not args.async_:
            args.requests = 36

    if args.tiers:
        return asyncio.run(main_tiers_async(args))

    if args.sharded:
        return main_sharded(args)

    if args.chaos:
        if args.smoke:
            args.requests = 24
        return main_chaos(args)

    if args.replay:
        if args.smoke:
            args.rate = 50.0
            args.duration_s = 1.5
        return asyncio.run(main_replay_async(args))

    if args.stream:
        if args.smoke:
            args.rate = 40.0      # matched to the >= 3-flush assertion
        return asyncio.run(main_stream_async(args))

    if args.async_:
        if args.smoke:
            args.max_pending = 8    # whale bursts of 12 must overflow
        return asyncio.run(main_async(args))

    if args.churn:
        return main_churn(args)

    svc = CommunityService(
        LouvainConfig(), batch_size=args.batch,
        max_delay_s=args.max_delay_ms / 1e3, sub_batch=args.sub_batch,
        device=args.device,
    )
    t0 = time.perf_counter()
    report = run_traffic(svc, n_requests=args.requests,
                         update_frac=args.update_frac, seed=args.seed)
    print(f"wall time {time.perf_counter() - t0:.1f}s (warm-up included)")

    if args.smoke:
        buckets = {k[0] for k in svc.engine.cache_keys()}
        assert len(buckets) >= 3, f"expected >= 3 buckets, saw {buckets}"
        assert report["n_update"] > 0, "no warm updates served"
        assert report["p99_ms"] is not None, "no latency recorded"
        # the paper's guarantee must survive the whole mixed workload,
        # including every delta-screened update
        bad = [gid for gid in list(svc.store._entries)
               if svc.store.get(gid).n_disconnected != 0]
        assert not bad, f"disconnected communities served: {bad}"
        print("SMOKE OK")
    return report


if __name__ == "__main__":
    main()
