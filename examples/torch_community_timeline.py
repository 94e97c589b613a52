"""Scenario: tracking how communities evolve in a changing graph, on the
PyTorch port.

A moderation/analytics stack doesn't just want *today's* communities —
it wants to know when a cluster absorbed another, when one fractured,
and where a given account sat three windows ago.  This walks the
temporal-tracking subsystem end to end on the planted lifecycle script
(four cliques staged through merge -> split -> death -> birth):

1. a seed detect becomes snapshot t=0; five event windows then stream
   through ``ingest_window`` — each window folds into ONE warm update
   and commits ONE snapshot, with the zero-disconnected-communities
   invariant intact at every boundary;
2. a lifecycle subscription receives merge/split/death/birth events as
   they are decided by the weighted-Jaccard matcher;
3. ``membership_at(graph_id, external_id, t)`` answers point-in-time
   queries in STABLE external-id space — internal compactions from the
   vertex removals never leak into the answers;
4. ``community_timeline(cid)`` replays one community's life: origin,
   parents, size trajectory, time of death;
5. the whole temporal state checkpoints and restores —
   ``membership_at`` answers are identical afterwards and ingest
   resumes where it left off.

The services and the graph live on ``--device`` (default ``cuda``).

  PYTHONPATH=src python examples/torch_community_timeline.py [--device cpu]
"""
import argparse
import asyncio
import tempfile

from repro_torch.data.streams import planted_timeline_script
from repro_torch.service import AsyncCommunityService, ServiceConfig
from repro_torch.timeline import (
    restore_service_checkpoint, save_service_checkpoint,
)


def show_events(events):
    for ev in events:
        extra = f" parents={list(ev.parents)}" if ev.parents else ""
        print(f"    t={ev.t:.1f} {ev.kind:<12} community={ev.community}"
              f"{extra} size={ev.size}")


async def main_async(dev):
    g0, windows, expected = planted_timeline_script(device=dev)
    cfg = ServiceConfig(timeline_enabled=True, update_batch_size=1,
                        telemetry_enabled=False)

    async with AsyncCommunityService(cfg, device=dev) as svc:
        # 2. push notifications: the matcher's decisions, as they happen
        svc.subscribe_lifecycle(lambda evs: show_events(
            [e for e in evs if e.kind != "continuation"]))

        # 1. seed detect at t=0, then one snapshot per event window
        svc.frontend.set_snapshot_time("g", 0.0)
        await (await svc.submit_detect("g", g0))
        print(f"seeded {int(g0.n_nodes)} vertices, "
              f"{len(svc.timeline_snapshots('g')[-1].ext)} tracked")
        for i, evs in enumerate(windows):
            print(f"  window {i} ({len(evs)} events) ->")
            fut = await svc.ingest_window("g", evs, t=float(i + 1))
            await fut
        snaps = svc.timeline_snapshots("g")
        assert all(s.n_disconnected == 0 for s in snaps)
        print(f"{len(snaps)} snapshots, all with zero internally-"
              "disconnected communities")

        # 3. point-in-time membership in external-id space.  Cliques are
        # interleaved (clique k = ids congruent to k mod 4): vertex 3 is
        # in the mover clique, vertex 0 in the merge target, vertex 2 in
        # the clique that dies at t=4.
        m = svc.membership_at
        print("\nmembership_at probes (external id, time -> community):")
        for ext, t in [(3, 0.5), (3, 2.0), (0, 2.0), (3, 3.0),
                       (2, 3.0), (2, 4.0), (int(g0.n_nodes), None)]:
            label = "latest" if t is None else f"t={t}"
            print(f"    vertex {ext:>2} @ {label:<6} -> {m('g', ext, t)}")
        assert m("g", 3, 2.0) == m("g", 0, 2.0)       # merged at t=2
        assert m("g", 3, 3.0) != m("g", 0, 3.0)       # split back at t=3
        assert m("g", 2, 4.0) is None                 # removed at t=4

        # 4. one community's recorded life
        dead_cid = m("g", 2, 3.0)
        tl = svc.community_timeline(dead_cid)
        print(f"\ncommunity {tl.cid}: origin={tl.origin} "
              f"born_t={tl.born_t} dead_t={tl.dead_t}")
        print("    (t, size, weight) rows:", list(tl.rows))

        # 5. checkpoint the entire temporal state and restore elsewhere
        with tempfile.TemporaryDirectory() as d:
            step = save_service_checkpoint(svc.frontend, d)
            async with AsyncCommunityService(cfg, device=dev) as svc2:
                restore_service_checkpoint(svc2.frontend, d)
                same = all(
                    svc.membership_at("g", int(e), s.t)
                    == svc2.membership_at("g", int(e), s.t)
                    for s in snaps for e in s.ext)
                print(f"\ncheckpoint step {step} restored: membership_at "
                      f"identical = {same}")
                assert same

    print("\ndone")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    asyncio.run(main_async(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
