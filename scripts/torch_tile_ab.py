"""Paired timing of the engine's batches at several tile widths, one tree
a process.

Two versions of ``repro_torch`` are compared on one card by running this
script once a version, alternating them in one command (A, B, B, A):

    python scripts/torch_tile_ab.py --src A/src --label parent
    python scripts/torch_tile_ab.py --src src --label change

``--src`` is the ``src`` directory whose ``repro_torch`` is imported.
Each run prints one JSON line: for each of ``chip_smoke.py`` phase 6's
families of 32 that ``--families`` names (``dense``, the default: the
dense scan's ``Bucket(1024, 16384)`` and the ego-nets of ``Bucket(64,
2048)``; ``sortscan``: the R-MAT scale-12 graphs of ``Bucket(4096,
65536)`` and the sparse SBMs of ``Bucket(1024, 4096)``,
``chip_smoke.sortscan_families``; or ``all``), each ``--tiers`` entry
(default ``standard``) and
each ``--widths`` entry, keyed ``"<tier> <width>"``, the engine's
``detect_batch`` after ``warm(bucket)``: the median wall of ``--reps``
batches, graphs/s, the segment-reduce (B.1) and dense-kernel launches a
batch, the route, and a digest of every graph's labels, stats and Q
(equal digests: the same results).  A tree whose engine takes no
``sub_batch`` (before the tile) runs its one route and reports it as
width ``"loop"``, and a tree whose engine runs a bucket's tier on the
loop at every width reports each width's route as "loop".  Walls are the
host's clock around a synchronized call.

``--updates`` times the engine's ``update_batch`` instead, keyed
``"update <width>"``: each family's 32 churn items of ``chip_smoke.py``
phase 6 (``churn_batch`` at ``UPDATE_CHURN``, from the standard labels of
``detect_batch``; an item that does not fit its bucket is left out and
listed), prepared once by a ``ResultStore`` and run after
``warm_updates(bucket)``.  A tree whose ``update_batch`` has no tile runs
the loop at every width, and the digests of the two trees must be equal.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path


def families(kind: str):
    """``(name, bucket, graphs, churn)`` of each family of ``kind``."""
    churn = _chip_smoke().UPDATE_CHURN
    out = []
    if kind in ("dense", "all"):
        out += [f + (c,) for f, c in zip(dense_families(), churn[:2])]
    if kind in ("sortscan", "all"):
        out += [f + (c,) for f, c in zip(_chip_smoke().sortscan_families(),
                                         churn[2:])]
    return out


def dense_families():
    from repro_torch.graph import sbm_graph
    from repro_torch.service import Bucket
    from repro_torch.service.buckets import admit

    dense, seed = [], 3
    while len(dense) < 32:
        try:
            dense.append(sbm_graph(1024, 16, 0.2, 0.003, seed=seed,
                                   n_cap=1024, m_cap=16384,
                                   device="cuda")[0])
        except ValueError:      # more directed edges than m_cap
            pass
        seed += 1
    ego = Bucket(64, 2048)
    egos = [admit(sbm_graph(56, 4, 0.7, 0.08, seed=s, device="cuda")[0],
                  [ego])[0] for s in range(32)]
    return (("Bucket(1024, 16384)", Bucket(1024, 16384), dense),
            ("Bucket(64, 2048)", ego, egos))


def _digest(results) -> str:
    h = hashlib.sha256()
    for r in results:
        h.update(r.C.tobytes())
        h.update(repr((r.n_communities, r.n_disconnected, r.fraction,
                       r.passes, r.sweeps, r.split_moved, r.q)).encode())
    return h.hexdigest()[:16]


def _dense_launches() -> int:
    try:
        from repro_torch.kernels.dense_sweep import kernel_launches
    except ImportError:
        return 0
    return sum(kernel_launches().values())


def run_width(width, bucket, graphs, reps: int, tier: str) -> dict:
    import torch

    from repro_torch.kernels.segsum import segreduce_sorted_cuda
    from repro_torch.service import BatchedLouvainEngine

    engine = (BatchedLouvainEngine(algorithms=(tier,)) if width == "loop"
              else BatchedLouvainEngine(sub_batch=width, algorithms=(tier,)))
    engine.warm(bucket)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        segreduce_sorted_cuda.launches = 0
        dense0 = _dense_launches()
        t0 = time.perf_counter()
        res = engine.detect_batch(graphs, algorithm=tier)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        seg, dense = segreduce_sorted_cuda.launches, _dense_launches() - dense0
    wall = statistics.median(walls)
    info = engine.last_detect_info
    return dict(median_s=wall, walls_s=walls, graphs_per_s=len(graphs) / wall,
                segreduce_launches=seg, dense_launches=dense,
                route=getattr(info, "route", "loop"),
                sweeps=sum(r.sweeps for r in res), digest=_digest(res))


def _update_digest(results) -> str:
    h = hashlib.sha256()
    for r in results:
        h.update(r.C.tobytes())
        h.update(repr((r.n_communities, r.n_disconnected, r.fraction,
                       r.iterations, r.q, r.n_affected,
                       r.split_moved)).encode())
    return h.hexdigest()[:16]


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` (phase 6's churn)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def update_items(graphs, churn):
    """``(items, skipped seeds)``: the churn items of ``graphs`` at their
    standard labels, prepared by a store on the card."""
    churn_batch = _chip_smoke().churn_batch

    from repro_torch.service import BatchedLouvainEngine, ResultStore
    from repro_torch.service.store import CapacityExceeded

    labels = BatchedLouvainEngine(sub_batch=1).detect_batch(graphs)
    store, items, skipped = ResultStore(), [], []
    for i, (g, r) in enumerate(zip(graphs, labels)):
        store.put(f"g{i}", g, r.C, n_communities=r.n_communities,
                  n_disconnected=r.n_disconnected, q=r.q)
        try:
            upd = churn_batch(g, seed=100 + i, remove=churn[0], add=churn[1],
                              delete=churn[2], insert=churn[3])[0]
            p = store.prepare_update(f"g{i}", upd)
        except (ValueError, AssertionError, CapacityExceeded):
            skipped.append(100 + i)
            continue
        items.append((p.graph, p.C_prev, p.touched))
    return items, skipped


def run_updates(width, bucket, items, reps: int) -> dict:
    import torch

    from repro_torch.kernels.segsum import segreduce_sorted_cuda
    from repro_torch.service import BatchedLouvainEngine

    engine = BatchedLouvainEngine(sub_batch=width)
    engine.warm_updates(bucket)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        segreduce_sorted_cuda.launches = 0
        dense0 = _dense_launches()
        t0 = time.perf_counter()
        res = engine.update_batch(items)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        seg, dense = segreduce_sorted_cuda.launches, _dense_launches() - dense0
    wall = statistics.median(walls)
    info = engine.last_update_info
    return dict(median_s=wall, walls_s=walls, graphs_per_s=len(items) / wall,
                segreduce_launches=seg, dense_launches=dense,
                route=getattr(info, "route", "loop"),
                sweeps=sum(r.iterations for r in res),
                affected=sum(r.n_affected for r in res),
                digest=_update_digest(res))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="the src directory whose repro_torch to import")
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--widths", default="1,8,32",
                    help="comma-separated tile widths")
    ap.add_argument("--tiers", default="standard",
                    help="comma-separated tiers")
    ap.add_argument("--updates", action="store_true",
                    help="time update_batch of the churn items instead")
    ap.add_argument("--families", default="dense",
                    choices=("dense", "sortscan", "all"),
                    help="phase 6's dense-scan families, its sortscan "
                    "ones, or both")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import inspect

    import torch

    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.service import BatchedLouvainEngine

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    _build.build()
    tiled = "sub_batch" in inspect.signature(
        BatchedLouvainEngine.__init__).parameters
    widths = [int(w) for w in args.widths.split(",")] if tiled else ["loop"]
    rep = dict(label=args.label,
               package=str(Path(repro_torch.__file__).parent), batches={})
    for name, bucket, graphs, churn in families(args.families):
        if args.updates:
            items, skipped = update_items(graphs, churn)
            rep["batches"][name] = dict(skipped_seeds=skipped, **{
                f"update {w}": run_updates(w, bucket, items, args.reps)
                for w in widths})
            continue
        rep["batches"][name] = {
            f"{tier} {w}": run_width(w, bucket, graphs, args.reps, tier)
            for tier in args.tiers.split(",") for w in widths}
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
