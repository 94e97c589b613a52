"""Paired timing of the engine's batches at several tile widths, one tree
a process.

Two versions of ``repro_torch`` are compared on one card by running this
script once a version, alternating them in one command (A, B, B, A):

    python scripts/torch_tile_ab.py --src A/src --label parent
    python scripts/torch_tile_ab.py --src src --label change

``--src`` is the ``src`` directory whose ``repro_torch`` is imported.
Each run prints one JSON line: for each of ``chip_smoke.py`` phase 6's
two families of 32 (``Bucket(1024, 16384)`` and the ego-nets of
``Bucket(64, 2048)``), each ``--tiers`` entry (default ``standard``) and
each ``--widths`` entry, keyed ``"<tier> <width>"``, the engine's
``detect_batch`` after ``warm(bucket)``: the median wall of ``--reps``
batches, graphs/s, the segment-reduce (B.1) and dense-kernel launches a
batch, the route, and a digest of every graph's labels, stats and Q
(equal digests: the same results).  A tree whose engine takes no
``sub_batch`` (before the tile) runs its one route and reports it as
width ``"loop"``.  Walls are the host's clock around a synchronized
call.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path


def families():
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
    for name, bucket, graphs in families():
        rep["batches"][name] = {
            f"{tier} {w}": run_width(w, bucket, graphs, args.reps, tier)
            for tier in args.tiers.split(",") for w in widths}
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
