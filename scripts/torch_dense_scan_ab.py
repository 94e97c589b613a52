"""Paired timing of the port's small-graph paths, one tree a process.

Two versions of ``repro_torch`` are compared on one card by running this
script once a version, alternating them in one command (A, B, B, A):

    python scripts/torch_dense_scan_ab.py --src A/src --label parent \
        --cli src/repro_torch/launch/serve_communities.py
    python scripts/torch_dense_scan_ab.py --src src --label change

``--src`` is the ``src`` directory whose ``repro_torch`` is imported;
``--cli`` a ``serve_communities.py`` loaded by path against that package
(for a tree without the CLI).  Each run prints one JSON line with, on the
card (``chip_smoke.py``'s graphs):

* ``dense_detect``: ``detect()`` with ``scan='dense'`` on phase 3's graph
  (``nv = 1025``), for the standard tier with ``sp-pj`` and with
  ``refine`` and for max-quality: each the median wall of ``--reps``
  calls after one warm call, its segment-reduce (B.1) launches and a
  digest of its labels (equal digests: the same partition);
* ``batches``: the engine's standard ``detect_batch`` of phase 6's two
  families of 32, each the median wall of three after ``warm(bucket)``,
  with its B.1 launches;
* ``tiers``: the CLI's ``--tiers`` on the smoke's workload (``--batch 6
  --requests 18``, six graphs at each tier) without the smoke's
  assertions, twice: each tier's p50 ms (the smoke asserts the fast
  tier's p50 <= 500 ms).

Walls are the host's clock around a synchronized call.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import io
import json
import statistics
import sys
import time
from pathlib import Path


def _synced(fn):
    import torch

    from repro_torch.kernels.segsum import segreduce_sorted_cuda

    torch.cuda.synchronize()
    segreduce_sorted_cuda.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, segreduce_sorted_cuda.launches


DENSE_RUNS = (("standard", "sp-pj"), ("standard", "refine"),
              ("max-quality", "sp-pj"))


def dense_detect(reps: int) -> dict:
    """Each of :data:`DENSE_RUNS` (tier, split policy): its median wall,
    walls, B.1 launches, labels digest and modularity."""
    from repro_torch.core import DetectOptions, LouvainConfig, detect
    from repro_torch.graph import sbm_graph

    g = sbm_graph(1024, 16, 0.2, 0.003, seed=3, n_cap=1024, m_cap=16384,
                  device="cuda")[0]
    out = {}
    for algorithm, split in DENSE_RUNS:
        opts = DetectOptions(algorithm=algorithm, scan="dense",
                             louvain=LouvainConfig(split=split))
        detect(g, options=opts)
        walls, launches, res = [], None, None
        for _ in range(reps):
            res, wall, launches = _synced(lambda: detect(g, options=opts))
            walls.append(wall)
        digest = hashlib.sha256(res.labels.cpu().numpy().tobytes())
        out[f"{algorithm}/{split}"] = dict(
            median_s=statistics.median(walls), walls_s=walls,
            launches=launches, labels_sha256=digest.hexdigest()[:16],
            modularity=res.modularity)
    return out


def batches() -> dict:
    from repro_torch.graph import sbm_graph
    from repro_torch.service import BatchedLouvainEngine, Bucket
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
    engine = BatchedLouvainEngine()
    out = {}
    for name, bucket, graphs in (("Bucket(1024, 16384)",
                                  Bucket(1024, 16384), dense),
                                 ("Bucket(64, 2048)", ego, egos)):
        engine.warm(bucket)
        walls, launches = [], None
        for _ in range(3):
            _, wall, launches = _synced(lambda: engine.detect_batch(graphs))
            walls.append(wall)
        out[name] = dict(median_s=statistics.median(walls), walls_s=walls,
                         launches=launches,
                         scan=engine.scan_for(bucket))
    return out


def tiers(cli) -> list:
    if cli is None:
        from repro_torch.launch import serve_communities as sc
    else:
        spec = importlib.util.spec_from_file_location("_ab_cli", cli)
        sc = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sc)
    runs = []
    for _ in range(2):
        with contextlib.redirect_stdout(io.StringIO()):
            per_tier = sc.main(["--tiers", "--batch", "6", "--requests",
                                "18", "--device", "cuda"])
        runs.append({t: row["p50_ms"] for t, row in per_tier.items()})
    return runs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="the src directory whose repro_torch to import")
    ap.add_argument("--cli", default=None,
                    help="a serve_communities.py to load by path")
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dense-only", action="store_true",
                    help="time the dense detect() runs only")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    import repro_torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    _build.build()
    rep = dict(label=args.label, package=str(Path(repro_torch.__file__)
                                             .parent),
               dense_detect=dense_detect(args.reps))
    if not args.dense_only:
        rep.update(batches=batches(), tiers=tiers(args.cli))
    print(json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
