"""The fast tier's latency in ``serve_communities --tiers --smoke``, and
where it goes, for one or more trees in turns.

    python scripts/torch_tiers_latency.py [--src DIR ...] [--rounds R] \
        [--runs N] [--device cuda|cpu] [--timeline] [--cells]

Each ``--src`` is the root of a checkout (default: this one); its
``src/repro_torch`` is imported in a process of its own.  The trees take
turns, ``--rounds`` times; each process runs the smoke ``--runs + 1``
times (the first builds the kernels and warms it) and prints one JSON
line a run: the three tiers' p50 ms as the smoke reports them (the smoke
asserts the fast tier's <= 500 ms), whether its assertions held, and its
wall.  ``--timeline`` adds, for the first measured run of each process,
every batch the service executed: its start and length in ms, bucket,
tier and size.  ``--cells`` adds, per process, ``run_detection``'s median
wall of 7 calls (after one warm call) on each smoke family at each tier,
with the family's graph as ``synth_graph(family, 3)`` makes it.  Walls
are the host's clock around synchronized work.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _child(args) -> None:
    sys.path.insert(0, str(Path(args.src[0]).resolve() / "src"))
    import torch

    from repro_torch.core.api import DetectOptions
    from repro_torch.core.louvain import LouvainConfig
    from repro_torch.core.portfolio import run_detection
    from repro_torch.launch import serve_communities as sc
    from repro_torch.service import frontend as fe

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    batches, t_run = [], [0.0]
    execute = fe.ServiceFrontend._execute_detects

    def timed_execute(self, bucket, reqs):
        t0 = time.perf_counter()
        out = execute(self, bucket, reqs)
        sync()
        batches.append(dict(start_ms=(t0 - t_run[0]) * 1e3,
                            ms=(time.perf_counter() - t0) * 1e3,
                            bucket=str(bucket), tier=reqs[0].algorithm,
                            n=len(reqs)))
        return out

    fe.ServiceFrontend._execute_detects = timed_execute
    for k in range(args.runs + 1):
        batches.clear()
        buf, ok = io.StringIO(), True
        t_run[0] = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                sc.main(["--tiers", "--smoke", "--device", args.device])
        except AssertionError:
            ok = False
        wall = time.perf_counter() - t_run[0]
        rows = buf.getvalue().splitlines()[1:4]
        if k == 0:
            continue
        rec = dict(tree=args.label, run=k, smoke_ok=ok, wall_s=wall,
                   **{f"{r.split()[0]}_p50_ms": float(r.split()[-1])
                      for r in rows})
        if args.timeline and k == 1:
            rec["batches"] = list(batches)
        print(json.dumps(rec), flush=True)
    if not args.cells:
        return
    for fam in sc.FAMILIES:
        g = sc.synth_graph(fam, 3, device=args.device)
        for alg in ("fast", "standard", "max-quality"):
            opts = DetectOptions(louvain=LouvainConfig(), algorithm=alg)
            run_detection(g, opts)
            walls = []
            for _ in range(7):
                t0 = time.perf_counter()
                run_detection(g, opts)
                sync()
                walls.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps(dict(tree=args.label, family=fam, nv=g.nv,
                                  tier=alg, median_ms=statistics.median(walls),
                                  min_ms=min(walls))), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=None,
                    help="root of a checkout (repeat for turns)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--cells", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--label", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(args)
        return 0
    srcs = args.src or [str(ROOT)]
    rc = 0
    for _ in range(args.rounds):
        for src in srcs:
            cmd = [sys.executable, __file__, "--child", "--src", src,
                   "--label", src, "--runs", str(args.runs),
                   "--device", args.device]
            cmd += ["--timeline"] if args.timeline else []
            cmd += ["--cells"] if args.cells else []
            rc |= subprocess.run(cmd).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
