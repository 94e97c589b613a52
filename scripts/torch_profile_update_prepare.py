#!/usr/bin/env python
"""Time and profile the host fold of one update batch (``core/dynamic.py``
steps 0-1, ``prepare_graph_update``) on ``chip_smoke.py``'s phase-4
workload.

The graph is ``rmat_graph(scale, edge_factor=16, seed=1)`` and the batch
is phase 4's (``chip_smoke.churn_batch``: 1,024 vertices removed, 1,024
added each wired to 2, 32,768 edges deleted, 16,384 inserted), from the
labels of a default ``detect()`` (the batch needs ``--scale`` 13 or
more).  Prints the card (``nvidia-smi`` name and power limit), the numpy
and torch versions, the fold's wall seconds, and ``cProfile``'s top
functions by own time.

Usage (from the repository root):
  python scripts/torch_profile_update_prepare.py [--scale 21]
      [--device cuda|cpu] [--top 25]
"""
from __future__ import annotations

import argparse
import cProfile
import pathlib
import pstats
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.core import detect  # noqa: E402
from repro_torch.core.dynamic import prepare_graph_update  # noqa: E402
from repro_torch.graph import rmat_graph  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    card = chip_smoke.card_line() if args.device == "cuda" else "cpu"
    print(f"{card}  numpy {np.__version__}  torch {torch.__version__}",
          flush=True)
    t0 = time.perf_counter()
    g = rmat_graph(scale=args.scale, edge_factor=16, seed=1,
                   device=args.device)
    print(f"graph: {time.perf_counter() - t0} s, m_cap={g.m_cap}",
          flush=True)
    labels = detect(g, device=args.device).labels
    upd, _, _ = chip_smoke.churn_batch(g, seed=21, remove=1024, add=1024,
                                       delete=32768, insert=16384)
    prof = cProfile.Profile()
    prof.enable()
    t0 = time.perf_counter()
    prepare_graph_update(g, labels, upd)
    if g.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.disable()
    print(f"prepare_graph_update: {wall} s", flush=True)
    pstats.Stats(prof).sort_stats("tottime").print_stats(args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
