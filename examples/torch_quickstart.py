"""Quickstart on the PyTorch port: GSP-Louvain end to end on a web-like
graph.

Runs plain parallel Louvain and GSP-Louvain on the same graph, shows the
internally-disconnected communities the default leaves behind and that the
Split-Pass approach removes them at equal quality — the paper's result in
a few lines, on the card (``--device cuda``, the default) or the CPU.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core import (
    LouvainConfig, disconnected_communities, louvain, modularity,
)
from repro_torch.graph import rmat_graph
from repro_torch.graph.container import strip_padding


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    print("generating web-like R-MAT graph (2^13 vertices, ~65k edges)...")
    g = rmat_graph(scale=13, edge_factor=8, seed=2, device=dev)
    live = strip_padding(g.src, g.dst, g.w, g.ghost)
    print(f"  |V|={int(g.n_nodes)} |E|={g.num_edges()}\n")

    for name, split in [("parallel Louvain (default)", "none"),
                        ("GSP-Louvain (split-pass)", "sp-pj")]:
        cfg = LouvainConfig(split=split)
        louvain(g, cfg, device=dev)  # warm-up: kernels loaded
        t0 = time.perf_counter()
        C, stats = louvain(g, cfg, device=dev)
        if C.is_cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        q = float(modularity(*live, C))
        det = disconnected_communities(*live, C, g.n_nodes)
        rate = g.num_edges() / dt
        print(f"{name}:")
        print(f"  runtime          {dt * 1e3:8.1f} ms   "
              f"({rate / 1e6:.1f} M edges/s)")
        print(f"  modularity       {q:8.4f}")
        print(f"  communities      {int(stats['n_communities']):8d}")
        print(f"  disconnected     {int(det['n_disconnected']):8d}  "
              f"(fraction {float(det['fraction']):.4f})")
        print()


if __name__ == "__main__":
    main()
