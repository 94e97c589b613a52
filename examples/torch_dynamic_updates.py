"""Scenario: streaming graph — incremental community maintenance, on the
PyTorch port.

A production service rarely re-clusters from scratch: edges arrive (and
disappear) in batches — and so do vertices.  This example maintains a
GSP-Louvain partition across fully-dynamic update batches with
delta-screening (core/dynamic.py): each batch of signed weight-deltas
rewrites the padded COO in place (deletions free capacity), warm-starts
the local-moving phase with only the affected region active, then
re-splits — so the paper's no-disconnected-communities guarantee holds
continuously, even when a deletion disconnects a community internally.
The final phase churns *vertices* through the same path (GraphUpdate):
removals tombstone an id, delete its incident edges, and compact the id
space (survivors shift down past the removed ids); additions claim fresh
ids from the padding slots and are wired up by edge deltas in the same
batch.  The host prepares each batch; the warm update runs on
``--device`` (default ``cuda``).

  PYTHONPATH=src python examples/torch_dynamic_updates.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core import (
    GraphUpdate, LouvainConfig, disconnected_communities, louvain,
    modularity, update_communities,
)
from repro_torch.graph import sbm_graph
from repro_torch.graph.container import strip_padding


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    rng = np.random.default_rng(0)
    g, _ = sbm_graph(n_nodes=400, n_blocks=8, p_in=0.25, p_out=0.005,
                     seed=0, m_cap=2 * 24000, device=dev)
    C, _ = louvain(g, LouvainConfig(), device=dev)
    q = float(modularity(*strip_padding(g.src, g.dst, g.w, g.ghost), C))
    print(f"initial: |E|={g.num_edges()} Q={q:.4f}")

    for batch in range(8):
        n = int(g.n_nodes)
        if batch < 4:
            # growth phase: 40 random insertions
            u = rng.integers(0, n, 40)
            v = rng.integers(0, n, 40)
            upd = (u, v, np.ones(40, np.float32))
            label = "+40 edges"
        elif batch < 6:
            # churn phase: delete 30 random live edges (negative deltas
            # remove entries in place and free their capacity slots)
            src, dst, ww = (t.cpu().numpy() for t in (g.src, g.dst, g.w))
            live = (src < g.n_cap) & (src < dst)
            idx = rng.choice(int(live.sum()), 30, replace=False)
            upd = (src[live][idx], dst[live][idx], -ww[live][idx])
            label = "-30 edges"
        else:
            # vertex phase: remove 5 random vertices (ids compact: every
            # survivor shifts down past the removed ids) and add 5 fresh
            # ones, each wired to 4 members of one community — one
            # combined GraphUpdate batch
            rem = np.sort(rng.choice(n, 5, replace=False))
            shift = lambda i: i - int((rem < i).sum())     # noqa: E731
            Ch = C.cpu().numpy()
            n2 = n - 5
            us, vs = [], []
            for k, new_id in enumerate(range(n2, n2 + 5)):
                anchor = int(rng.integers(0, n))
                while anchor in rem:
                    anchor = int(rng.integers(0, n))
                peers = [i for i in range(n)
                         if Ch[i] == Ch[anchor] and i not in rem][:4]
                us += [new_id] * len(peers)
                vs += [shift(p) for p in peers]
            upd = GraphUpdate(u=np.array(us), v=np.array(vs),
                              dw=np.ones(len(us), np.float32),
                              add=5, remove=rem)
            label = "-5/+5 vertices"
        t0 = time.perf_counter()
        g, C, stats = update_communities(g, C, upd, device=dev)
        dt = time.perf_counter() - t0
        live = strip_padding(g.src, g.dst, g.w, g.ghost)
        q_inc = float(modularity(*live, C))
        det = disconnected_communities(*live, C, g.n_nodes)
        # full-recompute reference
        C_full, _ = louvain(g, LouvainConfig(), device=dev)
        q_full = float(modularity(*live, C_full))
        print(
            f"batch {batch}: {label} | affected={int(stats['n_affected']):4d}"
            f"/{int(g.n_nodes)} vertices | warm sweeps={int(stats['iterations'])}"
            f" | Q={q_inc:.4f} (full recompute {q_full:.4f})"
            f" | disconnected={int(det['n_disconnected'])} | {dt*1e3:.0f} ms"
        )


if __name__ == "__main__":
    main()
