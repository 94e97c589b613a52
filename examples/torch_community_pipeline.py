"""Scenario: community detection as a production pipeline stage, on the
PyTorch port.

1. detect communities with GSP-Louvain,
2. verify none are internally disconnected (the paper's guarantee),
3. use them: Louvain-clustered node labels train a GCN (cluster-informed
   features), and community structure drives a balanced graph partitioning
   for the distributed runtime.

On the card (``--device cuda``, the default) or the CPU:

  PYTHONPATH=src python examples/torch_community_pipeline.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import LouvainConfig, disconnected_communities, louvain
from repro_torch.graph import sbm_graph
from repro_torch.graph.container import strip_padding
from repro_torch.graph.partition import partition_edges_by_src
from repro_torch.launch.train import value_and_grad
from repro_torch.models import gnn as G
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    g, blocks = sbm_graph(n_nodes=400, n_blocks=5, p_in=0.25, p_out=0.01,
                          seed=0, device=dev)
    print(f"graph: |V|={int(g.n_nodes)} |E|={g.num_edges()}")

    # 1-2: detect + verify
    C, stats = louvain(g, LouvainConfig(split="sp-pj"), device=dev)
    det = disconnected_communities(*strip_padding(g.src, g.dst, g.w,
                                                  g.ghost), C, g.n_nodes)
    print(f"communities: {int(stats['n_communities'])} "
          f"(disconnected: {int(det['n_disconnected'])})")
    assert int(det["n_disconnected"]) == 0

    # agreement with planted blocks (majority mapping accuracy)
    Cn = C.cpu().numpy()[: int(g.n_nodes)]
    acc = 0
    for c in np.unique(Cn):
        members = blocks[Cn == c]
        acc += (members == np.bincount(members).argmax()).sum()
    print(f"planted-block agreement: {acc / len(Cn):.3f}")

    # 3a: train a GCN against Louvain-derived labels
    n_classes = int(stats["n_communities"])
    labels = torch.from_numpy(np.concatenate(
        [Cn, [0] * (g.nv - len(Cn))]).astype(np.int64)).to(dev)
    cfg = G.GCNConfig(d_in=16, d_hidden=16, n_classes=n_classes)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((g.nv, 16), generator=gen, device=dev)
    params = G.init_gcn(gen, cfg)
    opt = adamw_init(params)
    mask = g.node_mask().float()

    def loss_fn(p):
        out = G.gcn_forward(p, x, g.src, g.dst, cfg)
        logz = torch.logsumexp(out, -1)
        gold = torch.gather(out, -1, labels[:, None])[:, 0]
        return torch.sum((logz - gold) * mask) / mask.sum()

    for _ in range(60):
        loss, grads = value_and_grad(loss_fn, params)
        params, opt, _ = adamw_update(params, grads, opt, AdamWConfig(lr=5e-3))
    with torch.no_grad():
        out = G.gcn_forward(params, x, g.src, g.dst, cfg)
    pred = out.argmax(-1).cpu().numpy()[: int(g.n_nodes)]
    acc = float(np.mean(pred == Cn))
    print(f"GCN fit to Louvain labels: acc={acc:.3f} "
          f"(final loss {float(loss):.3f})")

    # 3b: partition for the distributed runtime
    parts = partition_edges_by_src(g, 8)
    per = (parts["src"] < g.n_cap).sum(axis=1)
    print(f"8-shard edge partition balance: min={per.min()} max={per.max()} "
          f"(imbalance {per.max() / max(per.mean(), 1):.2f}x)")
    return dict(acc=acc, n_communities=n_classes)


if __name__ == "__main__":
    main()
