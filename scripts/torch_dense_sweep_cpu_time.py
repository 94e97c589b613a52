"""Time the dense scan's plain half-sweep on the CPU.

    PYTHONPATH=src python scripts/torch_dense_sweep_cpu_time.py \
        [--src PATH] [--threads 1] [--reps 15] [--graph sbm1025]

Runs ``repro_torch.core.local_move._half_sweep_dense_plain`` (the CPU's
route of the dense scan) on the largest default service bucket's graph,
``sbm_graph(1024, 16, 0.2, 0.003, seed=3, n_cap=1024, m_cap=16384)``
(``nv = 1025``), or with ``--graph ego_small|ego_dense|road`` on the
``--tiers`` smoke's graph of that family (``launch/serve_communities.py:
synth_graph``, seed 3) padded into its bucket, from
a seeded random state (64 communities, half the vertices movable), and
prints the median and the minimum wall time of ``--reps`` calls after one
warm-up, with the SHA-256 of the outputs' bytes, so that two trees
(``--src`` of each) can be compared in turns on one machine.  A CPU time:
it says nothing of the card.
"""
import argparse
import hashlib
import statistics
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src", help="the tree's src directory")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--graph", default="sbm1025",
                    choices=("sbm1025", "ego_small", "ego_dense", "road"))
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.core.local_move import _half_sweep_dense_plain
    from repro_torch.graph import sbm_graph
    from repro_torch.kernels import ops

    torch.set_num_threads(args.threads)
    if args.graph == "sbm1025":
        g, _ = sbm_graph(1024, 16, 0.2, 0.003, seed=3, n_cap=1024,
                         m_cap=16384, device="cpu")
    else:
        from repro_torch.launch.serve_communities import synth_graph
        from repro_torch.service.buckets import admit

        g, _ = admit(synth_graph(args.graph, 3, device="cpu"))
    nv = g.nv
    gen = torch.Generator().manual_seed(0)
    C = torch.randint(0, 64, (nv,), generator=gen, dtype=torch.int32)
    C[-1] = nv - 1
    K = g.vertex_weights()
    Sigma = ops.segment_sum_inorder(K, C, nv)
    movable = torch.rand(nv, generator=gen) < 0.5
    args_ = (g.src, g.dst, g.w, C, K, Sigma, g.total_weight_2m(), movable)
    out = _half_sweep_dense_plain(*args_)
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        _half_sweep_dense_plain(*args_)
        times.append(time.perf_counter() - t0)
    digest = hashlib.sha256(b"".join(
        t.contiguous().view(torch.uint8).numpy().tobytes() if t.dim()
        else t.reshape(1).view(torch.uint8).numpy().tobytes()
        for t in out)).hexdigest()[:16]
    print(f"src={args.src} graph={args.graph} nv={nv} m_cap={g.m_cap} "
          f"threads={args.threads} "
          f"median_ms={statistics.median(times) * 1e3} "
          f"min_ms={min(times) * 1e3} outputs_sha256={digest}")


if __name__ == "__main__":
    main()
