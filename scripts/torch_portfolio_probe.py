"""Probe the portfolio of the PyTorch port against the JAX package on the
CPU: max-quality's near ties, and the unconnected communities that the
reference's 'refine' returns.

Usage, from the root of the repo:

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/torch_portfolio_probe.py \
        [--families sbm,rmat,...] [--seeds 40]
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/torch_portfolio_probe.py \
        --unconnected [--scales 9,10,11,12] [--edge-factors 4,8,16] [--seeds 40]

Near ties (the default): max-quality runs the pass loop twice, with
refinement in the split slot and with the default split, and keeps the
refined labels when ``q_r >= q_s``.  The port sums Q in another order than
the reference, so where the two candidates differ and their modularities
lie within 1e-6 of each other, the packages could pick differently.  For
each seed of each family this runs both candidates in both packages,
requires equal candidates (or, where the reference's refined one is
unconnected, the port's to be it split: ROADMAP C.7, reported and left
out), and prints every case where they differ within 1e-6 of each other,
and every case where the picks differ (``DIVERGE``), with ``q_r`` and
``q_s`` from each package.  Exits 1 if any pick differs.

``--unconnected``: ``detect()`` of the reference with ``split='refine'``
on R-MAT graphs, printing each graph where it returns an internally
disconnected community, beside the port's count for the same graph (0:
the port splits them, ROADMAP C.7).  Exits 1 if the port returns one.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def graph(family: str, seed: int):
    """The reference's graph of ``family`` at ``seed``: the small families
    of ``tests/test_torch_detect.py`` with the seed (or the size, for the
    deterministic ones) varied."""
    import repro.graph as rg

    if family == "sbm":
        return rg.sbm_graph(n_nodes=96, n_blocks=5, p_in=0.4, p_out=0.02,
                            seed=seed)[0]
    if family == "sbm_sparse":
        return rg.sbm_graph(n_nodes=128, n_blocks=8, p_in=0.2, p_out=0.03,
                            seed=seed)[0]
    if family == "rmat":
        return rg.rmat_graph(scale=9, edge_factor=8, seed=seed)
    if family == "rmat8":
        return rg.rmat_graph(scale=8, edge_factor=4, seed=seed)
    if family == "random_regular":
        return rg.random_regular_graph(128, 6, seed=seed)
    if family == "ring_of_cliques":    # seed -> (cliques, clique size)
        return rg.ring_of_cliques(4 + seed % 20, 3 + seed // 20)
    if family == "grid":               # seed -> (rows, columns)
        return rg.grid_graph(4 + seed % 12, 4 + seed // 12)
    raise ValueError(f"unknown family {family!r}")


FAMILIES = ("sbm", "sbm_sparse", "rmat", "rmat8", "random_regular",
            "ring_of_cliques", "grid")


def candidates(gj):
    """((q_r, q_s, C_r, C_s) of the reference, the same of the port)."""
    import repro.core as jcore
    import repro_torch.core as tcore
    from repro.core.modularity import modularity as j_modularity
    from repro_torch.graph import graph_from_arrays
    from repro_torch.graph.container import strip_padding

    Cr, _ = jcore.louvain(gj, jcore.tier_config("max-quality",
                                                jcore.LouvainConfig()))
    Cs, _ = jcore.louvain(gj, jcore.LouvainConfig())
    ref = (float(j_modularity(gj.src, gj.dst, gj.w, Cr)),
           float(j_modularity(gj.src, gj.dst, gj.w, Cs)),
           np.asarray(Cr), np.asarray(Cs))
    tg = graph_from_arrays(np.asarray(gj.src), np.asarray(gj.dst),
                           np.asarray(gj.w), int(gj.n_nodes), gj.n_cap,
                           device="cpu")
    live = strip_padding(tg.src, tg.dst, tg.w, tg.ghost)
    tCr, _ = tcore.louvain(tg, tcore.tier_config(
        "max-quality", tcore.LouvainConfig()), device="cpu")
    tCs, _ = tcore.louvain(tg, tcore.LouvainConfig(), device="cpu")
    port = (float(tcore.modularity(*live, tCr)),
            float(tcore.modularity(*live, tCs)), tCr.numpy(), tCs.numpy())
    return ref, port


def split_unconnected(gj, C) -> np.ndarray:
    """The reference's labels ``C`` with each unconnected community split
    into its connected pieces, as the port's 'refine' does."""
    import torch

    from repro_torch.core import split_labels
    from repro_torch.core._segments import renumber
    from repro_torch.graph import graph_from_arrays
    from repro_torch.graph.container import strip_padding

    tg = graph_from_arrays(np.asarray(gj.src), np.asarray(gj.dst),
                           np.asarray(gj.w), int(gj.n_nodes), gj.n_cap,
                           device="cpu")
    live = strip_padding(tg.src, tg.dst, tg.w, tg.ghost)
    pieces, _ = split_labels(*live, torch.from_numpy(C.copy()), mode="pj")
    return renumber(pieces, tg.node_mask(), tg.nv)[0].numpy()


def unconnected(scales, edge_factors, seeds) -> int:
    """The ``--unconnected`` sweep; returns the exit code."""
    import repro.core as jcore
    import repro.graph as rg
    import repro_torch.core as tcore
    from repro_torch.graph import graph_from_arrays

    found = bad = 0
    for scale in scales:
        for ef in edge_factors:
            for seed in range(seeds):
                gj = rg.rmat_graph(scale=scale, edge_factor=ef, seed=seed)
                ref = jcore.detect(gj, options=jcore.DetectOptions(
                    scan="sort", louvain=jcore.LouvainConfig(split="refine")))
                if not int(ref.n_disconnected):
                    continue
                tg = graph_from_arrays(
                    np.asarray(gj.src), np.asarray(gj.dst), np.asarray(gj.w),
                    int(gj.n_nodes), gj.n_cap, device="cpu")
                res = tcore.detect(tg, options=tcore.DetectOptions(
                    louvain=tcore.LouvainConfig(split="refine")),
                    device="cpu")
                found += 1
                bad += res.n_disconnected != 0
                print(f"rmat scale={scale} edge_factor={ef} seed={seed}: "
                      f"reference refine disconnected="
                      f"{int(ref.n_disconnected)}  port "
                      f"{res.n_disconnected}", flush=True)
            print(f"scale {scale} edge factor {ef}: {seeds} seeds done",
                  flush=True)
    print(f"graphs where the reference's refine is unconnected: {found}; "
          f"where the port's is: {bad}")
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--unconnected", action="store_true")
    ap.add_argument("--scales", default="9,10,11,12")
    ap.add_argument("--edge-factors", default="4,8,16")
    args = ap.parse_args(argv)
    if args.unconnected:
        return unconnected([int(x) for x in args.scales.split(",")],
                           [int(x) for x in args.edge_factors.split(",")],
                           args.seeds)
    diverged = near = 0
    repaired = 0
    for family in args.families.split(","):
        for seed in range(args.seeds):
            gj = graph(family, seed)
            ref, port = candidates(gj)
            if not np.array_equal(ref[3], port[3]):
                raise AssertionError(f"{family} {seed}: GSP candidates "
                                     "differ")
            if not np.array_equal(ref[2], port[2]):
                # the port splits what the reference's refine leaves
                # unconnected (ROADMAP C.7): no like-for-like pick here
                if not np.array_equal(split_unconnected(gj, ref[2]),
                                      port[2]):
                    raise AssertionError(f"{family} {seed}: refined "
                                         "candidates differ")
                repaired += 1
                print(f"{family} seed {seed}: the reference's refined "
                      "candidate is unconnected; the port's is it split",
                      flush=True)
                continue
            differ = not np.array_equal(ref[2], ref[3])
            close = abs(ref[0] - ref[1]) < 1e-6
            same = (ref[0] >= ref[1]) == (port[0] >= port[1])
            near += differ and close
            diverged += not same
            if (differ and close) or not same:
                print(f"{family} seed {seed}: reference q_r={ref[0]!r} "
                      f"q_s={ref[1]!r}  port q_r={port[0]!r} "
                      f"q_s={port[1]!r}  equal in float32="
                      f"{ref[0] == ref[1]}  "
                      f"{'same pick' if same else 'DIVERGE'}", flush=True)
        print(f"{family}: {args.seeds} seeds done", flush=True)
    print(f"near ties with different candidates: {near}; picks that "
          f"differ: {diverged}; refined candidates split by the port: "
          f"{repaired}")
    return 1 if diverged else 0


if __name__ == "__main__":
    sys.exit(main())
