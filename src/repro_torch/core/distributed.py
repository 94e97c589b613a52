"""Sharded single-graph GSP-Louvain (port of ``repro/core/distributed.py``'s
:func:`louvain_sharded`): vertex-aligned edge shards over a mesh of ranks,
bit for bit the single-device partition.

The reference drives each pass from the host and runs local move, split
and renumber under ``shard_map``.  The port runs the whole pass loop on
every rank of a :class:`~repro_torch.launch.mesh.Mesh`, one process a
shard, and the caller only sends the job and reads rank 0's result
(:func:`louvain_sharded`).  Each rank holds the live edges of the current
graph and, every pass:

* partitions them by source vertex on the host
  (``graph/partition.py:shard_edge_ranges``, the reference's balanced
  split) and keeps its own contiguous slice, with no padding;
* computes K by a shard-local in-order fold merged by a disjoint-support
  ``psum`` (each owned vertex's sum plus zeros);
* runs the local move with ``owned``, ``group``, ``gidx`` (the global
  live-edge slot of each of its edges) and ``m_total`` (the live edge
  count), then the split slot and ``renumber`` on replicated labels;
* mirrors ``core/louvain.py:_louvain``: the float32 tau ladder and shrink
  test, and the aggregation of the replicated labels.

After the passes every rank runs the ``sl-*`` epilogue, and for
``split='refine'`` the port's C.7 repair ``_split_unconnected``, on the
whole graph, as the single-device loop does.  So the labels equal the
port's single-device labels for every split policy, and ``repro``'s
except where C.7 splits a community.

Why it is exact: the shards are contiguous slices of the sorted edge
arrays, so every per-vertex segment reduction folds the values the
single-device one folds, in its order; float state merges only
disjoint-support vectors (K, refine's K_in, and the per-sweep modularity's
masked weights at their global slots, ``local_move.realized_modularity``),
and ``x + 0.0 == x``; Sigma is not merged but recomputed on every rank
from the replicated K and labels; label and flag merges are integer sums
of disjoint rows and min/max.

``run_louvain_multidevice``, ``community_pass`` and
``build_community_step``, the reference's approximate harness, wait for
their readers (ROADMAP A.13).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import _segments as seg
from repro_torch.core.aggregate import aggregate
from repro_torch.core.local_move import local_move
from repro_torch.core.louvain import (LouvainConfig, _check_split,
                                      _split_mode, _split_unconnected,
                                      refine_labels)
from repro_torch.core.split import split_labels
from repro_torch.distributed import collectives as col
from repro_torch.graph.container import strip_padding
from repro_torch.graph.partition import shard_edge_ranges, shard_vertex_roles
from repro_torch.kernels import ops
from repro_torch.kernels.segsum import segreduce_sorted_cuda
from repro_torch.launch.mesh import MeshError, resolve_mesh
from repro_torch.telemetry.spans import Span


@dataclasses.dataclass(frozen=True)
class _Job:
    """What every rank gets: the graph's live edges on the CPU (shared
    memory through the queue), its sizes and 2m, the config."""

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    n_nodes: int
    n_cap: int
    two_m: float             # the float32 2m of the single-device loop
    cfg: LouvainConfig
    emit: bool               # compute the per-shard halo roles
    t_sent: float            # the caller's perf_counter when sent


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _shard_roles(s_src, s_dst, lo: int, hi: int, n_cap: int) -> dict:
    """This shard's halo sizes: ``shard_vertex_roles`` on its edges."""
    parts = dict(src=[s_src.cpu().numpy()], dst=[s_dst.cpu().numpy()],
                 v_lo=[lo], v_hi=[hi], m_valid=[s_src.shape[0]],
                 n_cap=n_cap)
    r = shard_vertex_roles(parts, 0)
    return dict(n_ghosts=r["n_ghosts"], n_cut_edges=r["n_cut_edges"])


def _rank_louvain(ctx, job: _Job) -> dict:
    """The pass loop on one rank (a ``Mesh.run`` job): the body of
    ``core/louvain.py:_louvain`` statement for statement, on this rank's
    shard and with the collectives.  Returns this rank's report; rank 0's
    carries the labels."""
    t_start = time.perf_counter()
    segreduce_sorted_cuda.launches = 0
    col.all_reduce.calls = col.all_reduce.bytes = 0
    dev, group, rank, S = ctx.device, ctx.group, ctx.rank, ctx.size
    cuda = dev.type == "cuda"
    live = tuple(t.to(dev) for t in (job.src, job.dst, job.w))
    if cuda:
        torch.cuda.synchronize(dev)
    transfer_s = time.perf_counter() - job.t_sent
    cfg = job.cfg
    nv, ghost = job.n_cap + 1, job.n_cap
    # a 0-dim tensor on the device, as the single-device loop's 2m is (on
    # CUDA a CPU-scalar divisor is applied as a reciprocal product)
    two_m = torch.tensor(job.two_m, dtype=torch.float32, device=dev)
    do_sp = cfg.split.startswith("sp")
    ids = torch.arange(nv, dtype=torch.int32, device=dev)

    esrc, edst, ew = live
    Ctop = ids
    n_cur = job.n_nodes
    tau = np.float32(cfg.tolerance)
    drop = np.float32(cfg.tolerance_drop)
    passes = li = li_total = split_moved = m_shard = 0
    per_pass = []
    done = False
    while not done and passes < cfg.max_passes:
        t0 = time.perf_counter()
        m_total = esrc.shape[0]
        bounds, ranges = shard_edge_ranges(esrc.cpu().numpy(), nv, S)
        lo, hi = int(bounds[rank]), int(bounds[rank + 1])
        e0, e1 = ranges[rank]
        # the reference's shard capacity (it pads to a power of two for its
        # jit cache; the port pads nothing)
        m_shard = _next_pow2(max(max(b - a for a, b in ranges), 1))
        s_src, s_dst, s_w = esrc[e0:e1], edst[e0:e1], ew[e0:e1]
        gidx = torch.arange(e0, e1, dtype=torch.int32, device=dev)
        owned = (ids >= lo) & (ids < hi)
        roles = _shard_roles(s_src, s_dst, lo, hi, ghost) if job.emit else {}
        t1 = time.perf_counter()
        node_valid = ids < n_cur
        # K: shard-local in-order fold, then a disjoint-support psum
        K = col.psum(ops.segreduce_sorted(s_w, s_src, nv, op="sum"), group)
        C, _, li = local_move(
            s_src, s_dst, s_w, ids, K, K, two_m, tau=tau,
            max_iters=cfg.max_iters, sync=cfg.sync, prune=cfg.prune,
            owned=owned, group=group, gidx=gidx, m_total=m_total)
        if cfg.split == "refine":
            labels = refine_labels(
                s_src, s_dst, s_w, C, two_m, tau=tau,
                max_iters=cfg.max_iters, owned=owned, group=group,
                gidx=gidx, m_total=m_total)
        elif do_sp:
            labels, _ = split_labels(
                s_src, s_dst, s_w, C, mode=_split_mode(cfg.split),
                max_iters=cfg.split_max_iters, group=group)
        else:
            labels = C
        C_dense, n_comms = seg.renumber(labels, node_valid, nv)
        split_moved += int(torch.sum((labels != C) & node_valid))
        Ctop = C_dense[Ctop]
        n_comms = int(n_comms)
        passes += 1
        li_total += li
        low_shrink = np.float32(n_comms) > (
            np.float32(cfg.aggregation_tolerance) * np.float32(n_cur))
        per_pass.append(dict(t0=t0, t1=t1, t2=time.perf_counter(), li=li,
                             m_total=m_total, m_rank=e1 - e0, **roles))
        done = li <= 1 or low_shrink
        if not done:   # the reference freezes the graph on the last pass
            esrc, edst, ew = strip_padding(
                *aggregate(esrc, edst, ew, C_dense), ghost)
            n_cur = n_comms
            tau = tau / drop

    node_mask = ids < job.n_nodes
    if cfg.split.startswith("sl"):
        # split last: once, on the original graph's top-level labels
        labels, _ = split_labels(*live, Ctop, mode=_split_mode(cfg.split),
                                 max_iters=cfg.split_max_iters)
        split_moved += int(torch.sum((labels != Ctop) & node_mask))
        Ctop, _ = seg.renumber(labels, node_mask, nv)
    elif cfg.split == "refine":
        Ctop, moved = _split_unconnected(live, Ctop, node_mask)
        split_moved += moved
    n_final = int(seg.count_communities(Ctop, node_mask, nv))
    if cuda:
        torch.cuda.synchronize(dev)
    report = dict(
        rank=rank, device=str(dev), wall_s=time.perf_counter() - t_start,
        transfer_s=transfer_s, passes=per_pass, m_shard=m_shard,
        stats=dict(passes=passes, li_last=li, li_total=li_total,
                   split_moved=split_moved, n_communities=n_final),
        segreduce_launches=segreduce_sorted_cuda.launches if cuda else 0,
        all_reduce_calls=col.all_reduce.calls,
        all_reduce_bytes=col.all_reduce.bytes)
    if rank == 0:
        report["labels"] = Ctop.cpu().numpy()
    return report


def _emit(telemetry, reports: list, nv: int):
    """The reference's sharded telemetry, from the ranks' reports: per
    pass the ghost and cut-edge gauges of every shard and the
    ``sharded-partition`` span, then the halo bytes, the ``sharded-pass``
    span and every shard's sweeps.  Span ends are rank 0's
    ``perf_counter`` readings (a system-wide monotonic clock on Linux)."""
    S = len(reports)
    for lp, p0 in enumerate(reports[0]["passes"]):
        for s, r in enumerate(reports):
            lbl = {"shard": str(s)}
            telemetry.gauge("sharded_ghost_vertices",
                            r["passes"][lp]["n_ghosts"], lbl)
            telemetry.gauge("sharded_cut_edges",
                            r["passes"][lp]["n_cut_edges"], lbl)
        telemetry.span(Span("sharded-partition", p0["t0"], p0["t1"],
                            labels={"pass": str(lp)}))
        # replicated-state halo traffic per local-move sweep: the C_new
        # int32 psum and the want pmax (both [nv]) and the modularity
        # edge-slot psum ([m_total + 1] f32), and a split round's pmin[nv];
        # counted once per rank.  m_total is this pass's live edge count,
        # so the value is the reference's (which counts the container's
        # capacity in every pass) where each pass's graph has no padding:
        # an unpadded graph in a run of one pass.
        li, m_total = p0["li"], p0["m_total"]
        per_sweep = (2 * nv + m_total + 1) * 4
        telemetry.counter("sharded_halo_bytes",
                          S * li * 2 * per_sweep + S * nv * 4)
        telemetry.span(Span("sharded-pass", p0["t1"], p0["t2"],
                            labels={"pass": str(lp)}))
        for s in range(S):
            telemetry.counter("sharded_device_sweeps", li,
                              {"shard": str(s)})


def louvain_sharded(g, cfg: LouvainConfig | None = None, *, mesh,
                    telemetry=None):
    """Multi-pass GSP-Louvain sharded over ``mesh``, bit for bit the
    single-device ``louvain_impl`` partition (see the module docstring).

    ``mesh``: a :class:`~repro_torch.launch.mesh.Mesh`, or an int: that
    many ranks of ``make_host_mesh`` on the kind of device ``g`` lies on.
    The labels come back on ``g``'s device.

    ``telemetry``: an optional hub; emits per-shard ghost and cut-edge
    gauges, the halo-byte counter, per-shard sweep counters and the
    ``sharded-partition`` / ``sharded-pass`` spans, as the reference.

    Returns ``(C, stats)`` with the single-device stats plus ``n_shards``,
    ``m_shard`` and ``ghost_vertices``.  ``m_shard`` is the reference's
    value, the power of two at or above the widest shard of the last pass,
    though the port pads nothing; ``ghost_vertices`` sums the last pass's
    ghosts over the shards where telemetry is on, and is 0 otherwise, as
    in the reference.  Each rank's report (without the labels) is
    appended to ``mesh.reports``.
    """
    cfg = cfg if cfg is not None else LouvainConfig()
    _check_split(cfg.split)
    mesh = resolve_mesh(mesh, g.device)
    emit = telemetry is not None and telemetry.enabled
    src, dst, w = (t.to("cpu", copy=True)
                   for t in strip_padding(g.src, g.dst, g.w, g.ghost))
    mesh.start()    # so that the job's transfer time leaves start-up out
    job = _Job(src=src, dst=dst, w=w, n_nodes=int(g.n_nodes),
               n_cap=g.n_cap, two_m=float(g.total_weight_2m()), cfg=cfg,
               emit=emit, t_sent=time.perf_counter())
    reports = mesh.run(_rank_louvain, job)
    if any(r["stats"] != reports[0]["stats"] for r in reports):
        raise MeshError("the ranks of mesh "
                        f"{mesh.devices} disagree: "
                        f"{[r['stats'] for r in reports]}")
    mesh.reports.append([{k: v for k, v in r.items() if k != "labels"}
                         for r in reports])
    if emit:
        _emit(telemetry, reports, g.nv)
    r0 = reports[0]
    stats = dict(r0["stats"], n_shards=mesh.size, m_shard=r0["m_shard"],
                 ghost_vertices=sum(r["passes"][-1]["n_ghosts"]
                                    for r in reports) if emit else 0)
    return torch.from_numpy(r0["labels"]).to(g.device), stats
