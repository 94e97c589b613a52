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

The reference's earlier, approximate scale path lives here too, for its
readers (the scaling harness): :func:`run_louvain_multidevice` runs pass 1
sharded through :func:`build_community_step` (a :func:`community_pass` a
rank, on the reference's padded ``[S, m_shard]`` shards with their
``v_lo``/``v_hi`` ownership, no global edge slots, split to the fixpoint
and a *shard-local* aggregation), gathers the super-edges with
cross-shard duplicates kept as parallel edges, and runs the single-device
``louvain`` on that super-graph.  Its labels are NOT the single-device
partition (ROADMAP C.4): the parallel edges fold in another order and the
later passes start from another graph.  Use :func:`louvain_sharded` where
the labels matter.
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
from repro_torch.graph.container import Graph, strip_padding
from repro_torch.graph.partition import (partition_edges_by_src,
                                         shard_edge_ranges, shard_vertex_roles)
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


# --------------------------------------------------------------------------
# The approximate harness (the reference's earlier scale path; see the
# module docstring): pass 1 sharded with shard-local aggregation, the rest
# on one device.  Not the single-device partition (ROADMAP C.4).
# --------------------------------------------------------------------------

def community_pass(src, dst, w, v_lo, v_hi, two_m, n_nodes, *, nv: int,
                   group, move_iters: int, split_iters: int,
                   tau: float = 1e-2, split_mode: str = "pj",
                   prune: bool = True):
    """One GSP-Louvain pass on this rank's shard of ``group`` (a
    ``Mesh.run`` job's body): the shard's padded edges ``src``/``dst``/
    ``w`` (``[m_shard]``), its owned vertex range ``[v_lo, v_hi)``, the
    replicated 2m (a 0-dim float32 tensor) and vertex count.

    K is the shard's in-order fold merged by a disjoint-support ``psum``;
    the local move runs with ``owned`` and ``group`` but no global edge
    slots (its modularity sums by vertex, as the reference's does here);
    the split runs with ``group`` to ``split_iters`` rounds (0: the
    fixpoint); ``aggregate`` runs on this shard's edges alone.  Returns
    ``(C_dense replicated, n_comms, l_i, nsrc, ndst, nw)``, the last three
    this shard's ``[m_shard]`` super-edges, ghost-padded.
    """
    ids = torch.arange(nv, dtype=torch.int32, device=src.device)
    owned = (ids >= v_lo) & (ids < v_hi)
    node_valid = ids < n_nodes
    K = col.psum(ops.segreduce_sorted(w, src, nv, op="sum"), group)
    C, _, li = local_move(src, dst, w, ids, K, K, two_m,
                          tau=np.float32(tau), max_iters=move_iters,
                          prune=prune, owned=owned, group=group)
    labels, _ = split_labels(src, dst, w, C, mode=split_mode,
                             max_iters=split_iters, group=group)
    C_dense, n_comms = seg.renumber(labels, node_valid, nv)
    nsrc, ndst, nw = aggregate(src, dst, w, C_dense)
    return C_dense, n_comms, li, nsrc, ndst, nw


@dataclasses.dataclass(frozen=True)
class _StepJob:
    """What every rank of a community step gets: the stacked shards on
    the CPU (shared memory through the queue), the scalars, the pass's
    settings."""

    src: torch.Tensor        # int32[S, m_shard]
    dst: torch.Tensor
    w: torch.Tensor          # float32[S, m_shard]
    v_lo: torch.Tensor       # int32[S]
    v_hi: torch.Tensor
    two_m: float             # the float32 2m
    n_nodes: int
    nv: int
    move_iters: int
    split_iters: int
    split_mode: str
    prune: bool
    t_sent: float


def _rank_step(ctx, job: _StepJob) -> dict:
    """:func:`community_pass` on this rank's row (a ``Mesh.run`` job).
    Returns this rank's report, in the shape of the sharded driver's (one
    pass), with its super-edges on the CPU; rank 0's carries the labels."""
    t_start = time.perf_counter()
    segreduce_sorted_cuda.launches = 0
    col.all_reduce.calls = col.all_reduce.bytes = 0
    dev, r = ctx.device, ctx.rank
    cuda = dev.type == "cuda"
    src, dst, w = (t[r].to(dev) for t in (job.src, job.dst, job.w))
    if cuda:
        torch.cuda.synchronize(dev)
    transfer_s = time.perf_counter() - job.t_sent
    two_m = torch.tensor(job.two_m, dtype=torch.float32, device=dev)
    t1 = time.perf_counter()
    C_dense, n_comms, li, nsrc, ndst, nw = community_pass(
        src, dst, w, int(job.v_lo[r]), int(job.v_hi[r]), two_m,
        job.n_nodes, nv=job.nv, group=ctx.group,
        move_iters=job.move_iters, split_iters=job.split_iters,
        split_mode=job.split_mode, prune=job.prune)
    out = dict(n_comms=int(n_comms), li=li, nsrc=nsrc.cpu(),
               ndst=ndst.cpu(), nw=nw.cpu())
    if r == 0:
        out["C"] = C_dense.cpu()
    t2 = time.perf_counter()
    m_rank = int(torch.count_nonzero(src < job.nv - 1))
    return dict(
        rank=r, device=str(dev), wall_s=t2 - t_start, transfer_s=transfer_s,
        passes=[dict(t0=t_start, t1=t1, t2=t2, li=li,
                     m_total=int(job.src.shape[1]), m_rank=m_rank)],
        segreduce_launches=segreduce_sorted_cuda.launches if cuda else 0,
        all_reduce_calls=col.all_reduce.calls,
        all_reduce_bytes=col.all_reduce.bytes, out=out)


def build_community_step(mesh, *, n_cap: int, m_shard: int,
                         move_iters: int = 4, split_iters: int = 8,
                         split_mode: str = "pj", prune: bool = True):
    """The distributed pass of the approximate harness on ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh`, one shard a rank).

    Returns a plan ``dict(fn=..., nv=n_cap + 1, n_shards=S)``.  One call
    ``fn(src, dst, w, v_lo, v_hi, two_m, n_nodes)``, with the stacked
    shards of ``partition_edges_by_src`` (``[S, m_shard]`` int32/float32
    and ``[S]`` int32 tensors), 2m and the vertex count, runs
    :func:`community_pass` on every rank and returns ``(C, n_comms, l_i,
    nsrc, ndst, nw)``: the replicated dense labels, the community count
    and the local move's ``l_i`` (Python ints), and the stacked
    ``[S, m_shard]`` super-edges, all on ``src``'s device.  Each rank's
    report (without its arrays) is appended to ``mesh.reports``.  The
    reference's ``args``, ``in_shardings`` and ``out_shardings`` belong to
    ``jax.jit`` and have no counterpart.
    """
    S, nv = mesh.size, n_cap + 1

    def fn(src, dst, w, v_lo, v_hi, two_m, n_nodes):
        if tuple(src.shape) != (S, m_shard):
            raise ValueError(f"shards must be [{S}, {m_shard}], got "
                             f"{list(src.shape)}")
        dev = src.device
        # copies of their own, which the queue moves to shared memory
        cpu = [torch.as_tensor(t).to("cpu", copy=True)
               for t in (src, dst, w, v_lo, v_hi)]
        mesh.start()   # so that the job's transfer time leaves start-up out
        job = _StepJob(*cpu, two_m=float(two_m), n_nodes=int(n_nodes),
                       nv=nv, move_iters=move_iters, split_iters=split_iters,
                       split_mode=split_mode, prune=prune,
                       t_sent=time.perf_counter())
        reports = mesh.run(_rank_step, job)
        outs = [r.pop("out") for r in reports]
        if any((o["n_comms"], o["li"]) != (outs[0]["n_comms"], outs[0]["li"])
               for o in outs):
            raise MeshError(f"the ranks of mesh {mesh.devices} disagree: "
                            f"{[(o['n_comms'], o['li']) for o in outs]}")
        mesh.reports.append(reports)
        stack = [torch.stack([o[k] for o in outs]).to(dev)
                 for k in ("nsrc", "ndst", "nw")]
        return (outs[0]["C"].to(dev), outs[0]["n_comms"], outs[0]["li"],
                *stack)

    return dict(fn=fn, nv=nv, n_shards=S)


def run_louvain_multidevice(g, mesh, cfg: LouvainConfig | None = None):
    """Multi-pass GSP-Louvain through the approximate harness: pass 1
    sharded over ``mesh`` by :func:`build_community_step` (``tau`` 1e-2,
    the split to its fixpoint in ``cfg.split``'s mode, ``pj`` where it
    names none), the shards' super-edges gathered by a stable sort on
    their source (cross-shard duplicates stay parallel edges), then the
    single-device ``louvain`` with ``cfg`` on that super-graph, on ``g``'s
    device.  ``mesh``: a :class:`~repro_torch.launch.mesh.Mesh` or an int,
    as in :func:`louvain_sharded`.

    Returns ``(C, stats)``: ``C2[C1]`` and the single-device stats of the
    later passes plus ``first_pass_li`` and ``first_pass_comms``.  Not the
    single-device partition (ROADMAP C.4).
    """
    from repro_torch.core.louvain import louvain

    cfg = cfg if cfg is not None else LouvainConfig()
    mesh = resolve_mesh(mesh, g.device)
    dev = g.device
    parts = partition_edges_by_src(g, mesh.size)
    plan = build_community_step(
        mesh, n_cap=g.n_cap, m_shard=parts["src"].shape[1],
        move_iters=cfg.max_iters, split_iters=0,
        split_mode=cfg.split.split("-")[1] if "-" in cfg.split else "pj")
    # the shards go to the ranks from the host, where they were cut
    C1, n1, li, nsrc, ndst, nw = plan["fn"](
        *(torch.from_numpy(parts[k])
          for k in ("src", "dst", "w", "v_lo", "v_hi")),
        g.total_weight_2m(), int(g.n_nodes))
    # gather the super-graph (cross-shard duplicates act as parallel
    # edges, i.e. summed weights, for every later step)
    C1 = C1.to(dev)
    flat_src, flat_dst, flat_w = (t.reshape(-1).to(dev)
                                  for t in (nsrc, ndst, nw))
    order = torch.sort(flat_src, stable=True)[1]
    g2 = Graph(src=flat_src[order], dst=flat_dst[order], w=flat_w[order],
               n_nodes=torch.tensor(n1, dtype=torch.int32, device=dev),
               n_cap=g.n_cap, m_cap=flat_src.shape[0])
    C2, stats = louvain(g2, cfg, device=dev)
    stats = dict(stats, first_pass_li=li, first_pass_comms=n1)
    return C2[C1], stats
