"""SLO-tiered algorithm portfolio (port of ``repro/core/portfolio.py``).

One dispatch over the tiers of ``DetectOptions.algorithm``, each with the
:class:`QualityContract` it stamps on its results:

  'fast'        -- LPA (``core/lpa.py``): labels converge, no structural
                   guarantee.
  'standard'    -- GSP-Louvain (the paper; ``split='sp-pj'`` by default).
  'max-quality' -- two candidates, the pass loop with Leiden-style
                   refinement in the split slot and the plain GSP run,
                   and the one of higher modularity (the refined one on a
                   tie).  Both modularities are ``ops.sum_inorder`` folds,
                   so the card and the CPU pick alike.  Both candidates
                   are connected: the refined one through the pass loop's
                   split of what refinement leaves unconnected, which the
                   reference omits (ROADMAP C.7).

:func:`run_detection_tile` is :func:`run_detection` for several graphs
of one bucket at once, the batched engine's tile (every tier on either
scan, without a mesh; :func:`tile_route`).

Stats are the same five Python ints for every tier (passes / li_last /
li_total / split_moved / n_communities); the sharded route adds
``n_shards``, ``m_shard`` and ``ghost_vertices``.

With ``DetectOptions.mesh`` the pass loops run sharded
(``core/distributed.py:louvain_sharded``), for 'standard' and
'max-quality' only, on the sortscan ('auto' means 'sort'; 'dense'
raises).  max-quality makes the same pick between its two candidates, so
``detect()`` with a mesh equals ``detect()`` without one.  The
reference's ``partition()`` with a mesh runs the refined candidate alone
(ROADMAP C.11); its engine's ``detect_sharded`` makes the pick.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import _segments as seg
from repro_torch.core.detect import disconnected_communities
from repro_torch.core.louvain import (LouvainConfig, _Clock, louvain_impl,
                                      louvain_tile)
from repro_torch.core.lpa import lpa_run, lpa_run_tile
from repro_torch.core.modularity import modularity, modularity_tile
from repro_torch.graph.container import stack_graphs, strip_padding, union_of

ALGORITHMS = ("fast", "standard", "max-quality")


@dataclasses.dataclass(frozen=True)
class QualityContract:
    """What a tier guarantees about the partition it returns.

    tier:                  the algorithm that produced the result.
    zero_disconnected:     no community has >1 internal component.
    connected_parts:       every returned part is internally connected by
                           construction of the moves.
    modularity_converged:  the local-move phase ran to its tolerance ladder.
    """

    tier: str
    zero_disconnected: bool
    connected_parts: bool
    modularity_converged: bool


_CONTRACTS = {
    "fast": QualityContract(
        tier="fast", zero_disconnected=False, connected_parts=False,
        modularity_converged=False),
    "standard": QualityContract(
        tier="standard", zero_disconnected=True, connected_parts=True,
        modularity_converged=True),
    "max-quality": QualityContract(
        tier="max-quality", zero_disconnected=True, connected_parts=True,
        modularity_converged=True),
}


def contract_for(algorithm: str) -> QualityContract:
    """The :class:`QualityContract` a tier promises."""
    try:
        return _CONTRACTS[algorithm]
    except KeyError:
        raise ValueError(
            f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}"
        ) from None


def tier_config(algorithm: str, cfg: LouvainConfig) -> LouvainConfig:
    """The LouvainConfig a tier runs (fast ignores it; standard runs it as
    it is; max-quality's refined candidate swaps the split slot)."""
    contract_for(algorithm)
    if algorithm == "max-quality":
        return dataclasses.replace(cfg, split="refine")
    return cfg


def _standard_config(cfg: LouvainConfig) -> LouvainConfig:
    """max-quality's GSP candidate: the base config, never 'refine' (where
    the caller asked for refine, the paper's default is the comparator)."""
    if cfg.split == "refine":
        return dataclasses.replace(cfg, split="sp-pj")
    return cfg


def _pick(g, refined, standard, clock):
    """max-quality's pick: the refined candidate ``(C, stats)`` where its
    modularity is at least the GSP candidate's, else the GSP one."""
    live = strip_padding(g.src, g.dst, g.w, g.ghost)
    q_r = clock.run("select", modularity, *live, refined[0])
    q_s = clock.run("select", modularity, *live, standard[0])
    return refined if bool(q_r >= q_s) else standard


def _partition_sharded(g, options, mesh, *, phase_seconds, telemetry):
    """The mesh route of :func:`partition`."""
    from repro_torch.core.distributed import louvain_sharded

    algorithm = options.algorithm
    if algorithm == "fast":
        raise ValueError(
            "algorithm='fast' (LPA) is single-device only — drop mesh=")
    if options.scan == "dense":
        raise ValueError("scan='dense' is single-device only")
    tiered = louvain_sharded(g, tier_config(algorithm, options.louvain),
                             mesh=mesh, telemetry=telemetry)
    if algorithm == "standard":
        return tiered
    standard = louvain_sharded(g, _standard_config(options.louvain),
                               mesh=mesh, telemetry=telemetry)
    return _pick(g, tiered, standard, _Clock(phase_seconds, g.device))


def partition(g, options, *, phase_seconds=None, telemetry=None):
    """Run one portfolio tier on one graph where it lies: ``(C, stats)``.

    The pass loops run ``options.scan``, where 'auto' means 'sort', as in
    the reference's ``partition`` (:func:`run_detection` resolves 'auto'
    by the graph's shape first).  The fast tier has no scan.

    ``phase_seconds`` (a dict or ``None``) collects the phases of the pass
    loop (both of max-quality's candidates add into the same keys), 'lpa'
    for the fast tier, and 'select' for max-quality's two modularities;
    with a mesh, 'select' alone.  ``telemetry`` goes to the sharded
    driver.
    """
    algorithm = options.algorithm
    contract_for(algorithm)
    mesh = options.resolved_mesh(g.device)
    if mesh is not None:
        return _partition_sharded(g, options, mesh,
                                  phase_seconds=phase_seconds,
                                  telemetry=telemetry)
    scan = "sort" if options.scan == "auto" else options.scan
    if algorithm == "fast":
        C, iters = _Clock(phase_seconds, g.device).run("lpa", lpa_run, g)
        n = int(seg.count_communities(C, g.node_mask(), g.nv))
        return C, dict(passes=1, li_last=iters, li_total=iters,
                       split_moved=0, n_communities=n)
    if algorithm == "standard":
        return louvain_impl(g, options.louvain, scan=scan,
                            phase_seconds=phase_seconds)
    # max-quality: the refined candidate, the GSP one, the better of the two
    C_r, st_r = louvain_impl(g, tier_config(algorithm, options.louvain),
                             scan=scan, phase_seconds=phase_seconds)
    C_s, st_s = louvain_impl(g, _standard_config(options.louvain),
                             scan=scan, phase_seconds=phase_seconds)
    return _pick(g, (C_r, st_r), (C_s, st_s),
                 _Clock(phase_seconds, g.device))


def run_detection(graph, options, *, phase_seconds=None, telemetry=None):
    """Partition + detector + modularity + contract: the body of
    :func:`repro_torch.core.api.detect`.

    ``scan='auto'`` is resolved by the graph's shape first
    (``DetectOptions.resolved_scan``, on the graph's device type), as the
    reference's ``run_detection`` does: small graphs take the dense scan.
    ``n_disconnected`` is always measured, so the tier's contract is
    checked, not assumed.  ``phase_seconds`` (a dict or ``None``) collects
    :func:`partition`'s phase times plus 'detector' and 'modularity'.
    With a mesh the scan stays as given ('auto' means the sortscan, as in
    the reference), and ``telemetry`` goes to the sharded driver.
    """
    from repro_torch.core.api import Detection

    opts_run = options
    if options.mesh is None:
        opts_run = dataclasses.replace(options, scan=options.resolved_scan(
            graph.nv, graph.m_cap, device_type=graph.device.type))
    C, stats = partition(graph, opts_run, phase_seconds=phase_seconds,
                         telemetry=telemetry)
    # int() and float() wait for the device, so the host clock is honest
    t0 = time.perf_counter()
    src, dst, w = strip_padding(graph.src, graph.dst, graph.w, graph.ghost)
    det = disconnected_communities(src, dst, w, C, graph.n_nodes)
    n_disconnected = int(det["n_disconnected"])
    t1 = time.perf_counter()
    q = float(modularity(src, dst, w, C))
    if phase_seconds is not None:
        phase_seconds["detector"] = t1 - t0
        phase_seconds["modularity"] = time.perf_counter() - t1
    return Detection(
        labels=C,
        n_communities=stats["n_communities"],
        n_disconnected=n_disconnected,
        modularity=q,
        stats=stats,
        contract=contract_for(options.algorithm),
        fraction=float(det["fraction"]),
    )


def tile_route(options) -> bool:
    """Whether a batch with these options can take the engine's tile
    (:func:`run_detection_tile`): every tier, with any split, on either
    scan (LPA has none), without a mesh.  A mesh runs one graph at a
    time, sharded."""
    return options.mesh is None


def _pick_tile(u, refined, standard):
    """:func:`_pick` of each graph of a tile: ``refined`` and ``standard``
    are :func:`~repro_torch.core.louvain.louvain_tile`'s ``(C [b, nv],
    stats)`` on the union ``u``.  Both candidates' Q come from
    :func:`~repro_torch.core.modularity.modularity_tile` on the union's
    live edges and are compared on the device, in float32, as ``_pick``
    compares them; the choice comes to the host in one copy.  Returns
    ``(C [b, nv], stats, Q float32 [b])``, the chosen candidate's."""
    b, nv = u.b, u.nv
    slot = torch.arange(b * nv, dtype=torch.int32, device=u.src.device)
    base = slot - torch.remainder(slot, nv)
    q_r, q_s = (modularity_tile(u.src, u.dst, u.w, C.view(b * nv) + base,
                                u.counts)
                for C in (refined[0], standard[0]))
    take_r = q_r >= q_s
    C = torch.where(take_r[:, None], refined[0], standard[0])
    q = torch.where(take_r, q_r, q_s)
    pick = take_r.cpu().tolist()
    stats = [(refined if r else standard)[1][g] for g, r in enumerate(pick)]
    return C, stats, q


def _partition_tile(stacked, u, options, scan):
    """:func:`partition` of each graph of a tile on its union ``u``, the
    pass loops on ``scan`` ('sort' or 'dense', as :func:`run_detection`
    resolves it): ``(C [b, nv] local ids, stats, Q float32 [b] or
    None)``; max-quality returns its chosen candidate's Q, which its pick
    computed."""
    algorithm = options.algorithm
    if algorithm == "fast":
        C, rounds, n_comms, _ = lpa_run_tile(stacked, union=u)
        return C, [dict(passes=1, li_last=int(r), li_total=int(r),
                        split_moved=0, n_communities=int(n))
                   for r, n in zip(rounds, n_comms.tolist())], None
    cfg = options.louvain
    if algorithm == "standard":
        C, stats, _ = louvain_tile(stacked, cfg, union=u, scan=scan)
        return C, stats, None
    # max-quality: the refined candidate, the GSP one, the better of each
    refined = louvain_tile(stacked, tier_config(algorithm, cfg), union=u,
                           scan=scan)
    standard = louvain_tile(stacked, _standard_config(cfg), union=u,
                            scan=scan)
    return _pick_tile(u, refined[:2], standard[:2])


def run_detection_tile(graphs, options):
    """:func:`run_detection` of several same-capacity graphs at once, the
    batched engine's tile (the reference's vmapped ``partition_impl`` +
    detector + modularity): one :class:`~repro_torch.core.api.Detection`
    a graph, each the bits of ``run_detection`` on it alone.

    Only for what :func:`tile_route` accepts (raises otherwise): the
    partition is :func:`~repro_torch.core.louvain.louvain_tile` (standard),
    two of them and a per-graph pick (max-quality) or
    :func:`~repro_torch.core.lpa.lpa_run_tile` (fast), all on one union
    of the graphs' live edges, with the scan that
    ``options.resolved_scan`` gives the stacked shape on its device, as
    :func:`run_detection` resolves it for each graph; then the detector
    and the modularity run once on that union, with one host copy for
    their counts and values."""
    from repro_torch.core.api import Detection
    from repro_torch.core.detect import disconnected_communities_tile

    stacked = stack_graphs(graphs)
    if not tile_route(options):
        raise ValueError("the tile runs every tier on either scan, without "
                         "a mesh")
    scan = options.resolved_scan(stacked.nv, stacked.m_cap,
                                 device_type=stacked.device.type)
    u = union_of(stacked)
    C, stats, q = _partition_tile(stacked, u, options, scan)
    b, nv = u.b, u.nv
    slot = torch.arange(b * nv, dtype=torch.int32, device=C.device)
    top = C.view(b * nv) + (slot - torch.remainder(slot, nv))
    node_valid = (torch.arange(nv, device=C.device)[None, :]
                  < stacked.n_nodes[:, None]).view(b * nv)
    det = disconnected_communities_tile(u.src, u.dst, u.w, top, node_valid,
                                        b)
    if q is None:
        q = modularity_tile(u.src, u.dst, u.w, top, u.counts)
    n_disc = det["n_disconnected"].cpu().tolist()
    frac, q = torch.stack([det["fraction"], q]).cpu().tolist()
    contract = contract_for(options.algorithm)
    return [Detection(labels=C[g], n_communities=stats[g]["n_communities"],
                      n_disconnected=n_disc[g], modularity=q[g],
                      stats=stats[g], contract=contract, fraction=frac[g])
            for g in range(b)]
