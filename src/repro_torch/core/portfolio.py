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

Stats are the same five Python ints for every tier (passes / li_last /
li_total / split_moved / n_communities).
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.core import _segments as seg
from repro_torch.core.detect import disconnected_communities
from repro_torch.core.louvain import LouvainConfig, _Clock, louvain_impl
from repro_torch.core.lpa import lpa_run
from repro_torch.core.modularity import modularity
from repro_torch.graph.container import strip_padding

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


def partition(g, options, *, phase_seconds=None):
    """Run one portfolio tier on one graph where it lies: ``(C, stats)``.

    The pass loops run ``options.scan``, where 'auto' means 'sort', as in
    the reference's ``partition`` (:func:`run_detection` resolves 'auto'
    by the graph's shape first).  The fast tier has no scan.

    ``phase_seconds`` (a dict or ``None``) collects the phases of the pass
    loop (both of max-quality's candidates add into the same keys), 'lpa'
    for the fast tier, and 'select' for max-quality's two modularities.
    """
    algorithm = options.algorithm
    contract_for(algorithm)
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
    live = strip_padding(g.src, g.dst, g.w, g.ghost)
    clock = _Clock(phase_seconds, g.device)
    q_r = clock.run("select", modularity, *live, C_r)
    q_s = clock.run("select", modularity, *live, C_s)
    return (C_r, st_r) if bool(q_r >= q_s) else (C_s, st_s)


def run_detection(graph, options, *, phase_seconds=None):
    """Partition + detector + modularity + contract: the body of
    :func:`repro_torch.core.api.detect`.

    ``scan='auto'`` is resolved by the graph's shape first
    (``DetectOptions.resolved_scan``, on the graph's device type), as the
    reference's ``run_detection`` does: small graphs take the dense scan.
    ``n_disconnected`` is always measured, so the tier's contract is
    checked, not assumed.  ``phase_seconds`` (a dict or ``None``) collects
    :func:`partition`'s phase times plus 'detector' and 'modularity'.
    """
    from repro_torch.core.api import Detection

    opts_run = dataclasses.replace(options, scan=options.resolved_scan(
        graph.nv, graph.m_cap, device_type=graph.device.type))
    C, stats = partition(graph, opts_run, phase_seconds=phase_seconds)
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
