"""SLO-tiered algorithm portfolio (port of ``repro/core/portfolio.py``).

One dispatch over the tiers of ``DetectOptions.algorithm``, each with the
:class:`QualityContract` it stamps on its results.  Ported so far: the
'standard' tier (GSP-Louvain, the paper).  'fast' (LPA) and 'max-quality'
(Leiden-style refine) raise until ROADMAP item A.5 ports them.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.core.detect import disconnected_communities
from repro_torch.core.louvain import louvain_impl
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


def partition(g, options, *, phase_seconds=None):
    """Run one portfolio tier on one graph where it lies: ``(C, stats)``."""
    contract_for(options.algorithm)
    if options.algorithm != "standard":
        raise NotImplementedError(
            f"algorithm={options.algorithm!r} is not ported yet "
            "(ROADMAP queue A, item 5)")
    return louvain_impl(g, options.louvain, phase_seconds=phase_seconds)


def run_detection(graph, options, *, phase_seconds=None):
    """Partition + detector + modularity + contract: the body of
    :func:`repro_torch.core.api.detect`.

    ``n_disconnected`` is always measured, so the tier's contract is
    checked, not assumed.  ``phase_seconds`` (a dict or ``None``) collects
    the pass loop's phase times plus 'detector' and 'modularity'.
    """
    from repro_torch.core.api import Detection

    C, stats = partition(graph, options, phase_seconds=phase_seconds)
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
    )
