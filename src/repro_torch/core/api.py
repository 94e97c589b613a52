"""Unified detection API (port of ``repro/core/api.py``):
:class:`DetectOptions` + :func:`detect`.

    from repro_torch.core import detect
    res = detect(g)                  # on CUDA; detect(g, device="cpu")
    res.labels, res.modularity, res.n_disconnected

Ported fields: ``algorithm``, ``louvain`` and ``scan``.  ``scan='auto'``
resolves to the sortscan until the dense twin and its crossover are ported
(ROADMAP queue A, item 6); the reference guarantees both scans give the
same labels bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.louvain import LouvainConfig
from repro_torch.core.portfolio import (
    ALGORITHMS, QualityContract, run_detection,
)
from repro_torch.device import resolve_device

_SCANS = ("auto", "sort", "dense")


@dataclasses.dataclass(frozen=True)
class DetectOptions:
    """Everything that selects *how* detection runs (not *what* graph).

    Fields:
      algorithm: 'fast' | 'standard' | 'max-quality' — the portfolio tier.
      louvain:   the algorithm config (passes, tolerance ladder, split).
      scan:      'auto' | 'sort' — community-scan layout; 'dense' is not
                 ported yet and raises.
    """

    algorithm: str = "standard"
    louvain: LouvainConfig = LouvainConfig()
    scan: str = "auto"

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"algorithm must be one of {ALGORITHMS}, "
                f"got {self.algorithm!r}")
        if self.scan not in _SCANS:
            raise ValueError(f"scan must be one of {_SCANS}, got {self.scan!r}")
        if self.scan == "dense":
            raise NotImplementedError(
                "scan='dense' is not ported yet (ROADMAP queue A, item 6)")


@dataclasses.dataclass(frozen=True)
class Detection:
    """Result of :func:`detect`."""

    labels: torch.Tensor       # int32[nv] dense community membership
    n_communities: int
    n_disconnected: int        # paper invariant: 0 for every sp-* run
    modularity: float
    stats: dict                # pass-loop stats (passes, li_total, ...)
    contract: Optional[QualityContract] = None


def detect(graph, *, options: Optional[DetectOptions] = None, device=None,
           phase_seconds: Optional[dict] = None) -> Detection:
    """Run community detection on one graph — the unified entry point.

    Runs on ``device`` (``None`` = CUDA; raises when CUDA is absent),
    moving the graph there first if needed.  ``phase_seconds``, if given,
    collects per-phase wall seconds (see ``louvain_impl``).  ``labels``
    include the ghost/padding slots; mask with ``graph.node_mask()``.
    """
    opts = options if options is not None else DetectOptions()
    graph = graph.to(resolve_device(device))
    return run_detection(graph, opts, phase_seconds=phase_seconds)
