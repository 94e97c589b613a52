"""Unified detection API (port of ``repro/core/api.py``):
:class:`DetectOptions` + :func:`detect`.

    from repro_torch.core import detect
    res = detect(g)                  # on CUDA; detect(g, device="cpu")
    res.labels, res.modularity, res.n_disconnected

Ported fields: ``algorithm``, ``louvain``, ``scan`` and the dense-scan
crossover (``dense_max_nv``, ``dense_small_nv``, ``dense_min_density``).
``detect()`` resolves ``scan='auto'`` by the graph's shape
(:meth:`DetectOptions.resolved_scan`), as the reference's does: small
graphs take the dense scan.  Both scans give the same labels bit for bit.
The reference's ``seg_impl``, ``block_m`` and ``mesh`` have no counterpart
yet: dispatch is by device (``kernels/ops.py``), and sharding is ROADMAP
queue A, item 10.
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
from repro_torch.service.buckets import choose_scan

_SCANS = ("auto", "sort", "dense")


@dataclasses.dataclass(frozen=True)
class DetectOptions:
    """Everything that selects *how* detection runs (not *what* graph).

    Fields:
      algorithm: 'fast' | 'standard' | 'max-quality' — the portfolio tier.
      louvain:   the algorithm config (passes, tolerance ladder, split).
      scan:      'auto' | 'sort' | 'dense' — community-scan layout; 'auto'
                 resolves per shape (:meth:`resolved_scan`).
      dense_max_nv / dense_small_nv / dense_min_density: the dense-scan
                 crossover thresholds 'auto' consults
                 (``service/buckets.py:choose_scan``).
    """

    algorithm: str = "standard"
    louvain: LouvainConfig = LouvainConfig()
    scan: str = "auto"
    dense_max_nv: int = 1025
    dense_small_nv: int = 129
    dense_min_density: Optional[float] = None

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"algorithm must be one of {ALGORITHMS}, "
                f"got {self.algorithm!r}")
        if self.scan not in _SCANS:
            raise ValueError(f"scan must be one of {_SCANS}, got {self.scan!r}")

    def resolved_scan(self, nv: int, m_cap: int, *,
                      device_type: str = "cuda") -> str:
        """Concrete 'sort' | 'dense' for a shape: ``scan`` itself, or for
        'auto' the crossover of ``choose_scan`` (with the calibration of
        ``device_type`` where ``dense_min_density`` is ``None``)."""
        if self.scan != "auto":
            return self.scan
        return choose_scan(nv, m_cap, dense_max_nv=self.dense_max_nv,
                           dense_small_nv=self.dense_small_nv,
                           dense_min_density=self.dense_min_density,
                           device_type=device_type)


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
