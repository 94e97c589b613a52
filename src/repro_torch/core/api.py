"""Unified detection API (port of ``repro/core/api.py``):
:class:`DetectOptions` + :func:`detect`.

    from repro_torch.core import detect
    res = detect(g)                  # on CUDA; detect(g, device="cpu")
    res.labels, res.modularity, res.n_disconnected

Ported fields: ``algorithm``, ``louvain``, ``scan``, the dense-scan
crossover (``dense_max_nv``, ``dense_small_nv``, ``dense_min_density``)
and ``mesh``.  ``detect()`` resolves ``scan='auto'`` by the graph's shape
(:meth:`DetectOptions.resolved_scan`), as the reference's does: small
graphs take the dense scan.  Both scans give the same labels bit for bit.
With a ``mesh`` (an int or a ``launch.mesh.Mesh``) detection runs sharded
(``core/distributed.py``), with the same labels as without one.

The reference's ``seg_impl`` and ``block_m`` have no counterpart: dispatch
is by device (``kernels/ops.py``) and the segment-reduce kernel's tile is
compiled in.  So :meth:`DetectOptions.cache_key` keys on the tier and the
scan alone (the mesh is left out, as in the reference).  The port never
had the reference's flat legacy keywords (``cfg=``, ``dense_max_nv=``,
``mesh=``, ...): callers pass ``options=``, and any other keyword,
``seg_impl``, ``block_m`` and ``seg_block_m`` among them, raises Python's
own ``TypeError``.
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
from repro_torch.launch.mesh import Mesh, resolve_mesh

_SCANS = ("auto", "sort", "dense")


@dataclasses.dataclass(frozen=True)
class DetectOptions:
    """Everything that selects *how* detection runs (not *what* graph).

    Frozen and hashable: the batched engine and the result store key on
    (subsets of) this record through :meth:`cache_key`.

    Fields:
      algorithm: 'fast' | 'standard' | 'max-quality' — the portfolio tier.
      louvain:   the algorithm config (passes, tolerance ladder, split).
      scan:      'auto' | 'sort' | 'dense' — community-scan layout; 'auto'
                 resolves per shape (:meth:`resolved_scan`).
      dense_max_nv / dense_small_nv / dense_min_density: the dense-scan
                 crossover thresholds 'auto' consults
                 (``service/buckets.py:choose_scan``).
      mesh:      None (one device), an int (that many ranks on the
                 graph's device kind) or a ``launch.mesh.Mesh``: the
                 sharded single-graph path (:meth:`resolved_mesh`).
    """

    algorithm: str = "standard"
    louvain: LouvainConfig = LouvainConfig()
    scan: str = "auto"
    dense_max_nv: int = 1025
    dense_small_nv: int = 129
    dense_min_density: Optional[float] = None
    mesh: object = None

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"algorithm must be one of {ALGORITHMS}, "
                f"got {self.algorithm!r}")
        if self.scan not in _SCANS:
            raise ValueError(f"scan must be one of {_SCANS}, got {self.scan!r}")
        if self.mesh is not None and (
                isinstance(self.mesh, bool)
                or not isinstance(self.mesh, (int, Mesh))):
            raise TypeError(
                f"mesh must be None, an int or a Mesh, got {self.mesh!r}")

    def replace(self, **kw) -> "DetectOptions":
        return dataclasses.replace(self, **kw)

    def resolved_scan(self, nv: int, m_cap: int, *,
                      device_type: str = "cuda") -> str:
        """Concrete 'sort' | 'dense' for a shape: ``scan`` itself, or for
        'auto' the crossover of ``choose_scan`` (with the calibration of
        ``device_type`` where ``dense_min_density`` is ``None``; a lazy
        import keeps core below the service layer)."""
        if self.scan != "auto":
            return self.scan
        from repro_torch.service.buckets import choose_scan
        return choose_scan(nv, m_cap, dense_max_nv=self.dense_max_nv,
                           dense_small_nv=self.dense_small_nv,
                           dense_min_density=self.dense_min_density,
                           device_type=device_type)

    def resolved_mesh(self, device=None) -> Optional[Mesh]:
        """``None``, or a concrete :class:`~repro_torch.launch.mesh.Mesh`:
        an int is that many ranks of ``make_host_mesh`` on ``device``'s kind
        (``None`` = CUDA), raising when there are fewer cards, as the
        reference raises with fewer devices."""
        return resolve_mesh(self.mesh, device)

    def cache_key(self, *parts, algorithm: Optional[str] = None,
                  scan: Optional[str] = None) -> tuple:
        """The dispatch key: shape/phase ``parts`` + the tier + the scan
        (``algorithm``/``scan`` override with per-request / per-bucket
        resolved values).  The reference's key also carries ``seg_impl``
        and ``block_m``, which the port does not have; neither key has the
        mesh."""
        return (*parts,
                self.algorithm if algorithm is None else algorithm,
                self.scan if scan is None else scan)

    def result_key(self, algorithm: Optional[str] = None) -> tuple:
        """Hashable identity of *what produced a stored partition*: the
        tier + the full LouvainConfig + the scan.  The result store stamps
        it on every entry and refuses warm updates under another key."""
        return self.cache_key(self.louvain, algorithm=algorithm)


@dataclasses.dataclass(frozen=True)
class Detection:
    """Result of :func:`detect`."""

    labels: torch.Tensor       # int32[nv] dense community membership
    n_communities: int
    n_disconnected: int        # paper invariant: 0 for every sp-* run
    modularity: float
    stats: dict                # pass-loop stats (passes, li_total, ...)
    contract: Optional[QualityContract] = None
    fraction: float = 0.0      # n_disconnected / n_communities (f32 ratio)


def detect(graph, *, options: Optional[DetectOptions] = None, device=None,
           phase_seconds: Optional[dict] = None) -> Detection:
    """Run community detection on one graph — the unified entry point.

    Runs on ``device`` (``None`` = CUDA; raises when CUDA is absent),
    moving the graph there first if needed.  ``phase_seconds``, if given,
    collects per-phase wall seconds (see ``louvain_impl``; with a mesh only
    'select', 'detector' and 'modularity').  ``labels`` include the
    ghost/padding slots; mask with ``graph.node_mask()``.
    """
    opts = options if options is not None else DetectOptions()
    graph = graph.to(resolve_device(device))
    return run_detection(graph, opts, phase_seconds=phase_seconds)
