"""Degraded-tier results served while a bucket's breaker is open (or a
batch has exhausted its retries) — port of ``repro/resilience/degrade.py``.

Two modes, tried in the order the service configures:

* ``"stale"`` — the last *committed* partition from the result store,
  marked ``stale=True`` with its age in ``staleness_s``.  The partition
  carries the :class:`repro_torch.core.portfolio.QualityContract` of the
  tier that produced it, but it no longer reflects the current graph.
* ``"lpa"``   — the portfolio's **fast tier**
  (:func:`repro_torch.core.portfolio.run_detection` with
  ``algorithm='fast'``), flagged ``quality='degraded'``.  This is the
  SAME code path a request pinned to the fast tier takes, so
  LPA-under-breaker and LPA-as-requested-tier are bit-identical on the
  same graph and share one contract shape.  LPA can and does produce
  internally-disconnected communities — exactly the failure mode the
  paper's refinement fixes — and ``n_disconnected`` reports the measured
  count instead of pretending otherwise.

Either way the result is a :class:`DegradedResult`, never a
:class:`~repro_torch.service.store.StoreEntry`: ``guarantee`` is always
``False``, degraded output is never committed back to the store, and
callers can separate it from full-quality results by type.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.api import DetectOptions
from repro_torch.core.portfolio import (
    QualityContract, contract_for, run_detection,
)
from repro_torch.device import resolve_device


@dataclasses.dataclass
class DegradedResult:
    """A reduced-quality answer, explicitly NOT carrying the paper's
    zero-internally-disconnected guarantee (``guarantee=False``).
    ``contract`` records the producing tier's flags — the stale mode
    keeps the committed entry's contract (true when committed, now
    stale), the lpa mode carries the fast tier's all-False contract."""

    graph_id: str
    C: np.ndarray                 # int32 labels over the padded node axis
    n_communities: int
    q: float                      # modularity of the served partition
    mode: str                     # "stale" | "lpa"
    quality: str                  # "stale" | "degraded"
    stale: bool
    staleness_s: float            # age of the served partition (0 if fresh)
    version: int = 0              # store version served (stale mode only)
    n_disconnected: Optional[int] = None  # None = unknown
    guarantee: bool = False
    contract: Optional[QualityContract] = None


def stale_result(graph_id: str, entry, *, now: float) -> DegradedResult:
    """Serve the last committed partition from a store entry."""
    return DegradedResult(
        graph_id=graph_id,
        C=np.asarray(entry.C),
        n_communities=int(entry.n_communities),
        q=float(entry.q),
        mode="stale",
        quality="stale",
        stale=True,
        staleness_s=max(float(now) - float(entry.t_stored), 0.0),
        version=int(entry.version),
        n_disconnected=int(entry.n_disconnected),
        contract=contract_for(getattr(entry, "algorithm", "standard")),
    )


def lpa_result(graph_id: str, graph, *, options=None,
               device=None) -> DegradedResult:
    """Compute a fresh fast-tier partition for ``graph`` through the
    portfolio dispatch — one code path with requested-tier LPA.

    ``options``: the service's :class:`repro_torch.core.api.DetectOptions`
    (its other fields carry over; the algorithm is forced to ``'fast'``
    and the mesh is dropped: the degraded path runs on one device, as the
    reference's).  Runs on ``device`` (``None`` = CUDA, as ``detect()``),
    moving the graph there first if needed.  The reference's
    ``telemetry`` has no counterpart: ``run_detection`` reads it only on
    the sharded path.  ``C`` comes back as host int32, as the reference's.
    """
    opts = (options or DetectOptions()).replace(algorithm="fast", mesh=None)
    det = run_detection(graph.to(resolve_device(device)), opts)
    return DegradedResult(
        graph_id=graph_id,
        C=det.labels.cpu().numpy().astype(np.int32),
        n_communities=int(det.n_communities),
        q=float(det.modularity),
        mode="lpa",
        quality="degraded",
        stale=False,
        staleness_s=0.0,
        n_disconnected=int(det.n_disconnected),
        contract=det.contract,
    )
