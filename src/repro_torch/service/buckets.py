"""Size buckets and the dense-vs-sortscan crossover (port of
``repro/service/buckets.py``; the bucket admission itself, ``admit``,
``live_edges`` and the filler graphs, comes with the batched engine).

Buckets are the static ``(n_cap, m_cap)`` capacities the service pads its
graphs to; the default ladder grows by about 4x a rung and offers two edge
densities per vertex rung.  :func:`choose_scan` picks, per shape, the
dense ``[nv, nv]`` community-matrix scan or the sortscan.  Both give the
same labels bit for bit, so it is a cost choice only.

The measured crossover lives in ``dense_scan_calib.json`` beside this
module, keyed by torch device type (``"cuda"``, ``"cpu"``), and written by
``scripts/torch_calibrate_dense_scan.py``.  A missing file or key falls back
to :data:`DEFAULT_DENSE_MIN_DENSITY`, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
from typing import Optional, Sequence

# the reference's CPU-tuned fallback when no calibration is on file
DEFAULT_DENSE_MIN_DENSITY = 0.02
CALIB_FILE = pathlib.Path(__file__).with_name("dense_scan_calib.json")


@functools.lru_cache(maxsize=None)
def calibrated_min_density(device_type: str = "cuda") -> float:
    """The measured dense/sort crossover density for ``device_type``,
    read once per type from :data:`CALIB_FILE`; the default 0.02 where
    the file or the key is missing."""
    try:
        entry = json.loads(CALIB_FILE.read_text()).get(device_type)
        if entry is not None:
            return float(entry["dense_min_density"])
    except (OSError, ValueError, KeyError):
        pass
    return DEFAULT_DENSE_MIN_DENSITY


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """A static (vertex, directed-edge) capacity pair; ordering is by
    (n_cap, m_cap) so sorted ladders try small buckets first."""

    n_cap: int
    m_cap: int

    @property
    def nv(self) -> int:
        return self.n_cap + 1


DEFAULT_BUCKETS: tuple[Bucket, ...] = (
    Bucket(64, 512),
    Bucket(64, 2048),
    Bucket(256, 2048),
    Bucket(256, 8192),
    Bucket(1024, 16384),
)


def choose_bucket(n_nodes: int, m_directed: int,
                  buckets: Sequence[Bucket] = DEFAULT_BUCKETS) -> Bucket:
    """Smallest bucket admitting ``n_nodes`` vertices and ``m_directed``
    directed edges; raises ``ValueError`` if none fits."""
    for b in sorted(buckets):
        if n_nodes <= b.n_cap and m_directed <= b.m_cap:
            return b
    raise ValueError(
        f"no bucket fits n={n_nodes}, m={m_directed} "
        f"(ladder max {max(sorted(buckets))})"
    )


def choose_scan(nv: int, m_cap: int, *, dense_max_nv: int = 1025,
                dense_small_nv: int = 129,
                dense_min_density: Optional[float] = None,
                device_type: str = "cuda") -> str:
    """'dense' or 'sort' for a graph of ``nv`` node slots and ``m_cap``
    edge slots.

    Above ``dense_max_nv`` the ``[nv, nv]`` matrices cost too much and the
    sortscan is taken; at or below ``dense_small_nv`` the matrix is small
    outright and the dense scan is taken; between the two, the dense scan
    is taken where ``m_cap / nv**2`` reaches ``dense_min_density``
    (``None``: the calibrated crossover of ``device_type``).
    """
    if dense_min_density is None:
        dense_min_density = calibrated_min_density(device_type)
    if nv > dense_max_nv:
        return "sort"
    if nv <= dense_small_nv:
        return "dense"
    return "dense" if m_cap >= dense_min_density * (nv * nv) else "sort"
