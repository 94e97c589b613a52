"""Fixed-size streaming latency histograms.

The service metrics used to keep every observed latency in an append-only
Python list — unbounded memory under sustained traffic.  A
:class:`StreamingHistogram` replaces the list with a fixed-size array of
log-spaced buckets: O(1) per observation, ~10 KB resident forever, and
percentiles within the bucket resolution.

Resolution contract: bucket bounds grow by ``GROWTH`` (2%) per bucket and
the reported percentile is the geometric midpoint of its bucket, so the
relative error is bounded by ``sqrt(GROWTH) - 1`` (~1%) — tight enough
that the service's p50/p99 reporting is indistinguishable from the exact
list-based math it replaced (asserted in tests/test_telemetry.py).  Exact
min/max are tracked on the side so the extreme percentiles (p0/p100) and
midpoints clamp to observed values.

The same class backs the in-memory aggregation sink and the Prometheus
exporter (:meth:`cumulative_le` renders the classic ``le`` bucket ladder
from the fine internal buckets).
"""
from __future__ import annotations

import math

import numpy as np

# bucket i covers [LO * GROWTH^i, LO * GROWTH^(i+1)); values below LO land
# in an underflow bucket, values above HI in an overflow bucket.  LO..HI
# spans 100ns..10^4s — any service latency representable.
LO = 1e-7
HI = 1e4
GROWTH = 1.02
_LOG_G = math.log(GROWTH)
N_BUCKETS = int(math.ceil(math.log(HI / LO) / _LOG_G))


class StreamingHistogram:
    """Log-bucketed streaming histogram over positive values (seconds)."""

    __slots__ = ("counts", "n", "total", "vmin", "vmax")

    def __init__(self):
        # +2: underflow at [0], overflow at [-1]
        self.counts = np.zeros(N_BUCKETS + 2, np.int64)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def add(self, x: float):
        x = float(x)
        if x != x:                       # NaN observations are dropped
            return
        self.n += 1
        self.total += x
        if x < self.vmin:
            self.vmin = x
        if x > self.vmax:
            self.vmax = x
        if x < LO:
            idx = 0
        elif x >= HI:
            idx = N_BUCKETS + 1
        else:
            idx = 1 + int(math.log(x / LO) / _LOG_G)
            idx = min(idx, N_BUCKETS)
        self.counts[idx] += 1

    def __len__(self) -> int:
        return self.n

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else float("nan")

    @property
    def sum(self) -> float:
        return self.total

    @staticmethod
    def _edges(idx: int) -> tuple:
        """(lo, hi) value bounds of internal bucket ``idx``."""
        if idx == 0:
            return 0.0, LO
        if idx == N_BUCKETS + 1:
            return HI, math.inf
        return LO * GROWTH ** (idx - 1), LO * GROWTH ** idx

    def percentile(self, p: float) -> float:
        """Approximate percentile (geometric bucket midpoint, clamped to
        the exact observed min/max).  ``nan`` when empty."""
        if not self.n:
            return float("nan")
        target = max(1, math.ceil(self.n * float(p) / 100.0))
        cum = 0
        for idx, c in enumerate(self.counts):
            if not c:
                continue
            cum += int(c)
            if cum >= target:
                lo, hi = self._edges(idx)
                mid = math.sqrt(lo * hi) if lo > 0.0 and hi < math.inf \
                    else (hi if lo == 0.0 else lo)
                return float(min(max(mid, self.vmin), self.vmax))
        return float(self.vmax)

    def cumulative_le(self, edge: float) -> int:
        """Observations known to be ``<= edge`` (Prometheus ``le``
        semantics; conservative — a bucket counts only when its whole
        range is below the edge, plus the exact-max refinement)."""
        if edge == math.inf:
            return self.n
        cum = 0
        for idx, c in enumerate(self.counts):
            if not c:
                continue
            lo, hi = self._edges(idx)
            if hi <= edge:
                cum += int(c)
        return cum

    def merge(self, other: "StreamingHistogram"):
        self.counts += other.counts
        self.n += other.n
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def __repr__(self):
        if not self.n:
            return "StreamingHistogram(empty)"
        return (f"StreamingHistogram(n={self.n}, mean={self.mean:.2e}, "
                f"p50={self.percentile(50):.2e}, "
                f"p99={self.percentile(99):.2e})")
