"""Deterministic, seedable fault injection at the service's real seams
(port of ``repro/resilience/faults.py``: one plan fires at the same calls
in both packages).

A :class:`FaultPlan` is handed to the seams that consult it — never
monkeypatched in — where a production deployment actually fails (the
engine takes it as ``faults=``; the service's config installs it with the
front end, ROADMAP A.11):

======================  =================================================
seam                    where it fires
======================  =================================================
``engine.detect``       inside :meth:`BatchedLouvainEngine.detect_batch`,
                        before the first graph runs (raise)
``engine.detect.hang``  same place, but sleeps ``hang_s`` instead of
                        raising — a stuck dispatch for the watchdog
``engine.update``       inside ``update_batch`` (raise)
``engine.update.hang``  same place, sleeping
``store.commit``        around every store write the front end makes
                        (fresh-detect ``put`` and warm ``commit_update``)
``checkpoint.io``       after an automatic snapshot lands: the written
                        ``arrays.npz`` is byte-truncated, simulating a
                        torn write the atomic rename could not prevent
``telemetry.sink``      a :class:`FaultySink` registered on the hub
                        raises from its event hooks
======================  =================================================

Each seam carries one or more :class:`FaultSpec` triggers: fire with
probability ``p`` per eligible call, at most ``count`` times, skipping the
first ``skip`` eligible calls, optionally only when the dispatched batch
contains one of ``graph_ids`` (the "poison graph" used by the split-retry
tests).  ``error="capacity"`` raises a :class:`TransientCapacityError`
(a retryable :class:`repro_torch.core.dynamic.CapacityError`) instead of the
generic :class:`FaultError`.  All randomness comes from per-spec
``random.Random`` streams seeded from ``(seed, seam, index)``, so a plan
fires identically run-to-run regardless of thread interleaving across
seams.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core.dynamic import CapacityError
from repro_torch.telemetry.sinks import MetricSink


class FaultError(RuntimeError):
    """An injected failure (see the seam it fired at on ``.seam``)."""

    def __init__(self, seam: str, msg: Optional[str] = None):
        self.seam = seam
        super().__init__(msg or f"injected fault at seam {seam!r}")


class TransientCapacityError(CapacityError):
    """Injected *transient* capacity fault.

    Subclasses the real :class:`repro_torch.core.dynamic.CapacityError` so
    callers see the production error type, but — unlike a genuine bucket
    overflow — a retry is expected to succeed (the retry policy treats it
    as retryable)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One trigger at one seam.

    p:         firing probability per eligible call (1.0 = always).
    count:     max firings over the plan's lifetime (None = unlimited).
    skip:      skip the first N eligible calls (lets a warm-up pass).
    hang_s:    > 0 sleeps instead of raising (a hung dispatch).
    error:     "fault" raises :class:`FaultError`; "capacity" raises
               :class:`TransientCapacityError`.
    graph_ids: when set, the spec is eligible only for calls whose
               ``ids`` intersect it (per-graph poison).
    """

    p: float = 1.0
    count: Optional[int] = None
    skip: int = 0
    hang_s: float = 0.0
    error: str = "fault"
    graph_ids: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"p must be in [0, 1], got {self.p}")
        if self.count is not None and self.count < 0:
            raise ValueError(f"count must be >= 0, got {self.count}")
        if self.skip < 0:
            raise ValueError(f"skip must be >= 0, got {self.skip}")
        if self.hang_s < 0:
            raise ValueError(f"hang_s must be >= 0, got {self.hang_s}")
        if self.error not in ("fault", "capacity"):
            raise ValueError(
                f"error must be 'fault' or 'capacity', got {self.error!r}")
        if self.graph_ids is not None:
            object.__setattr__(self, "graph_ids", tuple(self.graph_ids))


SpecLike = Union[FaultSpec, Sequence[FaultSpec]]


class FaultPlan:
    """A seeded map of seam -> fault triggers, with injection counters.

    Thread-safe; decisions are deterministic per seam given the sequence
    of eligible calls at that seam (per-spec RNG streams).  ``injected``
    counts firings per seam; ``on_inject`` (set by the resilience
    manager) mirrors each firing to the telemetry hub.
    """

    def __init__(self, specs: Mapping[str, SpecLike], *, seed: int = 0):
        self.seed = int(seed)
        self._specs: Dict[str, Tuple[FaultSpec, ...]] = {}
        for seam, sp in dict(specs).items():
            if isinstance(sp, FaultSpec):
                sp = (sp,)
            self._specs[str(seam)] = tuple(sp)
        self._lock = threading.Lock()
        self.on_inject = None          # callable(seam) | None
        self.reset()

    @property
    def seams(self) -> Tuple[str, ...]:
        return tuple(self._specs)

    def spec(self, seam: str) -> Tuple[FaultSpec, ...]:
        return self._specs.get(seam, ())

    def reset(self):
        """Rewind every trigger and counter to the plan's initial state
        (a fresh, identical run)."""
        with self._lock:
            self._rngs = {
                (seam, i): random.Random(f"{self.seed}:{seam}:{i}")
                for seam, specs in self._specs.items()
                for i in range(len(specs))}
            self._eligible = {k: 0 for k in self._rngs}
            self._fired = {k: 0 for k in self._rngs}
            self.injected: Dict[str, int] = {s: 0 for s in self._specs}

    def injected_total(self) -> int:
        return sum(self.injected.values())

    def perturb(self, seam: str, ids: Optional[Sequence[str]] = None):
        """Consult ``seam``: sleep for a triggered hang spec, raise for a
        triggered error spec, otherwise return.  ``ids`` are the graph
        ids of the call (for ``graph_ids``-scoped specs; specs with a
        scope never fire when ids are unknown)."""
        specs = self._specs.get(seam)
        if not specs:
            return
        for i, spec in enumerate(specs):
            fire = False
            with self._lock:
                if spec.graph_ids is not None:
                    if ids is None or not set(spec.graph_ids).intersection(
                            ids):
                        continue
                key = (seam, i)
                if spec.count is not None and self._fired[key] >= spec.count:
                    continue
                self._eligible[key] += 1
                if self._eligible[key] <= spec.skip:
                    continue
                if spec.p < 1.0 and self._rngs[key].random() >= spec.p:
                    continue
                self._fired[key] += 1
                self.injected[seam] += 1
                fire = True
            if not fire:
                continue
            hook = self.on_inject
            if hook is not None:
                try:
                    hook(seam)
                except Exception:       # observability must not re-raise
                    pass
            if spec.hang_s > 0.0:
                time.sleep(spec.hang_s)
                continue
            if spec.error == "capacity":
                raise TransientCapacityError(
                    f"injected transient capacity fault at {seam!r}")
            raise FaultError(seam)

    def __repr__(self):
        return (f"FaultPlan(seed={self.seed}, seams={list(self._specs)}, "
                f"injected={self.injected_total()})")


class FaultySink(MetricSink):
    """A telemetry sink that raises per the plan's ``telemetry.sink``
    seam — exercises the hub's sink-error isolation (and the bounded
    ``sink_errors`` record) without monkeypatching.  Registered
    automatically by the front end when the installed plan names the
    seam.  Resilience/fault counters are ignored so the injection
    bookkeeping cannot recurse into itself."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def on_counter(self, name, value, labels=None):
        if name.startswith(("faults_", "resilience_")):
            return
        self.plan.perturb("telemetry.sink")

    def on_gauge(self, name, value, labels=None):
        self.plan.perturb("telemetry.sink")

    def on_span(self, span):
        self.plan.perturb("telemetry.sink")
