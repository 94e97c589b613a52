"""Span/trace layer: per-request lifecycle timing.

A request through the service passes a fixed set of phases::

    submit -> admission -> queue-wait -> drr-compose -> repad ->
    compile(hit/miss) -> engine-dispatch -> device-sync ->
    store-commit -> resolve

Each phase is recorded as a :class:`Span` — a name plus monotonic-clock
``(t_start, t_end)`` — inside the request's :class:`RequestTrace`.  The
trace id is the request id (``d17-gid`` / ``u3-gid``), surfaced on
``DetectionFuture.trace`` so callers can inspect where their time went
without any global registry.

Per-request phases (``submit``, ``admission``, ``queue-wait``,
``repad``, ``store-commit``, ``resolve``) are marked individually;
batch-level phases (``drr-compose``, ``compile``, ``engine-dispatch``,
``device-sync``) happen once per dispatched batch and are stamped onto
every member request's trace with the same interval — a trace therefore
reads as "this request's batch spent X in the engine", which is the
number that matters for per-phase latency attribution.

Spans carry optional string labels (e.g. ``compile`` marks
``hit="true"|"false"``).  Completed traces are broadcast to the
telemetry hub (:mod:`repro_torch.telemetry.sinks`) at resolve time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional

# canonical phase taxonomy, in lifecycle order (docs + tests key off this)
PHASES = (
    "submit",          # entry-point work before enqueue (validate, repad..)
    "admission",       # bound check + locked enqueue
    "queue-wait",      # enqueue -> popped by DRR compose
    "drr-compose",     # weighted-DRR batch composition
    "repad",           # bucket padding (inside submit on the detect path)
    "compile",         # jit cache consult; labels: hit=true|false
    "engine-dispatch", # dispatch (host -> device)
    "device-sync",     # device -> host transfer + np conversion
    "store-commit",    # versioned store write
    "resolve",         # future resolution fan-out
)

# phases grouped for the replay harness's breakdown report
PHASE_GROUPS: Dict[str, str] = {
    "queue-wait": "queue",
    "compile": "engine",
    "engine-dispatch": "engine",
    "device-sync": "engine",
}


def phase_group(name: str) -> str:
    """queue / engine / host bucket for a span name."""
    return PHASE_GROUPS.get(name, "host")


@dataclasses.dataclass
class Span:
    """One timed phase of a request (monotonic-clock endpoints)."""

    name: str
    t_start: float
    t_end: float
    trace_id: str = ""
    labels: Optional[Dict[str, str]] = None

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start

    def as_dict(self) -> dict:
        d = dict(name=self.name, trace_id=self.trace_id,
                 t_start=self.t_start, t_end=self.t_end,
                 duration_s=self.duration_s)
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


class RequestTrace:
    """Ordered spans for one request; the trace id is the request id."""

    __slots__ = ("trace_id", "tenant", "kind", "spans", "clock")

    def __init__(self, trace_id: str, *, tenant: str = "default",
                 kind: str = "detect",
                 clock: Optional[Callable[[], float]] = None):
        self.trace_id = trace_id
        self.tenant = tenant
        self.kind = kind
        self.spans: List[Span] = []
        self.clock = clock or time.perf_counter

    def mark(self, name: str, t_start: float, t_end: float,
             **labels: str) -> Span:
        """Record a phase from externally-measured endpoints (used for
        batch-level phases stamped onto every member request)."""
        s = Span(name, float(t_start), float(t_end), self.trace_id,
                 labels or None)
        self.spans.append(s)
        return s

    @contextlib.contextmanager
    def span(self, name: str, **labels: str):
        """Context-manager phase: ``with trace.span("repad"): ...``."""
        t0 = self.clock()
        try:
            yield
        finally:
            self.mark(name, t0, self.clock(), **labels)

    def durations(self) -> Dict[str, float]:
        """Total seconds per phase name (a repeated phase accumulates)."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.duration_s
        return out

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def __len__(self) -> int:
        return len(self.spans)

    def __repr__(self):
        parts = ", ".join(f"{s.name}={s.duration_s * 1e3:.2f}ms"
                          for s in self.spans)
        return f"RequestTrace({self.trace_id!r}: {parts})"
