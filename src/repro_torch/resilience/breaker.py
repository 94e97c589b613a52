"""Per-bucket circuit breaker with half-open probing (port of
``repro/resilience/breaker.py``; host code, clock injected).

Each admission bucket gets its own :class:`CircuitBreaker` (one sick
compiled shape must not blind the healthy ones).  The breaker trips OPEN
after ``failure_threshold`` consecutive failures — a success slower than
``latency_threshold_s`` counts as a failure, so a silently-degrading
device also trips it.  While OPEN the front end sheds the bucket's
requests to the degraded tier (see :mod:`repro_torch.resilience.degrade`).
After ``cooldown_s`` the breaker admits ``half_open_probes`` probe
dispatches; one success closes it, one failure re-opens it.

State transitions are emitted as the ``breaker_state`` gauge
(0 = closed, 1 = half-open, 2 = open) labelled by bucket.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

CLOSED = "closed"
HALF_OPEN = "half-open"
OPEN = "open"

STATE_CODES = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class BreakerOpen(RuntimeError):
    """The bucket's circuit breaker is open and no degraded tier is
    available for the request."""


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    failure_threshold: int = 5
    cooldown_s: float = 1.0
    latency_threshold_s: Optional[float] = None
    half_open_probes: int = 1

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got "
                f"{self.failure_threshold}")
        if self.cooldown_s <= 0:
            raise ValueError(
                f"cooldown_s must be > 0, got {self.cooldown_s}")
        if self.latency_threshold_s is not None \
                and self.latency_threshold_s <= 0:
            raise ValueError(
                f"latency_threshold_s must be > 0, got "
                f"{self.latency_threshold_s}")
        if self.half_open_probes < 1:
            raise ValueError(
                f"half_open_probes must be >= 1, got "
                f"{self.half_open_probes}")


class CircuitBreaker:
    """CLOSED -> OPEN -> HALF_OPEN state machine; thread-safe, clock
    injected for tests."""

    def __init__(self, config: BreakerConfig, *,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition=None):
        self.config = config
        self.clock = clock
        self.on_transition = on_transition  # callable(state) | None
        self._lock = threading.Lock()
        self._state = CLOSED
        self._streak = 0                # consecutive failures (incl. slow)
        self._opened_at = 0.0
        self._probes = 0                # probes admitted while half-open
        self.n_opens = 0

    # -- internal (lock held) -------------------------------------------
    def _poll(self):
        if self._state == OPEN and \
                self.clock() - self._opened_at >= self.config.cooldown_s:
            self._probes = 0
            self._set(HALF_OPEN)

    def _set(self, state: str):
        if state == self._state:
            return
        self._state = state
        hook = self.on_transition
        if hook is not None:
            try:
                hook(state)
            except Exception:           # observability must not re-raise
                pass

    def _trip(self):
        self._opened_at = self.clock()
        self.n_opens += 1
        self._streak = 0
        self._set(OPEN)

    def _note_failure(self):
        if self._state == HALF_OPEN:
            self._trip()
            return
        self._streak += 1
        if self._state == CLOSED and \
                self._streak >= self.config.failure_threshold:
            self._trip()

    # -- public ---------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            self._poll()
            return self._state

    def allow(self) -> bool:
        """May a dispatch proceed right now?  Admits everything while
        CLOSED, nothing while OPEN (pre-cooldown), and up to
        ``half_open_probes`` probes while HALF_OPEN."""
        with self._lock:
            self._poll()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and \
                    self._probes < self.config.half_open_probes:
                self._probes += 1
                return True
            return False

    def record_success(self, latency_s: Optional[float] = None):
        with self._lock:
            cfg = self.config
            if cfg.latency_threshold_s is not None \
                    and latency_s is not None \
                    and latency_s > cfg.latency_threshold_s:
                self._note_failure()    # slow success counts as failure
                return
            self._streak = 0
            if self._state == HALF_OPEN:
                self._set(CLOSED)

    def record_failure(self):
        with self._lock:
            self._note_failure()


def _bucket_label(key) -> str:
    n_cap = getattr(key, "n_cap", None)
    m_cap = getattr(key, "m_cap", None)
    if n_cap is not None and m_cap is not None:
        return f"{n_cap}x{m_cap}"
    return str(key)


class BreakerBoard:
    """One breaker per bucket, lazily created; transitions emitted as the
    ``breaker_state`` gauge through the telemetry hub."""

    def __init__(self, config: BreakerConfig, *,
                 clock: Callable[[], float] = time.monotonic,
                 telemetry=None):
        self.config = config
        self.clock = clock
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._breakers: Dict[object, CircuitBreaker] = {}

    def breaker(self, key) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                label = _bucket_label(key)
                br = CircuitBreaker(
                    self.config, clock=self.clock,
                    on_transition=lambda s, label=label:
                        self._emit(label, s))
                self._breakers[key] = br
                self._emit(label, CLOSED)
            return br

    def _emit(self, label: str, state: str):
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.gauge("breaker_state", STATE_CODES[state],
                      {"bucket": label})

    def allow(self, key) -> bool:
        return self.breaker(key).allow()

    def record_success(self, key, latency_s: Optional[float] = None):
        self.breaker(key).record_success(latency_s)

    def record_failure(self, key):
        self.breaker(key).record_failure()

    def state(self, key) -> str:
        return self.breaker(key).state

    def states(self) -> Dict[str, str]:
        with self._lock:
            items = list(self._breakers.items())
        return {_bucket_label(k): br.state for k, br in items}

    @property
    def n_opens(self) -> int:
        """Total CLOSED/HALF_OPEN -> OPEN transitions across all buckets."""
        with self._lock:
            return sum(br.n_opens for br in self._breakers.values())
