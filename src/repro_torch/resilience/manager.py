"""ResilienceManager — the front end's single handle on the fault plan,
retry policy, breaker board and degraded tier (port of
``repro/resilience/manager.py``).

It reads seven fields off its ``config`` argument, any object that has
them: ``fault_plan``, ``retry``, ``breaker``, ``degrade_enabled``,
``degrade_modes``, ``detect`` (the service's
:class:`~repro_torch.core.api.DetectOptions`) and ``degrade_tenants``.
The front end passes its
:class:`~repro_torch.service.admission.ServiceConfig`.
Every method has a zero-overhead fast path when the corresponding knob is
off, so a service configured without resilience runs the exact
pre-existing code path.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional

from repro_torch.resilience.breaker import BreakerBoard
from repro_torch.resilience.degrade import (
    DegradedResult, lpa_result, stale_result,
)
from repro_torch.resilience.faults import FaultPlan
from repro_torch.resilience.policy import RetryPolicy, run_with_policy


class ResilienceManager:
    def __init__(self, config, *, telemetry=None, metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        self.plan: Optional[FaultPlan] = config.fault_plan
        self.retry: Optional[RetryPolicy] = config.retry
        self.telemetry = telemetry
        self.metrics = metrics
        self.clock = clock
        self.board = (BreakerBoard(config.breaker, clock=clock,
                                   telemetry=telemetry)
                      if config.breaker is not None else None)
        self.degrade_enabled = bool(config.degrade_enabled)
        self.degrade_modes = tuple(config.degrade_modes)
        # the service's DetectOptions: the degraded lpa mode runs the
        # portfolio's fast tier under the SAME backend knobs as a
        # requested fast-tier detect (one code path, bit-identical)
        self.detect_options = config.detect
        self._degrade_tenants = (None if config.degrade_tenants is None
                                 else frozenset(config.degrade_tenants))
        seed = getattr(self.plan, "seed", 0) if self.plan is not None else 0
        self._rng = random.Random(f"resilience-jitter:{seed}")
        self.n_retries = 0
        self.n_batch_splits = 0
        self.n_degraded = 0
        if self.plan is not None:
            self.plan.on_inject = self._note_inject

    # -- wiring ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return (self.plan is not None or self.retry is not None
                or self.board is not None or self.degrade_enabled)

    @property
    def _dispatch_active(self) -> bool:
        return (self.plan is not None or self.retry is not None
                or self.board is not None)

    def _counter(self, name, labels=None):
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.counter(name, 1, labels)

    def _note_inject(self, seam: str):
        self._counter("faults_injected", {"seam": seam})

    def _note_retry(self, kind: str, exc: BaseException):
        self.n_retries += 1
        if self.metrics is not None:
            self.metrics.n_retries += 1
        self._counter("resilience_retries",
                      {"kind": kind, "error": type(exc).__name__})

    def note_split(self):
        self.n_batch_splits += 1
        if self.metrics is not None:
            self.metrics.n_batch_splits += 1
        self._counter("resilience_batch_splits")

    # -- breaker --------------------------------------------------------
    def allow(self, bucket) -> bool:
        return True if self.board is None else self.board.allow(bucket)

    def breaker_state(self, bucket) -> Optional[str]:
        return None if self.board is None else self.board.state(bucket)

    # -- dispatch / commit seams ----------------------------------------
    def dispatch(self, kind: str, bucket, fn: Callable, *,
                 deadline: Optional[float] = None):
        """Engine dispatch under retry/watchdog, with the bucket breaker
        recording the outcome.  ``deadline`` is an absolute clock time
        bounding retries (min admission deadline of the batch)."""
        if not self._dispatch_active:
            return fn()
        t0 = self.clock()
        try:
            out = run_with_policy(
                fn, self.retry, clock=self.clock, deadline=deadline,
                rng=self._rng,
                on_retry=lambda a, e: self._note_retry(kind, e))
        except Exception:
            if self.board is not None:
                self.board.record_failure(bucket)
            raise
        if self.board is not None:
            self.board.record_success(bucket, self.clock() - t0)
        return out

    def commit(self, fn: Callable):
        """A store write under the ``store.commit`` fault seam and the
        retry policy (each attempt re-consults the seam, so count-limited
        faults succeed on retry)."""
        if self.plan is None and self.retry is None:
            return fn()

        def attempt():
            if self.plan is not None:
                self.plan.perturb("store.commit")
            return fn()

        return run_with_policy(
            attempt, self.retry, clock=self.clock, rng=self._rng,
            on_retry=lambda a, e: self._note_retry("commit", e))

    # -- degraded tier --------------------------------------------------
    def can_degrade(self, tenant: str) -> bool:
        if not self.degrade_enabled:
            return False
        return (self._degrade_tenants is None
                or tenant in self._degrade_tenants)

    def degraded(self, graph_id: str, graph, store, *, now: float,
                 tenant: str = "default") -> Optional[DegradedResult]:
        """Produce a degraded result for an opted-in tenant, trying the
        configured modes in order; ``None`` when nothing applies.  The lpa
        mode runs on ``store.device``."""
        if not self.can_degrade(tenant):
            return None
        for mode in self.degrade_modes:
            if mode == "stale":
                entry = store.get(graph_id)
                if entry is None:
                    continue
                dr = stale_result(graph_id, entry, now=now)
            else:
                try:
                    dr = lpa_result(graph_id, graph,
                                    options=self.detect_options,
                                    device=store.device)
                except Exception:       # fast path must not fail the shed
                    continue
            self.n_degraded += 1
            if self.metrics is not None:
                self.metrics.n_degraded += 1
            self._counter("degraded_served", {"mode": mode})
            return dr
        return None
