"""Retry / timeout / backoff policies for dispatch and commit seams (port
of ``repro/resilience/policy.py``; host code).

A :class:`RetryPolicy` is installed per service (by the front end,
ROADMAP A.11) and wrapped around the two places the front end does real
work: engine dispatch (fresh detects and warm updates) and
store commits.  The policy bounds each attempt with a watchdog timeout
(a hung dispatch raises :class:`DispatchTimeout` instead of blocking the
compute thread forever), sleeps an exponential backoff with jitter
between attempts, and honors a wall-clock budget — including the
admission deadlines of the requests being served, so the service never
retries work whose futures nobody can use anymore.

:class:`DeadlineExceeded` is also the typed error a request fails with
when its admission deadline passes before dispatch (fail expired
requests fast instead of computing for an abandoned future).

On the card the watchdog abandons a hung *thread*, not its work: CUDA
kernels that thread already queued keep running, and the re-issued
attempt queues behind them on the same stream.  The tests and
``chip_smoke.py`` drive the watchdog only through the
``engine.detect.hang`` seam, which sleeps on the host.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional, Tuple


class DeadlineExceeded(Exception):
    """The request's wall-clock deadline passed before (or during) the
    work that would have resolved its future."""


class DispatchTimeout(Exception):
    """A dispatch attempt exceeded the watchdog timeout.  Retryable: the
    hung attempt is abandoned on its daemon thread and the call is
    re-issued."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How a failing dispatch/commit is retried.

    max_attempts:  total attempts (1 = no retry).
    backoff_s:     base sleep before attempt N+1; grows by
                   ``backoff_factor ** (N-1)`` with up to ``jitter``
                   relative random spread.
    watchdog_s:    per-attempt timeout; ``None`` runs attempts inline
                   with no watchdog thread (zero overhead).
    budget_s:      total wall-clock budget across all attempts; the
                   per-call ``deadline`` (min admission deadline of the
                   batch) tightens it further.
    no_retry:      exception types that fail immediately (programming
                   errors and deadline misses are not transient).
    """

    max_attempts: int = 3
    backoff_s: float = 0.01
    backoff_factor: float = 2.0
    jitter: float = 0.1
    watchdog_s: Optional[float] = None
    budget_s: Optional[float] = None
    no_retry: Tuple[type, ...] = (
        ValueError, TypeError, KeyError, DeadlineExceeded)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.watchdog_s is not None and self.watchdog_s <= 0:
            raise ValueError(
                f"watchdog_s must be > 0, got {self.watchdog_s}")
        if self.budget_s is not None and self.budget_s <= 0:
            raise ValueError(f"budget_s must be > 0, got {self.budget_s}")

    def retryable(self, exc: BaseException) -> bool:
        # TransientCapacityError is a CapacityError (a ValueError) but is
        # explicitly transient — it must survive the no_retry screen
        from repro_torch.resilience.faults import TransientCapacityError
        if isinstance(exc, TransientCapacityError):
            return True
        return not isinstance(exc, tuple(self.no_retry))

    def delay_s(self, attempt: int, u: float = 0.0) -> float:
        """Backoff before the attempt after ``attempt`` (1-based); ``u``
        in [0, 1) spreads the jitter."""
        return (self.backoff_s * (self.backoff_factor ** (attempt - 1))
                * (1.0 + self.jitter * u))


def call_with_timeout(fn: Callable, timeout_s: float):
    """Run ``fn()`` on a daemon thread, waiting at most ``timeout_s``.

    On expiry raises :class:`DispatchTimeout`; the hung attempt keeps
    running on its abandoned thread (its result is discarded) so a stuck
    device call cannot wedge the service's compute thread."""
    box = []
    done = threading.Event()

    def run():
        try:
            box.append((True, fn()))
        except BaseException as e:      # noqa: BLE001 — relayed below
            box.append((False, e))
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True, name="resilience-watchdog")
    t.start()
    if not done.wait(timeout_s):
        raise DispatchTimeout(
            f"dispatch exceeded watchdog timeout {timeout_s:.3f}s")
    ok, val = box[0]
    if ok:
        return val
    raise val


def run_with_policy(fn: Callable, policy: Optional[RetryPolicy], *,
                    clock: Callable[[], float] = time.monotonic,
                    deadline: Optional[float] = None,
                    rng=None, on_retry=None,
                    sleep: Callable[[float], None] = time.sleep):
    """Run ``fn()`` under ``policy``.

    ``deadline`` is an absolute time on ``clock``; together with
    ``policy.budget_s`` it caps per-attempt watchdog timeouts and
    backoff sleeps, and aborts retries that could not finish in time.
    ``on_retry(attempt, exc)`` fires before each backoff sleep.  With
    ``policy=None`` the call runs once, inline.
    """
    if policy is None:
        return fn()
    t0 = clock()
    budget_end = None
    if policy.budget_s is not None:
        budget_end = t0 + policy.budget_s
    if deadline is not None:
        budget_end = deadline if budget_end is None else min(
            budget_end, deadline)
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        timeout = policy.watchdog_s
        if budget_end is not None:
            remaining = budget_end - clock()
            if remaining <= 0.0:
                if last is not None:
                    raise last
                raise DeadlineExceeded(
                    "wall-clock budget exhausted before dispatch")
            timeout = remaining if timeout is None else min(
                timeout, remaining)
        try:
            if timeout is not None:
                return call_with_timeout(fn, timeout)
            return fn()
        except Exception as e:          # noqa: BLE001 — policy filters
            last = e
            if attempt >= policy.max_attempts or not policy.retryable(e):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            d = policy.delay_s(
                attempt, u=(rng.random() if rng is not None else 0.0))
            if budget_end is not None:
                d = min(d, max(budget_end - clock(), 0.0))
            if d > 0:
                sleep(d)
    raise last                          # pragma: no cover — loop always exits
