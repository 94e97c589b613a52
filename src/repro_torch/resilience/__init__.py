"""Fault-tolerance layer for the serving path (port of
``repro/resilience/``; host code, apart from the degraded tier's LPA):

* :mod:`repro_torch.resilience.faults`   — deterministic, seedable
  :class:`FaultPlan` injected at the service's real seams;
* :mod:`repro_torch.resilience.policy`   — :class:`RetryPolicy` with
  exponential backoff + jitter, watchdog timeouts and wall-clock
  budgets honoring admission deadlines;
* :mod:`repro_torch.resilience.breaker`  — per-bucket circuit breaker
  with half-open probing;
* :mod:`repro_torch.resilience.degrade`  — degraded tier: stale
  last-committed partitions and the LPA fast path, both flagged as NOT
  carrying the zero-internally-disconnected guarantee;
* :mod:`repro_torch.resilience.autockpt` — background automatic
  checkpointing, evicted-but-warm write-back and corrupt-tolerant
  startup recovery;
* :mod:`repro_torch.resilience.manager`  — the front end's single handle
  on all of the above.

The front end that installs them from its config comes with ROADMAP
A.11.
"""
from repro_torch.resilience.autockpt import AutoCheckpointer
from repro_torch.resilience.breaker import (
    BreakerBoard,
    BreakerConfig,
    BreakerOpen,
    CircuitBreaker,
)
from repro_torch.resilience.degrade import DegradedResult, lpa_result, stale_result
from repro_torch.resilience.faults import (
    FaultError,
    FaultPlan,
    FaultSpec,
    FaultySink,
    TransientCapacityError,
)
from repro_torch.resilience.manager import ResilienceManager
from repro_torch.resilience.policy import (
    DeadlineExceeded,
    DispatchTimeout,
    RetryPolicy,
    call_with_timeout,
    run_with_policy,
)

__all__ = [
    "AutoCheckpointer",
    "BreakerBoard",
    "BreakerConfig",
    "BreakerOpen",
    "CircuitBreaker",
    "DeadlineExceeded",
    "DegradedResult",
    "DispatchTimeout",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "FaultySink",
    "ResilienceManager",
    "RetryPolicy",
    "TransientCapacityError",
    "call_with_timeout",
    "lpa_result",
    "run_with_policy",
    "stale_result",
]
