"""Open-loop load-replay harness: find the service's saturation knee (port
of ``repro/service/replay.py``).

Drives :class:`repro_torch.service.frontend.AsyncCommunityService` with an
**open-loop** arrival process — Poisson arrivals at a configured rate,
submitted on their schedule regardless of how far the service has fallen
behind (closed-loop harnesses hide saturation because a slow server
throttles its own offered load).  The mix is shaped like the serving
story the paper targets:

* **heavy-tailed graph sizes** — Pareto-distributed vertex counts
  clipped to the bucket ladder, so most requests are small with a fat
  tail of large ones (the regime bucketed admission exists for);
* **tenant skew** — Zipf-weighted tenant choice, so DRR fairness and the
  per-tenant queue bound actually engage;
* **update/detect mix** — a configured fraction of arrivals are warm
  edge-delta updates against previously-detected graphs.

:func:`run_replay` runs one rate and returns a report with served /
rejected counts, latency percentiles, and the **per-phase breakdown**
(queue / engine / host shares plus per-phase p50/p99) from the telemetry
layer.  :func:`sweep_rates` runs a rate ladder and locates the
**saturation knee**: the first rate where goodput collapses (served /
offered below ``knee_goodput``) or p99 blows past ``knee_p99_factor``
times the lowest-rate p99.

The graph pool is built on the service's device (``run_replay`` and
``sweep_rates`` take ``device``: ``None`` = CUDA), so arrivals pay no
host-to-device copy on the schedule.  Arrivals run on the real clock.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.graph.generators import sbm_graph
from repro_torch.service.admission import QueueFull, ServiceConfig
from repro_torch.service.frontend import AsyncCommunityService
from repro_torch.telemetry.spans import phase_group


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """One replay run's traffic shape."""

    rate: float = 50.0            # offered arrivals per second (open loop)
    duration_s: float = 2.0       # arrival window (then drain)
    n_tenants: int = 4
    tenant_skew: float = 1.5      # Zipf exponent; 0 = uniform tenants
    update_frac: float = 0.3      # fraction of arrivals that are updates
    pool_size: int = 24           # distinct graphs cycled through
    n_min: int = 12               # smallest graph vertex count
    n_max: int = 48               # largest (clip of the heavy tail)
    size_alpha: float = 1.5       # Pareto shape; smaller = heavier tail
    updates_per_req: int = 3      # edge deltas per update request
    seed: int = 0
    warm: bool = True             # seed the pool's entries (first dispatch
                                  # of each key) before the window

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if not 0 <= self.update_frac <= 1:
            raise ValueError("update_frac must be in [0, 1], got "
                             f"{self.update_frac}")
        if self.n_min < 4 or self.n_max < self.n_min:
            raise ValueError(f"bad size range [{self.n_min}, {self.n_max}]")


def _tenant_weights(cfg: ReplayConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.n_tenants + 1, dtype=np.float64)
    w = ranks ** -cfg.tenant_skew if cfg.tenant_skew > 0 \
        else np.ones_like(ranks)
    return w / w.sum()


def _sizes(cfg: ReplayConfig, rng: np.random.Generator) -> np.ndarray:
    """Heavy-tailed vertex counts: n_min * (1 + Pareto(alpha)), clipped."""
    raw = cfg.n_min * (1.0 + rng.pareto(cfg.size_alpha, cfg.pool_size))
    return np.clip(raw.astype(int), cfg.n_min, cfg.n_max)


def build_graph_pool(cfg: ReplayConfig, *, device=None):
    """Pre-generate the graph pool on ``device`` (``None`` = CUDA;
    generation cost must not pollute the open-loop schedule)."""
    rng = np.random.default_rng(cfg.seed)
    pool = []
    for i, n in enumerate(_sizes(cfg, rng)):
        g, _ = sbm_graph(n_nodes=int(n), n_blocks=max(2, int(n) // 10),
                         p_in=0.5, p_out=0.05, seed=cfg.seed + i,
                         device=device)
        pool.append(g)
    return pool


def _arrivals(cfg: ReplayConfig, rng: np.random.Generator) -> np.ndarray:
    """Cumulative Poisson arrival offsets covering the window."""
    n_expect = int(cfg.rate * cfg.duration_s * 1.5) + 16
    gaps = rng.exponential(1.0 / cfg.rate, n_expect)
    t = np.cumsum(gaps)
    return t[t < cfg.duration_s]


async def replay(svc: AsyncCommunityService, cfg: ReplayConfig) -> dict:
    """Drive one open-loop replay against an already-started service;
    returns the report dict.  Exposed separately from :func:`run_replay`
    so callers that need the service alive afterwards (e.g. to scrape
    its exporter mid-flight) can own the service lifecycle.  The pool is
    built on the service's device."""
    rng = np.random.default_rng(cfg.seed + 1)
    pool = build_graph_pool(cfg, device=svc.frontend.device)
    sizes = [int(g.n_nodes) for g in pool]
    tenants = [f"t{i}" for i in range(cfg.n_tenants)]
    t_w = _tenant_weights(cfg)

    if cfg.warm:
        # seed every pool graph's store entry (updates need one) and
        # dispatch each key once, outside the measured window
        seed_futs = [await svc.submit_detect(f"g{i}", g, tenant="warmup")
                     for i, g in enumerate(pool)]
        await svc.drain()
        await asyncio.gather(*seed_futs)
        svc.metrics.reset()
        if svc.frontend.mem_sink is not None:
            svc.frontend.mem_sink.reset()

    offsets = _arrivals(cfg, rng)
    kinds = rng.random(offsets.shape[0]) < cfg.update_frac
    gids = rng.integers(0, len(pool), offsets.shape[0])
    tids = rng.choice(cfg.n_tenants, offsets.shape[0], p=t_w)

    futs, n_rejected, n_late = [], 0, 0
    t0 = time.perf_counter()
    for k in range(offsets.shape[0]):
        delay = t0 + float(offsets[k]) - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        else:
            n_late += 1          # the loop itself fell behind schedule
        gid, tenant = int(gids[k]), tenants[int(tids[k])]
        g = pool[gid]
        try:
            if kinds[k] and svc.result(f"g{gid}") is not None:
                n = sizes[gid]
                u = rng.integers(0, n, cfg.updates_per_req)
                v = rng.integers(0, n, cfg.updates_per_req)
                keep = u != v
                if not keep.any():
                    continue
                dw = rng.choice([-0.5, 1.0], int(keep.sum())) \
                    .astype(np.float32)
                fut = await svc.submit_update(
                    f"g{gid}", (u[keep], v[keep], dw), tenant=tenant)
            else:
                fut = await svc.submit_detect(f"g{gid}", g, tenant=tenant,
                                              block=False)
            futs.append(fut)
        except QueueFull:
            n_rejected += 1
        except KeyError:
            pass                 # entry evicted between check and submit
    t_offered = time.perf_counter() - t0

    await svc.drain()
    outcomes = await asyncio.gather(*(asyncio.wrap_future(f._fut)
                                      for f in futs),
                                    return_exceptions=True)
    t_total = time.perf_counter() - t0
    n_failed = sum(1 for o in outcomes if isinstance(o, BaseException))

    rep = svc.metrics.report()
    offered = offsets.shape[0]
    served = rep["n_detect"] + rep["n_update"]
    report = dict(
        rate=cfg.rate,
        offered=int(offered),
        served=int(served),
        rejected=int(n_rejected + rep["n_rejected"]),
        failed=int(n_failed),
        late_arrivals=int(n_late),
        goodput=served / offered if offered else 0.0,
        window_s=round(t_offered, 3),
        total_s=round(t_total, 3),
        p50_ms=rep["p50_ms"],
        p99_ms=rep["p99_ms"],
        metrics=rep,
    )
    sink = svc.frontend.mem_sink
    if sink is not None:
        report["phase_breakdown"] = sink.phase_breakdown()
        phases = {}
        for name, h in sorted(sink.phase_durations().items()):
            phases[name] = dict(
                count=int(h.n),
                group=phase_group(name),
                p50_ms=h.percentile(50) * 1e3,
                p99_ms=h.percentile(99) * 1e3,
                total_s=h.sum,
            )
        report["phases"] = phases
    return report


def run_replay(cfg: ReplayConfig,
               svc_config: Optional[ServiceConfig] = None, *,
               device=None) -> dict:
    """Run one open-loop replay against a fresh service on ``device``
    (``None`` = CUDA); returns the report dict (counts, latencies,
    per-phase breakdown)."""

    async def go():
        async with AsyncCommunityService(svc_config, device=device) as svc:
            return await replay(svc, cfg)

    return asyncio.run(go())


def find_knee(reports: Sequence[dict], *, knee_goodput: float = 0.9,
              knee_p99_factor: float = 5.0) -> Optional[float]:
    """First swept rate where goodput collapses or p99 blows up relative
    to the lowest rate; None when every rate held."""
    if not reports:
        return None
    base_p99 = reports[0].get("p99_ms") or float("inf")
    for rep in reports:
        p99 = rep.get("p99_ms")
        blown = (p99 is not None and base_p99 < float("inf")
                 and p99 > knee_p99_factor * base_p99)
        if rep["goodput"] < knee_goodput or blown:
            return float(rep["rate"])
    return None


def sweep_rates(rates: Sequence[float], base: ReplayConfig,
                svc_config: Optional[ServiceConfig] = None, *,
                knee_goodput: float = 0.9, knee_p99_factor: float = 5.0,
                log=None, device=None) -> dict:
    """Replay a rate ladder and locate the saturation knee.

    Each rate runs against a FRESH service (steady-state isolation: a
    backlog left by one rate must not poison the next).  Returns
    ``{"rates": [per-rate reports], "knee_rate": float | None}``.
    """
    reports: List[dict] = []
    for rate in rates:
        cfg = dataclasses.replace(base, rate=float(rate))
        rep = run_replay(cfg, svc_config, device=device)
        reports.append(rep)
        if log is not None:
            p99 = rep["p99_ms"]
            log(f"rate {rate:7.1f}/s  offered {rep['offered']:5d}  "
                f"goodput {rep['goodput']:.2f}  "
                f"p99 {p99 if p99 is None else round(p99, 1)} ms")
    return dict(
        rates=reports,
        knee_rate=find_knee(reports, knee_goodput=knee_goodput,
                            knee_p99_factor=knee_p99_factor),
    )
