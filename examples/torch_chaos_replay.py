"""Scenario: proving the service keeps its promises while things break,
on the PyTorch port.

An operator doesn't trust a resilience story they can't replay.  This
walks the fault-tolerance layer end to end with a *deterministic* fault
plan — the same seed produces the same failures every run:

1. a seeded ``FaultPlan`` arms the service's real seams: engine raises,
   one watchdog-bounded hang, store-commit failures and a transient
   capacity error, all count-limited so the incident ends;
2. a ``RetryPolicy`` (backoff + watchdog) and a per-bucket circuit
   breaker with degraded fallbacks serve a burst of detect requests
   *through* the incident — retried, split, or shed to an explicitly
   flagged ``DegradedResult`` (``guarantee=False``: degraded answers do
   NOT carry the zero-disconnected-communities guarantee);
3. every full-quality result is verified bit-identical to a fault-free
   reference run — retries never change answers;
4. the automatic checkpointer snapshots in the background; the process
   "crashes" (no flush) right after a torn snapshot, and a fresh
   service recovers from the previous durable step, resuming warm
   updates at the saved version.

Every service and graph lives on ``--device`` (default ``cuda``).

  PYTHONPATH=src python examples/torch_chaos_replay.py [--device cpu]
"""
import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.graph import sbm_graph
from repro_torch.service import (
    BreakerConfig, DegradedResult, FaultPlan, FaultSpec, RetryPolicy,
    ServiceConfig, ServiceFrontend,
)


def graphs(device, n=12, seed=0):
    return [(f"g{i}", sbm_graph(n_nodes=30 + (i % 3) * 8, n_blocks=3,
                                p_in=0.4, p_out=0.04, seed=seed + i,
                                device=device)[0])
            for i in range(n)]


def run(cfg, workload, device):
    fe = ServiceFrontend(cfg, device=device)
    futs = [(gid, fe.submit_detect(gid, g)) for gid, g in workload]
    fe.drain()
    out = {gid: f.result(timeout=120) for gid, f in futs}
    return fe, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    workload = graphs(dev)

    # 1. fault-free reference: what the answers *should* be
    fe, reference = run(ServiceConfig(batch_size=4), workload, dev)
    fe.close()
    print(f"reference: {len(reference)} partitions served fault-free")

    # 2. the same burst through a deterministic incident
    plan = FaultPlan({
        "engine.detect": (FaultSpec(p=0.3, count=3),
                          FaultSpec(p=0.2, count=1, error="capacity")),
        "engine.detect.hang": FaultSpec(hang_s=5.0, count=1),
        "store.commit": FaultSpec(p=1.0, count=1),
    }, seed=7)
    cfg = ServiceConfig(
        batch_size=4, fault_plan=plan,
        retry=RetryPolicy(max_attempts=3, backoff_s=0.01, watchdog_s=2.0),
        breaker=BreakerConfig(failure_threshold=5, cooldown_s=0.5),
        degrade_enabled=True, degrade_modes=("stale", "lpa"))
    fe, results = run(cfg, workload, dev)
    good = degraded = 0
    for gid, r in results.items():
        if isinstance(r, DegradedResult):
            degraded += 1
            print(f"  {gid}: DEGRADED mode={r.mode} "
                  f"guarantee={r.guarantee}")
            continue
        good += 1
        # 3. full-quality answers are bit-identical despite the chaos
        assert np.array_equal(np.asarray(r.C),
                              np.asarray(reference[gid].C)), gid
        assert r.n_disconnected == 0
    print(f"incident: {good} full-quality (bit-identical) + {degraded} "
          f"degraded, {plan.injected_total()} faults injected, "
          f"{fe.resilience.n_retries} retries, "
          f"{fe.resilience.n_batch_splits} batch splits")
    fe.close()

    # 4. crash right after a torn snapshot; recover from the good one
    ckdir = tempfile.mkdtemp(prefix="chaos-example-")
    try:
        plan = FaultPlan(
            {"checkpoint.io": FaultSpec(p=1.0, count=1, skip=1)}, seed=2)
        cfg = ServiceConfig(batch_size=4, fault_plan=plan,
                            autockpt_dir=ckdir, autockpt_period_s=999.0,
                            autockpt_recover=False)
        fe, results = run(cfg, workload[:3], dev)
        fe.autockpt.snapshot(force=True)          # durable (skip=1)
        saved = {gid: int(e.version) for gid, e in results.items()}
        fe.autockpt.snapshot(force=True)          # torn arrays.npz
        print(f"snapshots: 1 durable + {fe.autockpt.n_torn} torn")
        fe.autockpt.close(flush=False)            # simulated crash
        fe.telemetry.close()

        fe = ServiceFrontend(ServiceConfig(batch_size=4,
                                           autockpt_dir=ckdir,
                                           autockpt_period_s=999.0),
                             device=dev)
        print(f"recovery: resumed at step {fe.restored_step} "
              f"({fe.autockpt.n_corrupt_skipped} corrupt step skipped)")
        for gid, v in saved.items():
            entry = fe.store.get(gid)
            assert entry is not None and entry.version == v, gid
        print(f"restored {len(saved)} entries at their saved versions")
        fe.close()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


if __name__ == "__main__":
    main()
