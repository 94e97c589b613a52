"""Batched GSP-Louvain engine (port of ``repro/service/engine.py``): one
dispatch per same-bucket, same-tier request batch, and the batched warm
updates of the result store.

The reference compiles ``jit(lax.map(vmap(...)))`` per bucket, so each
graph keeps its own loop state inside one call.  The port's pass and sweep
loops are host loops with one sync a sweep (``core/local_move.py``), so a
batch here is a **loop over its graphs** (ROADMAP A.8, option (a)): each
runs :func:`~repro_torch.core.portfolio.run_detection`, the body of
``detect()``, one graph at a time on the engine's device.  The partitions
are the sequential ones by construction (every result equals ``detect()``
of the same graph, bit for bit), and a batch costs the per-graph time
summed.  Results come back as numpy on the host, as the reference's do.

What the reference has and the port keeps in another form:

* *The compile cache.*  No executable stands behind a key.  A key is
  (bucket, tier, scan) for a detection and (bucket, "update", tau,
  max_iters, tier, scan) for a warm update, recorded on its first
  dispatch; ``compile_hit`` means "this key was dispatched before".  The
  first dispatch loads the CUDA kernels and warms the caching allocator,
  which is the port's compile.  :meth:`cache_keys`, :meth:`warm`,
  :meth:`warm_updates`, the ``engine_compile`` counter and
  ``n_compile_hits``/``n_compile_misses`` keep that meaning.
* *No padding.*  The reference pads a batch to a power-of-two tile count
  of ``sub_batch`` graphs with filler graphs; in a loop each filler would
  cost a whole pass loop for nothing, so the port has no ``sub_batch``, no
  tile ladder and no ``batch_fill_factor`` gauge, and :meth:`warm` runs
  one filler graph a new key.
* ``profile_dir`` wraps each dispatch in ``torch.profiler.profile`` with a
  TensorBoard trace handler.

``seg_impl``, ``seg_block_m`` and the Pallas autotuner have no counterpart
(:meth:`seg_block_for` returns 0), and :meth:`detect_sharded` waits for
ROADMAP A.12.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.api import DetectOptions
from repro_torch.core.dynamic import warm_update
from repro_torch.core.portfolio import (QualityContract, contract_for,
                                        run_detection)
from repro_torch.device import resolve_device
from repro_torch.graph.container import Graph
from repro_torch.service.buckets import Bucket, bucket_of, filler
from repro_torch.telemetry.sinks import Telemetry


@dataclasses.dataclass
class DetectResult:
    """Per-graph detection output (host-side)."""

    C: np.ndarray                # int32[nv] dense membership (ghost masked)
    n_communities: int
    n_disconnected: int
    fraction: float              # disconnected fraction (paper metric)
    passes: int
    q: float                     # modularity of the returned partition
    sweeps: int = 0              # local-move sweeps summed over passes
    split_moved: int = 0         # vertices the split pass relabelled
    algorithm: str = "standard"  # portfolio tier that produced this result
    contract: Optional[QualityContract] = None  # the tier's guarantees


@dataclasses.dataclass
class UpdateResult:
    """Per-graph warm-update output (host-side)."""

    C: np.ndarray                # int32[nv] dense membership after the update
    n_communities: int
    n_disconnected: int          # 0 by construction (split pass re-runs)
    fraction: float
    iterations: int              # warm local-move sweeps
    q: float
    n_affected: int = 0          # delta-screening affected vertices
    split_moved: int = 0         # vertices the split pass relabelled


@dataclasses.dataclass
class DispatchInfo:
    """Timing of one engine dispatch, for span attribution.

    Monotonic-clock stamps bracket the phases the front end turns into
    batch-level spans: ``compile`` = (t_call0, t_call1) on a key's first
    dispatch and empty on a hit; ``engine-dispatch`` = the call interval
    minus compile; ``device-sync`` = (t_call1, t_sync), the copy of the
    labels to the host.
    """

    kind: str                    # "detect" | "update"
    bucket: Bucket
    n: int                       # requests in the batch
    compile_hit: bool
    t_start: float               # dispatch entry (host prep begins)
    t_call0: float               # the loop over the batch begins
    t_call1: float               # the loop returned
    t_sync: float                # labels copied to the host
    algorithm: str = "standard"  # portfolio tier the batch ran


# (bucket-padded updated graph — vertex+edge rewrites applied, previous
#  membership int32[nv] in the post-rewrite id space, screening-seed mask
#  bool[nv]) — see ResultStore.prepare_update
UpdateItem = Tuple[Graph, np.ndarray, np.ndarray]


def _on(x, dtype, device) -> torch.Tensor:
    """A tensor or a numpy array as a tensor on ``device`` (a numpy array
    is copied, so a read-only one is fine)."""
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype)
    return torch.tensor(x, dtype=dtype, device=device)


class BatchedLouvainEngine:
    """GSP-Louvain over same-bucket graph batches, one graph at a time."""

    def __init__(self, *, options: Optional[DetectOptions] = None,
                 algorithms: Optional[Tuple[str, ...]] = None,
                 telemetry: Optional[Telemetry] = None,
                 profile_dir: Optional[str] = None,
                 faults=None,
                 device=None):
        """Args:
          options: the :class:`DetectOptions` record: default tier,
            algorithm config, scan strategy and dense crossover.  Dispatch
            keys derive from it.
          algorithms: every tier this engine serves (``warm()`` loads each);
            None = just ``options.algorithm``.
          telemetry: optional hub for the ``engine_compile`` hit/miss
            counter and the algorithm counters.
          profile_dir: trace every dispatch with ``torch.profiler`` into
            this directory (TensorBoard format; expensive, opt-in).
          faults: any object with ``perturb(name, ids=)``, consulted at
            dispatch entry (``engine.detect[.hang]``,
            ``engine.update[.hang]``); ``warm()`` bypasses it.
          device: where every batch runs (``None`` = CUDA; raises when
            CUDA is absent).  Graphs elsewhere are moved there.
        """
        opts = options if options is not None else DetectOptions()
        self.device = resolve_device(device)
        self.options = opts
        if algorithms is None:
            algorithms = (opts.algorithm,)
        for a in algorithms:
            contract_for(a)  # validates tier names
        self.algorithms = tuple(dict.fromkeys(algorithms))  # dedup, ordered
        self.telemetry = telemetry or Telemetry()
        self.profile_dir = profile_dir
        self.faults = faults
        self.n_compile_hits = 0
        self.n_compile_misses = 0
        self.last_detect_info: Optional[DispatchInfo] = None
        self.last_update_info: Optional[DispatchInfo] = None
        self._keys: dict = {}   # dispatched keys, in first-dispatch order

    def _profiled(self):
        if self.profile_dir is None:
            return contextlib.nullcontext()
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts,
                       on_trace_ready=tensorboard_trace_handler(
                           self.profile_dir))

    def _note_compile(self, kind: str, bucket: Bucket, hit: bool,
                      algorithm: str = "standard"):
        if hit:
            self.n_compile_hits += 1
        else:
            self.n_compile_misses += 1
        self.telemetry.counter(
            "engine_compile", 1,
            {"kind": kind, "bucket": f"{bucket.n_cap}x{bucket.m_cap}",
             "tier": algorithm, "result": "hit" if hit else "miss"})

    def _note_dispatch(self, info: DispatchInfo, rows: list):
        """Emit the algorithm counters of a finished batch."""
        tel = self.telemetry
        if not tel.enabled:
            return
        bl = {"bucket": f"{info.bucket.n_cap}x{info.bucket.m_cap}",
              "tier": info.algorithm}

        def total(key):
            return float(sum(r[key] for r in rows))

        if info.kind == "detect":
            tel.counter("louvain_passes", total("passes"), bl)
            tel.counter("local_move_sweeps", total("sweeps"), bl)
        else:
            tel.counter("local_move_sweeps", total("iterations"), bl)
            tel.counter("affected_vertices", total("n_affected"), bl)
        tel.counter("split_moves", total("split_moved"), bl)

    # -- dispatch keys ------------------------------------------------------
    def scan_for(self, bucket: Bucket) -> str:
        return self.options.resolved_scan(bucket.nv, bucket.m_cap,
                                          device_type=self.device.type)

    def seg_block_for(self, bucket: Bucket) -> int:
        """0 for every bucket: the segment-reduce kernel's tile is compiled
        in (``kernels/segsum.py:TILE_ROWS``), so there is no block size to
        tune or key on."""
        return 0

    def _resolve_algorithm(self, algorithm: Optional[str]) -> str:
        if algorithm is None:
            return self.options.algorithm
        contract_for(algorithm)  # validates
        return algorithm

    def _detect_key(self, bucket: Bucket, algorithm: Optional[str] = None):
        return self.options.cache_key(
            bucket, algorithm=self._resolve_algorithm(algorithm),
            scan=self.scan_for(bucket))

    def _update_key(self, bucket: Bucket, tau, max_iters):
        return self.options.cache_key(
            bucket, "update", float(tau), int(max_iters),
            scan=self.scan_for(bucket))

    def _dispatch_key(self, key) -> bool:
        """Record ``key``'s dispatch; whether it was dispatched before."""
        hit = key in self._keys
        self._keys[key] = None
        return hit

    def cache_keys(self):
        """The keys dispatched so far (no executable stands behind one)."""
        return list(self._keys)

    def warm(self, bucket: Bucket, *,
             algorithms: Optional[Sequence[str]] = None) -> int:
        """Dispatch one filler graph for each configured tier
        (``algorithms`` overrides ``self.algorithms``) whose key is new on
        ``bucket``; returns the number of dispatches.  Loads the kernels
        and warms the allocator at the bucket's shape before live
        traffic."""
        n = 0
        pad = filler(bucket, device=self.device)
        # warm-up dispatches bypass any installed fault plan: injected
        # chaos is for live traffic, not startup
        faults, self.faults = self.faults, None
        try:
            for alg in (algorithms if algorithms is not None
                        else self.algorithms):
                if self._detect_key(bucket, alg) not in self._keys:
                    self.detect_batch([pad], algorithm=alg)
                    n += 1
        finally:
            self.faults = faults
        return n

    # -- execution ----------------------------------------------------------
    def _same_bucket(self, graphs) -> Bucket:
        bucket = bucket_of(graphs[0])
        if any(bucket_of(g) != bucket for g in graphs[1:]):
            raise ValueError("a batch requires homogeneous capacities")
        return bucket

    def _one(self, g: Graph, algorithm: str) -> dict:
        """One graph's ``detect()`` on the engine's device: labels (still
        on the device) and host numbers."""
        d = run_detection(g, self.options.replace(algorithm=algorithm))
        return dict(
            C=d.labels,
            n_communities=int(d.n_communities),
            passes=int(d.stats["passes"]),
            sweeps=int(d.stats["li_total"]),
            split_moved=int(d.stats["split_moved"]),
            n_disconnected=d.n_disconnected,
            fraction=d.fraction,
            q=d.modularity,
        )

    def detect_batch(self, graphs: Sequence[Graph], *,
                     algorithm: Optional[str] = None,
                     fault_ids: Optional[Sequence[str]] = None
                     ) -> list[DetectResult]:
        """Detect communities for a homogeneous (same-bucket, same-tier)
        batch, one graph after another on the engine's device.

        ``algorithm`` selects the tier for the whole batch (None = the
        engine default).  ``fault_ids`` (the batch's graph ids) scope any
        installed fault plan's per-graph specs to this dispatch.
        """
        graphs = list(graphs)
        if not graphs:
            return []
        alg = self._resolve_algorithm(algorithm)
        if self.faults is not None:
            self.faults.perturb("engine.detect.hang", ids=fault_ids)
            self.faults.perturb("engine.detect", ids=fault_ids)
        t_start = time.perf_counter()
        bucket = self._same_bucket(graphs)
        hit = self._dispatch_key(self._detect_key(bucket, alg))
        t_call0 = time.perf_counter()
        with self._profiled():
            rows = [self._one(g.to(self.device), alg) for g in graphs]
            t_call1 = time.perf_counter()
            for r in rows:
                r["C"] = r["C"].cpu().numpy()
        t_sync = time.perf_counter()
        info = DispatchInfo(
            kind="detect", bucket=bucket, n=len(graphs), compile_hit=hit,
            t_start=t_start, t_call0=t_call0, t_call1=t_call1,
            t_sync=t_sync, algorithm=alg)
        self.last_detect_info = info
        self._note_compile("detect", bucket, hit, alg)
        self._note_dispatch(info, rows)
        contract = contract_for(alg)
        return [DetectResult(**r, algorithm=alg, contract=contract)
                for r in rows]

    def detect_one(self, g: Graph, *,
                   algorithm: Optional[str] = None) -> DetectResult:
        return self.detect_batch([g], algorithm=algorithm)[0]

    def detect_sharded(self, g: Graph) -> DetectResult:
        """Single-graph detection sharded over a device mesh: not ported
        yet (ROADMAP queue A, item 12)."""
        raise NotImplementedError(
            "detect_sharded waits for the sharded single-graph path "
            "(ROADMAP queue A, item 12)")

    # -- batched warm updates -------------------------------------------------
    def update_batch(self, items: Sequence[UpdateItem], *, tau: float = 1e-3,
                     max_iters: int = 10,
                     fault_ids: Optional[Sequence[str]] = None
                     ) -> list[UpdateResult]:
        """Run a homogeneous (same-bucket) batch of delta-screened warm
        updates, one after another on the engine's device.

        ``items``: (updated graph, previous membership int32[nv], touched
        mask bool[nv]) triples, the graphs already rewritten on the host
        (:func:`repro_torch.core.dynamic.prepare_graph_update`).  Each runs
        :func:`~repro_torch.core.dynamic.warm_update`, the compute of the
        store's immediate path, so the results are the same bits.
        """
        items = list(items)
        if not items:
            return []
        if self.faults is not None:
            self.faults.perturb("engine.update.hang", ids=fault_ids)
            self.faults.perturb("engine.update", ids=fault_ids)
        t_start = time.perf_counter()
        bucket = self._same_bucket([g for g, _, _ in items])
        scan = self.scan_for(bucket)
        hit = self._dispatch_key(self._update_key(bucket, tau, max_iters))
        dev = self.device
        t_call0 = time.perf_counter()
        with self._profiled():
            rows = [warm_update(
                g.to(dev), _on(C, torch.int32, dev), _on(t, torch.bool, dev),
                tau=tau, max_iters=max_iters, scan=scan)
                for g, C, t in items]
            t_call1 = time.perf_counter()
            for r in rows:
                r["C"] = r["C"].cpu().numpy()
        t_sync = time.perf_counter()
        info = DispatchInfo(
            kind="update", bucket=bucket, n=len(items), compile_hit=hit,
            t_start=t_start, t_call0=t_call0, t_call1=t_call1,
            t_sync=t_sync)
        self.last_update_info = info
        self._note_compile("update", bucket, hit)
        self._note_dispatch(info, rows)
        return [UpdateResult(**r) for r in rows]

    def _filler_update(self, bucket: Bucket) -> UpdateItem:
        """Bucket-shaped no-op update: the filler graph at its identity
        partition with nothing touched."""
        nv = bucket.nv
        return (filler(bucket, device=self.device),
                np.arange(nv, dtype=np.int32), np.zeros((nv,), bool))

    def warm_updates(self, bucket: Bucket, *, tau: float = 1e-3,
                     max_iters: int = 10) -> int:
        """Dispatch one filler update if the bucket's update key is new
        (mirror of :meth:`warm` for detections); returns the number of
        dispatches."""
        if self._update_key(bucket, tau, max_iters) in self._keys:
            return 0
        faults, self.faults = self.faults, None  # see warm()
        try:
            self.update_batch([self._filler_update(bucket)], tau=tau,
                              max_iters=max_iters)
        finally:
            self.faults = faults
        return 1
