"""Batched GSP-Louvain engine (port of ``repro/service/engine.py``): one
dispatch per same-bucket, same-tier request batch, and the batched warm
updates of the result store.

The reference compiles ``jit(lax.map(vmap(...)))`` per bucket: a batch is
laid out as ``[n_tiles, sub_batch]`` stacked graphs, and the ``sub_batch``
graphs of a tile run each pass and each sweep in lockstep, every decision
kept per graph.  The port's pass and sweep loops are host loops with one
sync a sweep (``core/local_move.py``), and a batch takes one of two
routes (``DispatchInfo.route``):

* ``"tile"``, the reference's lane-parallel batch, at ``sub_batch > 1``
  for every tier and the warm updates at every bucket, on either scan
  (:meth:`BatchedLouvainEngine.route_for`,
  :meth:`BatchedLouvainEngine.update_route_for`).  The batch is cut into
  tiles of at most ``sub_batch`` graphs, and each tile runs on the live
  edges of its graphs as one union (``graph/container.py:GraphUnion``):
  a detection tile runs
  :func:`~repro_torch.core.portfolio.run_detection_tile`, one
  pass loop for all (``core/louvain.py:louvain_tile``; max-quality runs
  two, refinement on the union in the split slot, then picks per graph)
  or one LPA round loop (``core/lpa.py:lpa_run_tile``); an update tile
  runs :func:`~repro_torch.core.dynamic.warm_update_tile`, one screening
  and one warm sweep loop for all.  So a sweep or a round is one set of
  launches and one host read for the tile.  Each graph keeps its own
  pass count, place on the ``tau`` ladder, awake set, sweep or round
  loop state and convergence: a graph that converges stops moving and
  keeps its state, and a graph whose pass loop is done leaves the union
  at the next aggregation.  On the dense scan a pass builds one
  ``[b, nv, nv]`` adjacency; the sortscan builds none (its sweeps sort
  the union's ``O(b * m_cap)`` edges, and its splits are the coo ones on
  the union), so a tile of wide buckets holds only its edges and
  ``O(b * nv)`` state.  A tile needs no fixed width, so the last one
  holds what is left and no filler graph runs.  A tile of one graph is
  ``run_detection`` (or ``warm_update``) of that graph.
* ``"loop"`` for every batch at ``sub_batch = 1``: each graph runs
  :func:`~repro_torch.core.portfolio.run_detection` (or ``warm_update``),
  the body of ``detect()``, one after another (ROADMAP A.8 option
  (a)).

Either way every result equals ``detect()`` (an update's,
``warm_update``) of the same graph, bit for bit.  Results come back as
numpy on the host, as the reference's do.
``sub_batch`` (``None``: 1 on the CPU, 8 on CUDA, the reference's rule)
sets the tile width; ``DispatchInfo.capacity`` is tiles x ``sub_batch``,
and ``fill`` (the ``batch_fill_factor`` gauge) the batch's share of it.

What the reference has and the port keeps in another form:

* *The compile cache.*  No executable stands behind a key.  A key is
  (bucket, sub_batch, tier, scan) for a detection and (bucket, sub_batch,
  "update", tau, max_iters, tier, scan) for a warm update, the
  reference's less its tile count, ``seg_impl`` and ``block_m``, recorded
  on its first dispatch; ``compile_hit`` means "this key was dispatched
  before".  The first dispatch loads the CUDA kernels and warms the
  caching allocator, which is the port's compile.  :meth:`cache_keys`,
  :meth:`warm` (one full tile of filler graphs a new key),
  :meth:`warm_updates`, the ``engine_compile`` counter and
  ``n_compile_hits``/``n_compile_misses`` keep that meaning.
* *No padding.*  The reference pads a batch to a power-of-two tile count
  with filler graphs; the port's tiles are as wide as their graphs, so
  there is no tile ladder.
* ``profile_dir`` wraps each dispatch in ``torch.profiler.profile`` with a
  TensorBoard trace handler.

``seg_impl``, ``seg_block_m`` and the Pallas autotuner have no counterpart
(:meth:`seg_block_for` returns 0).  :meth:`detect_sharded` runs one graph
over ``options.mesh`` (``core/distributed.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.api import DetectOptions
from repro_torch.core.dynamic import warm_update, warm_update_tile
from repro_torch.core.portfolio import (QualityContract, contract_for,
                                        run_detection, run_detection_tile)
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
    n_disconnected: int          # 0 by construction: the split pass
                                 # (split_labels, 'pj') relabels each
                                 # community by its connected pieces
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
    labels to the host.  ``fill`` is the batch's share of its tiles'
    width (the bucket fill-factor gauge); ``route`` is "tile" where tiles
    of graphs ran in lockstep, "loop" where the graphs ran one by one,
    for a detect batch (:meth:`BatchedLouvainEngine.route_for`) and an
    update batch (:meth:`BatchedLouvainEngine.update_route_for`) alike.
    """

    kind: str                    # "detect" | "update"
    bucket: Bucket
    n: int                       # requests in the batch
    capacity: int                # n_tiles * sub_batch
    compile_hit: bool
    t_start: float               # dispatch entry (host prep begins)
    t_call0: float               # the batch's tiles or loop begin
    t_call1: float               # they returned
    t_sync: float                # labels copied to the host
    algorithm: str = "standard"  # portfolio tier the batch ran
    route: str = "loop"          # "tile" | "loop"

    @property
    def fill(self) -> float:
        return self.n / self.capacity if self.capacity else 0.0


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
    """GSP-Louvain over same-bucket graph batches, in tiles of lockstep
    graphs or one graph at a time (see the module docstring)."""

    def __init__(self, *, options: Optional[DetectOptions] = None,
                 algorithms: Optional[Tuple[str, ...]] = None,
                 sub_batch: Optional[int] = None,
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
          sub_batch: the tile width, the graphs a tile runs in lockstep;
            None = auto, 1 on the CPU (where a tile of dense ``[b, nv,
            nv]`` state buys nothing back) and 8 on CUDA, as the
            reference's rule.
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
        if sub_batch is None:
            sub_batch = 1 if self.device.type == "cpu" else 8
        self.sub_batch = max(1, int(sub_batch))
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
        """Emit the algorithm counters and the fill gauge of a finished
        batch."""
        tel = self.telemetry
        if not tel.enabled:
            return
        bl = {"bucket": f"{info.bucket.n_cap}x{info.bucket.m_cap}",
              "tier": info.algorithm}
        tel.gauge("batch_fill_factor", info.fill, bl)

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
            bucket, self.sub_batch,
            algorithm=self._resolve_algorithm(algorithm),
            scan=self.scan_for(bucket))

    def _update_key(self, bucket: Bucket, tau, max_iters):
        return self.options.cache_key(
            bucket, self.sub_batch, "update", float(tau), int(max_iters),
            scan=self.scan_for(bucket))

    def route_for(self, bucket: Bucket,
                  algorithm: Optional[str] = None) -> str:
        """"tile" where a detect batch of ``bucket`` and this tier runs in
        lockstep tiles (:func:`~repro_torch.core.portfolio.
        run_detection_tile`): at ``sub_batch > 1``, for every tier and
        bucket on either scan, since a batch never runs sharded (as in
        :meth:`_rows`).  Else "loop".  Raises on an unknown tier."""
        self._resolve_algorithm(algorithm)
        return "tile" if self.sub_batch > 1 else "loop"

    def update_route_for(self, bucket: Bucket) -> str:
        """"tile" where an update batch of ``bucket`` runs in lockstep
        tiles (:func:`~repro_torch.core.dynamic.warm_update_tile`): at
        ``sub_batch > 1``, on either scan.  Else "loop".  A batch never
        runs sharded, so ``options.mesh`` plays no part, as in
        :meth:`_rows`, and every bucket takes the same route."""
        return "tile" if self.sub_batch > 1 else "loop"

    def _capacity(self, n: int) -> int:
        return -(-n // self.sub_batch) * self.sub_batch

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
        """Dispatch one full tile of filler graphs (``sub_batch`` of them)
        for each configured tier (``algorithms`` overrides
        ``self.algorithms``) whose key is new on ``bucket``; returns the
        number of dispatches.  Loads the kernels and warms the allocator
        at the bucket's shape and tile width before live traffic."""
        n = 0
        pad = filler(bucket, device=self.device)
        # warm-up dispatches bypass any installed fault plan: injected
        # chaos is for live traffic, not startup
        faults, self.faults = self.faults, None
        try:
            for alg in (algorithms if algorithms is not None
                        else self.algorithms):
                if self._detect_key(bucket, alg) not in self._keys:
                    self.detect_batch([pad] * self.sub_batch, algorithm=alg)
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

    def _row(self, d) -> dict:
        """A ``Detection``'s result row: labels (still on the device) and
        host numbers."""
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

    def _rows(self, graphs: list, algorithm: str, route: str) -> list:
        """The batch's result rows on the engine's device: tiles of
        ``sub_batch`` graphs on the tile route, of one graph (its
        ``run_detection``) on the loop route.  A batch never runs sharded
        (the mesh is :meth:`detect_sharded`'s), as in the reference."""
        opts = self.options.replace(algorithm=algorithm, mesh=None)
        graphs = [g.to(self.device) for g in graphs]
        width = self.sub_batch if route == "tile" else 1
        rows = []
        for i in range(0, len(graphs), width):
            tile = graphs[i:i + width]
            dets = (run_detection_tile(tile, opts) if len(tile) > 1
                    else [run_detection(tile[0], opts)])
            rows.extend(self._row(d) for d in dets)
        return rows

    def detect_batch(self, graphs: Sequence[Graph], *,
                     algorithm: Optional[str] = None,
                     fault_ids: Optional[Sequence[str]] = None
                     ) -> list[DetectResult]:
        """Detect communities for a homogeneous (same-bucket, same-tier)
        batch on the engine's device: in tiles of at most ``sub_batch``
        graphs in lockstep where :meth:`route_for` says "tile", else one
        graph after another.

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
        route = self.route_for(bucket, alg)
        t_call0 = time.perf_counter()
        with self._profiled():
            rows = self._rows(graphs, alg, route)
            t_call1 = time.perf_counter()
            labels = torch.stack([r["C"] for r in rows]).cpu().numpy()
            for r, C in zip(rows, labels):
                r["C"] = C
        t_sync = time.perf_counter()
        info = DispatchInfo(
            kind="detect", bucket=bucket, n=len(graphs),
            capacity=self._capacity(len(graphs)), compile_hit=hit,
            t_start=t_start, t_call0=t_call0, t_call1=t_call1,
            t_sync=t_sync, algorithm=alg, route=route)
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
        """Single-graph detection sharded over ``options.mesh``: the
        one-giant-graph mode for requests that dwarf the bucket ladder.

        Runs ``run_detection`` with the mesh: the pass loops on the mesh's
        ranks (``core/distributed.py:louvain_sharded``, the single-device
        partition bit for bit; max-quality picks the better of its two
        candidates, as the reference's engine does), the detector and
        modularity on the engine's device.  The sharded telemetry (halo
        bytes, ghost counts, per-shard sweeps) goes to the engine's hub.
        """
        if self.options.mesh is None:
            raise ValueError(
                "detect_sharded requires a mesh: construct the engine with "
                "options=DetectOptions(mesh=...)")
        alg = self.options.algorithm
        if alg == "fast":
            raise ValueError(
                "algorithm='fast' (LPA) is single-device only — "
                "detect_sharded serves standard/max-quality")
        t_start = time.perf_counter()
        d = run_detection(g.to(self.device), self.options,
                          telemetry=self.telemetry)
        t_call1 = time.perf_counter()
        C = d.labels.cpu().numpy()
        t_sync = time.perf_counter()
        self.last_detect_info = DispatchInfo(
            kind="detect", bucket=bucket_of(g), n=1, capacity=1,
            compile_hit=True,
            t_start=t_start, t_call0=t_start, t_call1=t_call1,
            t_sync=t_sync, algorithm=alg)
        return DetectResult(
            C=C,
            n_communities=int(d.n_communities),
            n_disconnected=d.n_disconnected,
            fraction=d.fraction,
            passes=int(d.stats["passes"]),
            q=d.modularity,
            sweeps=int(d.stats["li_total"]),
            split_moved=int(d.stats["split_moved"]),
            algorithm=alg,
            contract=contract_for(alg),
        )

    # -- batched warm updates -------------------------------------------------
    def update_batch(self, items: Sequence[UpdateItem], *, tau: float = 1e-3,
                     max_iters: int = 10,
                     fault_ids: Optional[Sequence[str]] = None
                     ) -> list[UpdateResult]:
        """Run a homogeneous (same-bucket) batch of delta-screened warm
        updates on the engine's device: in tiles of at most ``sub_batch``
        graphs in lockstep where :meth:`update_route_for` says "tile"
        (:func:`~repro_torch.core.dynamic.warm_update_tile`; a tile of one
        runs ``warm_update``), else one graph after another.

        ``items``: (updated graph, previous membership int32[nv], touched
        mask bool[nv]) triples, the graphs already rewritten on the host
        (:func:`repro_torch.core.dynamic.prepare_graph_update`), so
        ``n_nodes`` may differ within a tile.  Each result is the bits of
        :func:`~repro_torch.core.dynamic.warm_update` on its graph alone,
        the compute of the store's immediate path.
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
        route = self.update_route_for(bucket)
        dev = self.device
        width = self.sub_batch if route == "tile" else 1
        t_call0 = time.perf_counter()
        with self._profiled():
            items = [(g.to(dev), _on(C, torch.int32, dev),
                      _on(t, torch.bool, dev)) for g, C, t in items]
            rows = []
            for i in range(0, len(items), width):
                tile = items[i:i + width]
                if len(tile) > 1:
                    rows.extend(warm_update_tile(
                        [g for g, _, _ in tile],
                        torch.stack([C for _, C, _ in tile]),
                        torch.stack([t for _, _, t in tile]),
                        tau=tau, max_iters=max_iters, scan=scan))
                else:
                    rows.append(warm_update(*tile[0], tau=tau,
                                            max_iters=max_iters, scan=scan))
            t_call1 = time.perf_counter()
            labels = torch.stack([r["C"] for r in rows]).cpu().numpy()
            for r, C in zip(rows, labels):
                r["C"] = C
        t_sync = time.perf_counter()
        info = DispatchInfo(
            kind="update", bucket=bucket, n=len(items),
            capacity=self._capacity(len(items)), compile_hit=hit,
            t_start=t_start, t_call0=t_call0, t_call1=t_call1,
            t_sync=t_sync, route=route)
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
        """Dispatch one filler update batch if the bucket's update key is
        new (mirror of :meth:`warm` for detections): one full tile of
        ``sub_batch`` filler updates on the tile route, one filler update
        on the loop route.  Returns the number of dispatches."""
        if self._update_key(bucket, tau, max_iters) in self._keys:
            return 0
        n = self.sub_batch if self.update_route_for(bucket) == "tile" else 1
        faults, self.faults = self.faults, None  # see warm()
        try:
            self.update_batch([self._filler_update(bucket)] * n, tau=tau,
                              max_iters=max_iters)
        finally:
            self.faults = faults
        return 1
