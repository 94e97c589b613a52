"""GSP-Louvain multi-pass loop (paper Algorithm 3; port of
``repro/core/louvain.py``).

Each pass runs local-moving -> splitting (SP variants) -> convergence
checks -> renumber -> dendrogram lookup -> aggregation -> threshold
scaling, in the paper's order: the split happens *before* the ``l_i <= 1``
break, so the returned partition is split-clean for every ``sp-*`` mode.
The reference's ``lax.while_loop`` over passes is a Python loop here; the
pass that sets ``done`` still applies its local-move and split to the
top-level membership and only skips the aggregation, as the reference's
frozen graph does.  Each pass works on the live edges only: the ghost
padding that keeps the reference's shapes static is stripped after every
aggregation (``graph.container.strip_padding``).

Split policies ported so far: 'none' and 'sp-lp' / 'sp-lpp' / 'sp-pj'
(GSP-Louvain, the default).  'sl-*' and 'refine' wait for ROADMAP item
A.5.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import _segments as seg
from repro_torch.core.aggregate import aggregate
from repro_torch.core.local_move import local_move
from repro_torch.core.split import split_labels
from repro_torch.device import resolve_device
from repro_torch.graph.container import Graph, strip_padding
from repro_torch.kernels import ops

SPLITS = ("none", "sp-lp", "sp-lpp", "sp-pj")


@dataclasses.dataclass(frozen=True)
class LouvainConfig:
    max_passes: int = 10
    max_iters: int = 20
    tolerance: float = 1e-2
    tolerance_drop: float = 10.0
    aggregation_tolerance: float = 0.8
    split: str = "sp-pj"          # none | sp-{lp,lpp,pj}; sl-* and refine: A.5
    sync: str = "handshake"       # handshake | parity | all
    prune: bool = True
    split_max_iters: int = 0      # 0 = graph-size bound


def _check_split(split: str) -> None:
    if split == "refine" or split.startswith("sl-"):
        raise NotImplementedError(
            f"split={split!r} is not ported yet (ROADMAP queue A, item 5)")
    if split not in SPLITS:
        raise ValueError(f"split must be one of {SPLITS}, got {split!r}")


class _Clock:
    """Adds wall seconds per phase into ``phase_seconds`` (when given),
    synchronizing the device at each phase edge so the time is the
    phase's own."""

    def __init__(self, phase_seconds, device):
        self.out = phase_seconds
        self.sync = (torch.cuda.synchronize if device.type == "cuda"
                     else (lambda: None))

    def run(self, phase, fn, *args, **kw):
        if self.out is None:
            return fn(*args, **kw)
        self.sync()
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        self.sync()
        self.out[phase] = self.out.get(phase, 0.0) + time.perf_counter() - t0
        return res


def louvain_impl(g: Graph, cfg: LouvainConfig = LouvainConfig(), *,
                 phase_seconds: dict | None = None):
    """Run GSP-Louvain on ``g`` where it lies.

    Returns ``(C int32[nv] dense top-level membership, stats)`` with stats
    passes / li_last / li_total / split_moved / n_communities as Python
    ints.  Ghost and padding vertices map to the trailing community ids.

    ``phase_seconds``: a dict to which the wall seconds of each phase
    (local_move, split, aggregate, other) are added, with the device
    synchronized at every phase edge; ``None`` adds no synchronization.
    """
    _check_split(cfg.split)
    clock = _Clock(phase_seconds, g.device)
    nv = g.nv
    dev = g.device
    two_m = g.total_weight_2m()
    mode = cfg.split.split("-")[1] if cfg.split != "none" else None
    ids = torch.arange(nv, dtype=torch.int32, device=dev)

    # the reference's fixed capacities exist for jit: work on live edges
    esrc, edst, ew = strip_padding(g.src, g.dst, g.w, g.ghost)
    Ctop = ids
    n_cur = int(g.n_nodes)
    tau = np.float32(cfg.tolerance)
    passes = li = li_total = split_moved = 0
    done = False
    while not done and passes < cfg.max_passes:
        node_valid = ids < n_cur
        # aggregation emits run-sorted super-edges, so esrc stays sorted
        K = clock.run("other", ops.segreduce_sorted, ew, esrc, nv, op="sum")
        C, _, li = clock.run(
            "local_move", local_move, esrc, edst, ew, ids, K, K, two_m,
            tau=tau, max_iters=cfg.max_iters, sync=cfg.sync, prune=cfg.prune)
        if mode is not None:
            labels, _ = clock.run("split", split_labels, esrc, edst, ew, C,
                                  mode=mode, max_iters=cfg.split_max_iters)
        else:
            labels = C
        C_dense, n_comms = clock.run("other", seg.renumber, labels,
                                     node_valid, nv)
        # split-pass trigger count: vertices the split moved (telemetry)
        split_moved += int(torch.sum((labels != C) & node_valid))
        Ctop = C_dense[Ctop]
        n_comms = int(n_comms)

        converged = li <= 1
        low_shrink = np.float32(n_comms) > (
            np.float32(cfg.aggregation_tolerance) * np.float32(n_cur))
        done = converged or low_shrink
        if not done:   # the reference freezes the graph on the last pass
            esrc, edst, ew = clock.run(
                "aggregate", lambda: strip_padding(
                    *aggregate(esrc, edst, ew, C_dense), g.ghost))
            n_cur = n_comms
        tau = tau / np.float32(cfg.tolerance_drop)
        passes += 1
        li_total += li

    n_final = int(seg.count_communities(Ctop, g.node_mask(), nv))
    stats = dict(passes=passes, li_last=li, li_total=li_total,
                 split_moved=split_moved, n_communities=n_final)
    return Ctop, stats


def louvain(g: Graph, cfg: LouvainConfig | None = None, *, device=None):
    """GSP-Louvain, the public entry point: ``(C, stats)``.

    Runs on ``device`` (``None`` = CUDA; raises when CUDA is absent),
    moving the graph there first if needed.
    """
    g = g.to(resolve_device(device))
    return louvain_impl(g, cfg if cfg is not None else LouvainConfig())
