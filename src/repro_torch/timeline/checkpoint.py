"""Durable timeline-service checkpoints (port of
``repro/timeline/checkpoint.py``, in the same file layout and keys).

Persists the temporal-tracking state of a *holder*: any object with a
``.store`` (a :class:`repro_torch.service.store.ResultStore`) and an
optional ``.timelines`` (a :class:`repro_torch.timeline.tracker.
TimelineManager`) — the service front end (ROADMAP A.11) is one.  Every
resident :class:`~repro_torch.service.store.StoreEntry` (graph arrays,
membership, deferred tombstones, version) and the manager's id maps,
matcher state, snapshots, community timelines and lifecycle events go
through the atomic tmp->rename checkpoint store
(:mod:`repro_torch.checkpoint.store`).  The graph arrays are read to the
host once (an entry's graph may lie on the card).

Restore rebuilds each graph on ``store.device``, so warm updates resume
there, and lands the entries through :meth:`ResultStore.restore_entry`
(which deliberately does NOT fire the commit hook: the timeline history
comes from the checkpoint, not from replaying the restore as a fresh
snapshot), then wipes-and-loads the manager with
:meth:`TimelineManager.load_state`.  After a round trip, every
``membership_at``/``timeline``/``lifecycle_events`` answer is identical
to the pre-checkpoint service, and warm updates resume from the exact
entry version that was saved.

Checkpoint at a quiescent point: in-flight windows (pending id-map
stamps) are transient hints and are not captured.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import (
    CheckpointCorrupt, latest_step, load_checkpoint_arrays, save_checkpoint,
)
from repro_torch.core.dynamic import _host_array
from repro_torch.graph.container import Graph

_KIND = "timeline-service"


def _entry_arrays(arrays, graphs_meta, gi, gid, entry, *, evicted=False):
    g = entry.graph
    arrays[f"graph{gi}.src"] = _host_array(g.src, np.int32)
    arrays[f"graph{gi}.dst"] = _host_array(g.dst, np.int32)
    arrays[f"graph{gi}.w"] = _host_array(g.w, np.float32)
    arrays[f"graph{gi}.C"] = _host_array(entry.C, np.int32)
    arrays[f"graph{gi}.deferred"] = np.asarray(entry.deferred, np.int64)
    meta = dict(
        index=gi, graph_id=gid,
        n_nodes=int(g.n_nodes), n_cap=int(g.n_cap), m_cap=int(g.m_cap),
        n_communities=int(entry.n_communities),
        n_disconnected=int(entry.n_disconnected),
        q=float(entry.q), version=int(entry.version),
        algorithm=str(entry.algorithm))
    if evicted:
        meta["evicted"] = True
    graphs_meta.append(meta)


def save_service_checkpoint(holder, ckpt_dir: str, *,
                            step: Optional[int] = None,
                            extra_entries=None) -> int:
    """Write one atomic checkpoint of ``holder``'s store + timelines.

    ``step`` defaults to ``latest_step + 1`` (0 for a fresh dir).
    ``extra_entries`` (gid -> StoreEntry) are evicted-but-warm entries to
    write back alongside the resident ones (the auto-checkpointer's
    eviction buffer); resident entries win on gid collision.  Returns the
    step written.
    """
    if step is None:
        prev = latest_step(ckpt_dir)
        step = 0 if prev is None else prev + 1
    arrays = {}
    graphs_meta = []
    store = holder.store
    gi = 0
    written = set()
    for gid in store.graph_ids():
        entry = store.get(gid)
        if entry is None:  # evicted between listing and get
            continue
        _entry_arrays(arrays, graphs_meta, gi, gid, entry)
        written.add(gid)
        gi += 1
    for gid, entry in (extra_entries or {}).items():
        if gid in written:
            continue
        _entry_arrays(arrays, graphs_meta, gi, gid, entry, evicted=True)
        gi += 1
    tl_meta = {}
    tl = getattr(holder, "timelines", None)
    if tl is not None:
        tl_arrays, tl_meta = tl.state()
        for k, v in tl_arrays.items():
            arrays[f"tl.{k}"] = v
    save_checkpoint(ckpt_dir, step, arrays, extra=dict(
        kind=_KIND, graphs=graphs_meta, timeline=tl_meta))
    return step


def restore_service_checkpoint(holder, ckpt_dir: str, *,
                               step: Optional[int] = None) -> Optional[int]:
    """Restore store entries + timeline state from a checkpoint.

    Decode happens build-then-apply: every graph and array is read (and
    validated) before the first store mutation, so a torn/partial
    checkpoint raises :class:`CheckpointCorrupt` without half-restoring
    the holder — the caller (startup recovery) falls back to the
    previous snapshot.  Entries saved from the eviction write-back
    buffer are applied before resident ones, leaving residents
    most-recently-used if the restore overflows the store's LRU cap.
    Graphs land on ``holder.store.device``.

    Returns the restored step, or ``None`` when no checkpoint exists.
    """
    arrays, extra, step = load_checkpoint_arrays(ckpt_dir, step=step)
    if arrays is None:
        return None
    if extra.get("kind") != _KIND:
        raise ValueError(
            f"not a {_KIND} checkpoint: kind={extra.get('kind')!r}")
    store = holder.store
    dev = store.device

    def on_device(key, dtype):
        return torch.from_numpy(
            np.ascontiguousarray(arrays[key], dtype)).to(dev)

    try:
        items = []
        order = sorted(extra["graphs"],
                       key=lambda m: 0 if m.get("evicted") else 1)
        for gm in order:
            gi, gid = gm["index"], gm["graph_id"]
            g = Graph(
                src=on_device(f"graph{gi}.src", np.int32),
                dst=on_device(f"graph{gi}.dst", np.int32),
                w=on_device(f"graph{gi}.w", np.float32),
                n_nodes=torch.tensor(int(gm["n_nodes"]), dtype=torch.int32,
                                     device=dev),
                n_cap=int(gm["n_cap"]), m_cap=int(gm["m_cap"]))
            items.append((gid, g, arrays[f"graph{gi}.C"].astype(np.int32),
                          gm, arrays[f"graph{gi}.deferred"]))
        tl_arrays = {k[len("tl."):]: v for k, v in arrays.items()
                     if k.startswith("tl.")}
    except KeyError as e:
        raise CheckpointCorrupt(
            f"service checkpoint step {step} is missing key {e}") from e
    for gid, g, C, gm, deferred in items:
        store.restore_entry(
            gid, g, C,
            n_communities=gm["n_communities"],
            n_disconnected=gm["n_disconnected"],
            q=gm["q"], version=gm["version"],
            algorithm=gm.get("algorithm"),
            deferred=deferred)
    tl = getattr(holder, "timelines", None)
    tl_meta = extra.get("timeline") or {}
    if tl is not None and tl_meta:
        tl.load_state(tl_arrays, tl_meta)
    return step
