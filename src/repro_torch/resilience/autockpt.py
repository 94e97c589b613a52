"""Crash-safe automatic checkpointing for the serving front end (port of
``repro/resilience/autockpt.py``).

An :class:`AutoCheckpointer` snapshots a *holder*: any object with a
``.store`` and an optional ``.timelines``, as
:func:`repro_torch.timeline.checkpoint.save_service_checkpoint` takes
(the front end, which wires it from its config, comes with ROADMAP
A.11).  It gives periodic/automatic checkpointing and write-back of
evicted-but-warm partitions:

* a background daemon thread snapshots the service — warm store entries
  (+ timelines when enabled) — through the existing atomic
  tmp-dir-then-rename npz path (:func:`save_service_checkpoint`), both
  periodically (``period_s``) and when ``dirty_threshold`` commits have
  landed since the last snapshot;
* store entries evicted by LRU pressure while still warm are buffered
  (``note_evicted``, from the store's ``on_evict`` hook) and written
  back into every snapshot, so a restart restores them even though the
  live store had dropped them;
* startup recovery (``recover``) walks snapshots newest-first through
  :func:`restore_service_checkpoint`, skipping any that raise
  :class:`CheckpointCorrupt` (torn write) and restoring the newest
  readable one — entries land at their saved versions, so warm updates
  resume monotonically from the checkpoint.

The ``checkpoint.io`` fault seam fires *after* a snapshot lands and
byte-truncates the written ``arrays.npz`` — the torn-write case the
atomic rename cannot prevent — which is exactly what the recovery path
exercises.

Telemetry: ``checkpoint_age_seconds`` gauge, ``autockpt_snapshots`` /
``autockpt_corrupt_skipped`` / ``autockpt_errors`` counters.
"""
from __future__ import annotations

import collections
import os
import shutil
import threading
import time
from typing import Callable, Optional

from repro_torch.checkpoint.store import CheckpointCorrupt, checkpoint_steps
from repro_torch.resilience.faults import FaultError, FaultPlan
from repro_torch.timeline.checkpoint import (
    restore_service_checkpoint, save_service_checkpoint,
)


def _truncate_arrays(step_dir: str):
    """Chop the step's arrays.npz in half — a simulated torn write."""
    path = os.path.join(step_dir, "arrays.npz")
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: max(len(blob) // 2, 1)])


class AutoCheckpointer:
    def __init__(self, frontend, *, ckpt_dir: str,
                 period_s: float = 30.0, dirty_threshold: int = 0,
                 keep: int = 3, writeback: int = 64,
                 faults: Optional[FaultPlan] = None, telemetry=None,
                 clock: Callable[[], float] = time.monotonic):
        self.frontend = frontend
        self.ckpt_dir = str(ckpt_dir)
        self.period_s = float(period_s)
        self.dirty_threshold = int(dirty_threshold)
        self.keep = int(keep)
        self.writeback = int(writeback)
        self.faults = faults
        self.telemetry = telemetry
        self._clock = clock
        self._lock = threading.Lock()
        self._snap_lock = threading.Lock()   # one snapshot at a time
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dirty = 0
        self._evicted = collections.OrderedDict()  # gid -> StoreEntry
        self._t_snap = clock()
        self.last_step: Optional[int] = None
        self.last_error: Optional[str] = None
        self.n_snapshots = 0
        self.n_snapshot_errors = 0
        self.n_torn = 0                      # snapshots the plan truncated
        self.n_written_back = 0              # evicted entries snapshotted
        self.n_corrupt_skipped = 0           # snapshots skipped on recovery

    # -- hooks from the front end ---------------------------------------
    def note_commit(self, graph_id: str):
        with self._lock:
            self._dirty += 1
            # A re-committed graph is resident again; drop the stale
            # write-back copy so the snapshot serializes the live entry.
            self._evicted.pop(graph_id, None)
            due = 0 < self.dirty_threshold <= self._dirty
        if due:
            self._wake.set()

    def note_evicted(self, graph_id: str, entry):
        if self.writeback <= 0:
            return
        with self._lock:
            self._evicted[graph_id] = entry
            self._evicted.move_to_end(graph_id)
            while len(self._evicted) > self.writeback:
                self._evicted.popitem(last=False)

    # -- lifecycle ------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="autockpt")
        self._thread.start()

    def close(self, *, flush: bool = True):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if flush:
            try:
                self.snapshot(force=True)
            except Exception as e:      # a failed final flush must not
                self.last_error = repr(e)   # fail service close
                self.n_snapshot_errors += 1

    # -- snapshot / recovery --------------------------------------------
    def age_s(self) -> float:
        return self._clock() - self._t_snap

    def snapshot(self, force: bool = False) -> Optional[int]:
        """Take one snapshot now; returns the step written, or ``None``
        when there was nothing (new) to save."""
        with self._snap_lock:
            with self._lock:
                dirty = self._dirty
                evicted = dict(self._evicted)
            if not force and dirty == 0:
                return None
            if len(self.frontend.store) == 0 and not evicted:
                with self._lock:
                    self._dirty = max(self._dirty - dirty, 0)
                return None
            step = save_service_checkpoint(
                self.frontend, self.ckpt_dir, extra_entries=evicted)
            if self.faults is not None:
                try:
                    self.faults.perturb("checkpoint.io")
                except FaultError:
                    _truncate_arrays(os.path.join(
                        self.ckpt_dir, f"step-{step:010d}"))
                    self.n_torn += 1
            self._gc()
            with self._lock:
                self._dirty = max(self._dirty - dirty, 0)
            self._t_snap = self._clock()
            self.last_step = step
            self.n_snapshots += 1
            self.n_written_back += len(evicted)
            tel = self.telemetry
            if tel is not None and tel.enabled:
                tel.counter("autockpt_snapshots", 1)
                tel.gauge("checkpoint_age_seconds", 0.0)
                tel.gauge("checkpoint_last_step", float(step))
            return step

    def recover(self) -> Optional[int]:
        """Restore the newest readable snapshot into the front end;
        returns its step, or ``None`` when no snapshot could be read."""
        for step in sorted(checkpoint_steps(self.ckpt_dir), reverse=True):
            try:
                restored = restore_service_checkpoint(
                    self.frontend, self.ckpt_dir, step=step)
            except CheckpointCorrupt as e:
                self.n_corrupt_skipped += 1
                self.last_error = repr(e)
                tel = self.telemetry
                if tel is not None and tel.enabled:
                    tel.counter("autockpt_corrupt_skipped", 1)
                continue
            tel = self.telemetry
            if tel is not None and tel.enabled:
                tel.counter("autockpt_recoveries", 1)
            return restored
        return None

    # -- internals ------------------------------------------------------
    def _gc(self):
        steps = checkpoint_steps(self.ckpt_dir)
        for step in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(
                os.path.join(self.ckpt_dir, f"step-{step:010d}"),
                ignore_errors=True)

    def _loop(self):
        while not self._stop.is_set():
            timeout = max(self.period_s - self.age_s(), 0.05)
            self._wake.wait(timeout)
            self._wake.clear()
            if self._stop.is_set():
                break
            with self._lock:
                dirty = self._dirty
            due = dirty > 0 and (
                0 < self.dirty_threshold <= dirty
                or self.age_s() >= self.period_s)
            if due:
                try:
                    self.snapshot()
                except Exception as e:
                    self.last_error = repr(e)
                    self.n_snapshot_errors += 1
                    tel = self.telemetry
                    if tel is not None and tel.enabled:
                        tel.counter("autockpt_errors", 1)
            tel = self.telemetry
            if tel is not None and tel.enabled:
                tel.gauge("checkpoint_age_seconds", self.age_s())
