"""Stable external vertex ids over internal compactions (port of
``repro/timeline/idmap.py``, host numpy only).

The dynamic core compacts removed vertices away: a surviving
internal id shifts down by the number of removed ids below it, every
batch (the *compaction contract* of :func:`repro_torch.core.dynamic.
apply_vertex_updates`).  That keeps device shapes dense but makes raw
internal ids useless as long-lived names — after two removals "vertex 7"
is a different vertex.  :class:`ExternalIdMap` is the id-map layer over
the contract's ``UpdatePlan.id_map`` remaps: every vertex gets an
**external id on first sight and keeps it for life**, across arbitrarily
many compactions, deferred-compaction tombstones, re-bucketing rebuilds
and checkpoint restores.  All timeline state (member sets, snapshots,
``membership_at`` answers) lives in external-id space.

The contract:

* externals are assigned from one monotone counter, never reused;
* ``apply(id_map, n_new)`` folds one committed remap: survivors carry
  their external through ``id_map``; internal slots in ``[0, n_new)``
  not claimed by a survivor (vertex additions) get fresh externals in
  increasing internal-id order — exactly the order the core assigns
  added ids, so client and service agree without a handshake;
* ``retire_internal(ids)`` handles deferred compaction: the external
  retires at removal time even though the internal slot lingers as a
  tombstone until the store pays for the remap.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dynamic import as_update


class ExternalIdMap:
    """Bidirectional internal<->external vertex id map (host-side).

    Not thread-safe on its own — the owning
    :class:`repro_torch.timeline.tracker.TimelineManager` serializes access.
    """

    def __init__(self, n: int = 0, *, start: int = 0):
        self._ext = np.arange(start, start + int(n), dtype=np.int64)
        self._int: Dict[int, int] = {int(e): i
                                     for i, e in enumerate(self._ext)}
        self._next = start + int(n)
        self._retired: set = set()

    # -- introspection -----------------------------------------------------
    @property
    def n_slots(self) -> int:
        """Internal id range covered (including deferred tombstones)."""
        return int(self._ext.size)

    @property
    def n_live(self) -> int:
        return len(self._int)

    @property
    def next_external(self) -> int:
        return self._next

    def externals(self) -> np.ndarray:
        """int64[n_slots]: external id per internal slot, -1 at deferred
        tombstones."""
        return self._ext.copy()

    def external_of(self, internal: int) -> int:
        e = int(self._ext[int(internal)])
        if e < 0:
            raise KeyError(f"internal id {internal} is a retired tombstone")
        return e

    def internal_of(self, external: int) -> Optional[int]:
        """Current internal slot of an external id; None once retired."""
        return self._int.get(int(external))

    def __contains__(self, external: int) -> bool:
        return int(external) in self._int

    def is_retired(self, external: int) -> bool:
        return int(external) in self._retired

    # -- mutation ----------------------------------------------------------
    def apply(self, id_map: Optional[np.ndarray], n_new: int, *,
              fresh_ids: Optional[Sequence[int]] = None
              ) -> Tuple[List[int], List[int]]:
        """Fold one committed vertex remap.

        ``id_map``: old internal -> new internal over at least the old
        slot range, ``-1`` at removed ids (``UpdatePlan.id_map``); None
        means identity over the surviving prefix (pure growth, or an
        edges-only commit).  ``n_new``: the post-commit ``n_nodes``.

        ``fresh_ids``: externally-chosen ids for the newly claimed
        internal slots (in claim order) — how the windowed ingest layer
        binds the client's names for added vertices.  Must match the
        fresh-slot count exactly and not collide with live or retired
        externals; otherwise the binding is rejected wholesale and the
        slots mint from the internal counter (callers can detect the
        fallback by comparing the returned ``fresh`` list).

        Returns ``(fresh, retired)`` external ids: ``fresh`` for newly
        claimed internal slots (in increasing internal-id order) and
        ``retired`` for externals whose vertex was removed by this remap
        (excluding tombstones already retired via
        :meth:`retire_internal`).
        """
        n_new = int(n_new)
        old = self._ext
        ext = np.full(n_new, -1, np.int64)
        # deferred-tombstone slots (-1 in old) that survive this remap are
        # NOT fresh: they stay dead until a flush drops them.  Without
        # this, a pure-growth commit while tombstones linger would bind
        # (or mint) new externals into dead slots.
        tomb = np.empty(0, np.int64)
        if id_map is None:
            k = min(old.size, n_new)
            ext[:k] = old[:k]
            tomb = np.flatnonzero(old[:k] < 0)
        elif old.size:
            dest = np.asarray(id_map, np.int64)[:old.size]
            ok = (dest >= 0) & (dest < n_new) & (old >= 0)
            ext[dest[ok]] = old[ok]
            tomb = dest[(dest >= 0) & (dest < n_new) & (old < 0)]
        survivors = set(ext[ext >= 0].tolist())
        retired = sorted(set(old[old >= 0].tolist()) - survivors)
        self._retired.update(retired)
        fresh_mask = ext < 0
        fresh_mask[tomb] = False
        fresh_slots = np.flatnonzero(fresh_mask)
        fresh: List[int] = []
        if fresh_ids is not None and len(fresh_ids) == fresh_slots.size:
            cand = [int(e) for e in fresh_ids]
            if (len(set(cand)) == len(cand)
                    and not any(e in survivors or e in self._retired
                                for e in cand)):
                fresh = cand
        if not fresh and fresh_slots.size:
            fresh = list(range(self._next, self._next + fresh_slots.size))
        if fresh:
            ext[fresh_slots] = fresh
            self._next = max(self._next, max(fresh) + 1)
        self._ext = ext
        self._int = {int(e): i for i, e in enumerate(ext) if e >= 0}
        return fresh, retired

    def retire_internal(self, internal_ids: Sequence[int]) -> List[int]:
        """Deferred removal: retire the externals NOW while the internal
        slots linger as tombstones (``-1`` in :meth:`externals`) until a
        later compaction's :meth:`apply` drops them."""
        retired = []
        for i in internal_ids:
            i = int(i)
            e = int(self._ext[i])
            if e < 0:
                continue
            self._ext[i] = -1
            self._int.pop(e, None)
            self._retired.add(e)
            retired.append(e)
        return retired

    # -- checkpointing -----------------------------------------------------
    def state(self) -> Tuple[np.ndarray, int, np.ndarray]:
        return (self._ext.copy(), self._next,
                np.asarray(sorted(self._retired), np.int64))

    @classmethod
    def from_state(cls, ext: np.ndarray, next_external: int,
                   retired=()) -> "ExternalIdMap":
        m = cls(0)
        m._ext = np.asarray(ext, np.int64).copy()
        m._int = {int(e): i for i, e in enumerate(m._ext) if e >= 0}
        m._next = int(next_external)
        m._retired = set(int(e) for e in np.asarray(retired).ravel())
        return m


def compose_batch_maps(n0: int, batches) -> Tuple[np.ndarray, int]:
    """Compose the compaction contract across folded update batches.

    Mirrors :func:`repro_torch.core.dynamic.rebuild_with_vertex_ops` /
    ``prepare_update_seq`` semantics without touching a graph: per batch,
    removals drop their ids (survivors shift down, order-preserving),
    then ``add`` claims the next ids.  Returns ``(id_map, n_final)``
    where ``id_map`` is int64[n0] old->final internal (-1 removed) —
    what :meth:`ExternalIdMap.apply` needs to track a re-bucketing
    rebuild (the front end's rebuild, ROADMAP A.11), which
    replays exactly these semantics.
    """
    cur = np.arange(int(n0), dtype=np.int64)
    n = int(n0)
    for upd in batches:
        upd = as_update(upd)
        rem = np.asarray(upd.remove, np.int64).ravel()
        if rem.size:
            if rem.size and (int(rem.min()) < 0 or int(rem.max()) >= n):
                raise ValueError(
                    f"remove ids must be in [0, {n}); got "
                    f"[{int(rem.min())}, {int(rem.max())}]")
            alive = np.ones(n, bool)
            alive[rem] = False
            shift = np.cumsum(alive) - 1          # new id per old alive id
            live = cur >= 0
            src = np.clip(cur, 0, n - 1)
            cur = np.where(live & alive[src], shift[src], -1)
            n -= rem.size
        n += int(upd.add)
    return cur, n
