"""Temporal community tracking over the dynamic-update service (port of
``repro/timeline/``; host code, apart from the warm updates of the store
it observes).

The dynamic core answers "what are the communities now" after
edge/vertex churn; this package answers "what *happened* to them":

* :mod:`repro_torch.timeline.idmap`   — stable **external vertex ids**
  over the core's order-preserving compaction remaps (and deferred
  tombstones), so clients address vertices by one id for life;
* :mod:`repro_torch.timeline.matcher` — snapshot-to-snapshot community
  matching (weighted Jaccard on external-id member sets) assigning
  persistent community identities and emitting lifecycle events:
  birth, death, merge, split, continuation;
* :mod:`repro_torch.timeline.store`   — bounded-memory timeline store:
  membership snapshots (``membership_at``), per-community rows
  (``timeline``), the lifecycle event log;
* :mod:`repro_torch.timeline.tracker` — :class:`TimelineManager` (hangs
  off the ResultStore commit hook; one snapshot per commit), window
  translation from external-id event streams
  (:func:`translate_window`), and :class:`WindowedIngest`;
* :mod:`repro_torch.timeline.checkpoint` — save/restore of timelines +
  warm store entries through :mod:`repro_torch.checkpoint.store`.

The paper's zero-disconnected invariant holds at every window boundary:
each snapshot is produced by the warm path's split pass.
"""
from repro_torch.timeline.checkpoint import (
    restore_service_checkpoint, save_service_checkpoint,
)
from repro_torch.timeline.idmap import ExternalIdMap, compose_batch_maps
from repro_torch.timeline.matcher import (
    LIFECYCLE_KINDS, LifecycleEvent, match_snapshots, weighted_jaccard,
)
from repro_torch.timeline.store import (
    CommunityTimeline, Snapshot, TimelineStore,
)
from repro_torch.timeline.tracker import (
    TimelineConfig, TimelineManager, WindowedIngest, translate_window,
)

__all__ = [
    "CommunityTimeline",
    "ExternalIdMap",
    "LIFECYCLE_KINDS",
    "LifecycleEvent",
    "Snapshot",
    "TimelineConfig",
    "TimelineManager",
    "TimelineStore",
    "WindowedIngest",
    "compose_batch_maps",
    "match_snapshots",
    "restore_service_checkpoint",
    "save_service_checkpoint",
    "translate_window",
    "weighted_jaccard",
]
