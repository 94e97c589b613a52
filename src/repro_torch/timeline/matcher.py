"""Snapshot-to-snapshot community matching + lifecycle events (port of
``repro/timeline/matcher.py``: the same greedy order and tie-breaks).

Louvain's community *labels* are meaningless across runs — renumbering
permutes them freely even when the partition barely moved.  To build
timelines the service needs persistent community *identities*: given the
previous snapshot's communities (persistent id -> weighted member set,
in external vertex ids) and the new snapshot's communities (anonymous
member sets), decide which new community continues which old one and
what happened to the rest.

The matcher scores every overlapping (prev, new) pair with **weighted
Jaccard** on member sets — ``J(A, B) = w(A ∩ B) / w(A ∪ B)`` with
per-vertex weights (1.0 by default, vertex degree under
``weight_by_degree``) — and assigns greedily in deterministic order
(overlap desc, then prev id asc, then new index asc):

* the best unclaimed pair at or above ``jaccard_min`` is a
  **continuation**: the new community inherits the persistent id;
* a new community whose best qualifying overlap points at an
  already-claimed ancestor is a **split** child (fresh id, ancestor
  recorded as parent);
* a previous community whose best qualifying overlap points at an
  already-claimed heir **merged** into it (recorded as a parent on the
  heir's merge event);
* no qualifying overlap at all: **birth** (new) / **death** (prev).

One window may carry several of these at once (the simultaneous
merge+split case is covered by tests): the greedy pass resolves them
consistently because every decision consumes exactly one side of a
pair.  Ties are impossible to break "wrong" — equal-overlap candidates
order by the smaller persistent id, so reruns are bit-reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

# a community's members: external vertex id -> weight
Members = Dict[int, float]

LIFECYCLE_KINDS = ("birth", "death", "merge", "split", "continuation")


@dataclasses.dataclass(frozen=True)
class LifecycleEvent:
    """One community lifecycle transition at a window boundary.

    ``community`` is the persistent id the event is about: the surviving
    heir for merge, the new child for split/birth, the vanished id for
    death, the carried id for continuation.  ``parents`` names the other
    side: absorbed ids (merge) or the ancestor (split).  ``overlap`` is
    the weighted Jaccard that justified the decision (0 for
    birth/death).
    """

    kind: str
    t: float
    graph_id: str
    community: int
    parents: Tuple[int, ...] = ()
    overlap: float = 0.0
    size: int = 0

    def __post_init__(self):
        if self.kind not in LIFECYCLE_KINDS:
            raise ValueError(f"unknown lifecycle kind {self.kind!r}")


def weighted_jaccard(a: Members, b: Members) -> float:
    """w(A ∩ B) / w(A ∪ B) over external-id member sets; 0 when both
    empty.  Intersection takes min weight per vertex, union max — the
    standard weighted-Jaccard extension (equal weights reduce it to
    |A∩B| / |A∪B|)."""
    if not a or not b:
        return 0.0
    small, big = (a, b) if len(a) <= len(b) else (b, a)
    inter = 0.0
    for v, w in small.items():
        wb = big.get(v)
        if wb is not None:
            inter += min(w, wb)
    if inter == 0.0:
        return 0.0
    union = sum(a.values()) + sum(b.values())
    for v, w in small.items():
        wb = big.get(v)
        if wb is not None:
            union -= min(w, wb)
    return inter / union if union > 0 else 0.0


def match_snapshots(prev: Dict[int, Members], new: Sequence[Members], *,
                    t: float, graph_id: str, jaccard_min: float = 0.1,
                    next_id: Callable[[], int],
                    on_overlap: Callable[[float], None] = None,
                    ) -> Tuple[List[int], List[LifecycleEvent]]:
    """Assign persistent ids to ``new`` communities and emit lifecycle
    events vs ``prev``.

    Returns ``(assigned, events)`` where ``assigned[i]`` is the
    persistent id of ``new[i]`` and ``events`` lists every transition
    (continuations included) in deterministic order.  ``next_id`` mints
    fresh persistent ids (births and split children).  ``on_overlap``
    optionally observes every qualifying pair's Jaccard (telemetry
    histogram).
    """
    # score all overlapping pairs via an inverted vertex index: O(sum of
    # member-list sizes), not |prev| x |new|
    owner: Dict[int, List[int]] = {}
    for i, members in enumerate(new):
        for v in members:
            owner.setdefault(v, []).append(i)
    pair_keys = set()
    for pid, members in prev.items():
        for v in members:
            for i in owner.get(v, ()):
                pair_keys.add((pid, i))
    scored = []
    for pid, i in pair_keys:
        j = weighted_jaccard(prev[pid], new[i])
        if j >= jaccard_min:
            if on_overlap is not None:
                on_overlap(j)
            scored.append((j, pid, i))
    scored.sort(key=lambda s: (-s[0], s[1], s[2]))

    assigned: List[int] = [-1] * len(new)
    claimed_prev: Dict[int, int] = {}     # prev pid -> heir new index
    cont_overlap: Dict[int, float] = {}   # new index -> inherited overlap
    # pass 1: continuations (best unclaimed pair on both sides)
    for j, pid, i in scored:
        if assigned[i] < 0 and pid not in claimed_prev:
            assigned[i] = pid
            claimed_prev[pid] = i
            cont_overlap[i] = j
    # pass 2: splits — unassigned new with a qualifying (claimed) ancestor
    split_parent: Dict[int, Tuple[int, float]] = {}
    for j, pid, i in scored:
        if assigned[i] < 0 and i not in split_parent:
            split_parent[i] = (pid, j)
    for i in range(len(new)):
        if assigned[i] < 0 and i in split_parent:
            assigned[i] = next_id()
    # pass 3: merges — unclaimed prev with a qualifying (assigned) heir
    merged_into: Dict[int, List[Tuple[int, float]]] = {}  # new idx -> prev
    merge_best: Dict[int, float] = {}
    for j, pid, i in scored:
        if pid not in claimed_prev and pid not in merge_best:
            merged_into.setdefault(i, []).append((pid, j))
            merge_best[pid] = j
    # pass 4: births
    for i in range(len(new)):
        if assigned[i] < 0:
            assigned[i] = next_id()

    events: List[LifecycleEvent] = []
    for i in range(len(new)):
        size = len(new[i])
        if i in cont_overlap:
            parents = merged_into.get(i)
            if parents:
                events.append(LifecycleEvent(
                    "merge", t, graph_id, assigned[i],
                    parents=tuple(p for p, _ in parents),
                    overlap=max(j for _, j in parents), size=size))
            else:
                events.append(LifecycleEvent(
                    "continuation", t, graph_id, assigned[i],
                    overlap=cont_overlap[i], size=size))
        elif i in split_parent:
            pid, j = split_parent[i]
            events.append(LifecycleEvent(
                "split", t, graph_id, assigned[i], parents=(pid,),
                overlap=j, size=size))
            parents = merged_into.get(i)
            if parents:
                # a split child can absorb an unclaimed community in the
                # same window (the simultaneous merge+split case)
                events.append(LifecycleEvent(
                    "merge", t, graph_id, assigned[i],
                    parents=tuple(p for p, _ in parents),
                    overlap=max(jj for _, jj in parents), size=size))
        else:
            events.append(LifecycleEvent(
                "birth", t, graph_id, assigned[i], size=size))
    for pid in sorted(prev):
        if pid not in claimed_prev and pid not in merge_best:
            events.append(LifecycleEvent(
                "death", t, graph_id, pid, size=0))
    return assigned, events
