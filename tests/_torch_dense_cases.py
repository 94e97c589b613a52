"""Stress cases of the dense scan's half-sweep and realized modularity.

Seeded numpy inputs at the shapes where the card's kernels
(``csrc/dense_sweep.cu``) branch or reach their limits: a hub row whose
degree is ``nv - 1``; every live vertex in one community; all singletons;
edge counts that are not a multiple of the 1,024-value fold chunk, and one
past 65,536 (many edges to one cell, long in-order folds); ``nv = 2``; and
refine's masked weights (runs of zero-weight edges).  Each case is a
directed COO sorted by ``src`` (the container's invariant) with a ghost
vertex ``nv - 1`` that no live edge touches, labels ``C`` with
``C[ghost] == ghost``, and movable and target masks.  ``K``, ``Sigma`` and
2m come from numpy folds in index order (float32, one add at a time), so
every package and device is handed the same bits.

``tests/test_torch_dense_sweep_cases.py`` holds the port's plain versions
to the reference on the CPU; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 3 hold the kernels to the plain versions on the
card.
"""
from __future__ import annotations

import numpy as np

FLAT_CHUNK = 1024


def _fold_by(values: np.ndarray, ids: np.ndarray, n: int) -> np.ndarray:
    """Per-id float32 left folds from +0.0 in index order."""
    out = np.zeros(n, np.float32)
    for v, i in zip(values.tolist(), ids.tolist()):
        out[i] = np.float32(out[i] + np.float32(v))
    return out


def tree_sum(x: np.ndarray) -> np.float32:
    """``ops.sum_inorder``: left folds of FLAT_CHUNK values, level after
    level, to one value."""
    x = np.asarray(x, np.float32)
    while True:
        x = np.array([_fold_by(x[i:i + FLAT_CHUNK],
                               np.zeros(min(FLAT_CHUNK, x.shape[0] - i),
                                        np.int64), 1)[0]
                      for i in range(0, max(x.shape[0], 1), FLAT_CHUNK)],
                     np.float32)
        if x.shape[0] == 1:
            return x[0]


def _sorted(src, dst, w):
    order = np.argsort(src, kind="stable")
    return (src[order].astype(np.int32), dst[order].astype(np.int32),
            w[order].astype(np.float32))


def _random_edges(rng, n_live, m):
    src = rng.integers(0, n_live, m)
    dst = rng.integers(0, n_live, m)
    w = rng.random(m).astype(np.float32) + np.float32(0.25)
    return src, dst, w


def case(name: str, nv: int, src, dst, w, C, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    src, dst, w = _sorted(np.asarray(src), np.asarray(dst), np.asarray(w))
    C = np.asarray(C, np.int32).copy()
    C[nv - 1] = nv - 1
    movable = rng.random(nv) < 0.6
    movable[0] = True           # the hub row is scored
    K = _fold_by(w, src, nv)
    return dict(name=name, nv=nv, src=src, dst=dst, w=w, C=C, K=K,
                Sigma=_fold_by(K, C, nv), two_m=tree_sum(w),
                movable=movable, target_ok=rng.random(nv) < 0.5)


def dense_cases() -> list[dict]:
    """The stress cases, in a fixed order."""
    rng = np.random.default_rng(21)
    out = []

    # a hub: vertex 0 reaches itself and every other live vertex
    nv = 300
    live = nv - 1
    others = np.arange(1, live)
    s, d, w = _random_edges(rng, live - 1, 600)     # among the others
    s, d = s + 1, d + 1
    src = np.concatenate([[0], np.zeros(live - 1, np.int64), others, s, d])
    dst = np.concatenate([[0], others, np.zeros(live - 1, np.int64), d, s])
    ww = np.concatenate([[0.5], rng.random(2 * (live - 1)) + 0.25, w, w])
    out.append(case("hub", nv, src, dst, ww, rng.integers(0, 40, nv), 1))

    # one community holding every live vertex; then all singletons
    nv = 200
    s, d, w = _random_edges(rng, nv - 1, 1500)
    src, dst, ww = np.concatenate([s, d]), np.concatenate([d, s]), \
        np.concatenate([w, w])
    out.append(case("one-community", nv, src, dst, ww,
                    np.zeros(nv, np.int32), 2))
    out.append(case("singletons", nv, src, dst, ww, np.arange(nv), 3))

    # m not a multiple of the fold chunk; m past 65,536 on 513 slots
    for name, nv, m, k in (("m-ragged", 257, 3 * FLAT_CHUNK + 7, 30),
                           ("m-large", 513, 70_001, 20)):
        s, d, w = _random_edges(rng, nv - 1, m)
        out.append(case(name, nv, s, d, w, rng.integers(0, k, nv), 4))

    # nv = 2: one live vertex and the ghost
    out.append(case("nv2", 2, [0, 0, 0], [0, 0, 0], [0.5, 0.25, 2.0],
                    [0, 1], 5))

    # refine's masked weights: zero-weight runs exist and are no candidates
    nv = 300
    s, d, w = _random_edges(rng, nv - 1, 2000)
    part = rng.integers(0, 8, nv)
    src, dst, ww = np.concatenate([s, d]), np.concatenate([d, s]), \
        np.concatenate([w, w])
    ww = np.where(part[src] == part[dst], ww, 0.0).astype(np.float32)
    out.append(case("masked", nv, src, dst, ww, rng.integers(0, 25, nv), 6))
    return out


def past_max_nv_case(max_nv: int) -> dict:
    """One vertex past the kernels' shared-memory limit: random edges
    (self-loops included), eight an edge slot a vertex."""
    nv = max_nv + 1
    rng = np.random.default_rng(9)
    s, d, w = _random_edges(rng, nv - 1, 8 * nv)
    return case("past-max-nv", nv, s, d, w, rng.integers(0, nv // 4, nv), 7)


CASE_NAMES = ("hub", "one-community", "singletons", "m-ragged", "m-large",
              "nv2", "masked")
