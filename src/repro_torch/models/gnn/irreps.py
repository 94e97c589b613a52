"""Minimal real-basis SO(3) irrep machinery for NequIP (l_max <= 2), port
of ``repro/models/gnn/irreps.py``.

The Clebsch-Gordan tensors are computed **numerically**, in float64 numpy,
by the reference's own steps, so the tables are the reference's:

1. Real spherical-harmonic bases are *defined* by the closed-form
   polynomials in :func:`sh_np`.
2. The Wigner matrix ``D_l(R)`` for a sample rotation is recovered by
   least-squares from ``sh_l(R x) = D_l(R) sh_l(x)`` over random points.
3. The CG tensor for a path (l1, l2 -> l3) is the null space of the
   invariance constraints ``(D1 (x) D2 (x) D3) vec(T) = vec(T)`` stacked
   for several random rotations — dimension 1 for every admissible triple,
   normalized to unit Frobenius norm with a fixed sign.

:func:`sh` is the torch twin of :func:`sh_np` that the model runs.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


def sh_np(x: np.ndarray, l: int) -> np.ndarray:  # noqa: E741
    """Real spherical-harmonic basis (unnormalized polynomials), x: [..., 3]."""
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    if l == 0:
        return np.ones(x.shape[:-1] + (1,), x.dtype)
    if l == 1:
        return np.stack([X, Y, Z], axis=-1)
    if l == 2:
        r2 = X * X + Y * Y + Z * Z
        return np.stack(
            [X * Y, Y * Z, (3 * Z * Z - r2) / (2 * np.sqrt(3.0)), X * Z,
             (X * X - Y * Y) / 2.0],
            axis=-1,
        ) * np.sqrt(3.0)
    raise NotImplementedError(l)


def sh(x: torch.Tensor, l: int) -> torch.Tensor:  # noqa: E741
    """torch version of :func:`sh_np` (x: [..., 3])."""
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    if l == 0:
        return torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    if l == 1:
        return torch.stack([X, Y, Z], dim=-1)
    if l == 2:
        r2 = X * X + Y * Y + Z * Z
        return torch.stack(
            [X * Y, Y * Z, (3 * Z * Z - r2) / (2 * math.sqrt(3.0)), X * Z,
             (X * X - Y * Y) / 2.0],
            dim=-1,
        ) * math.sqrt(3.0)
    raise NotImplementedError(l)


def _rotation(rng) -> np.ndarray:
    """Random rotation matrix via QR of a Gaussian."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def wigner_d(R: np.ndarray, l: int) -> np.ndarray:  # noqa: E741
    """D_l(R) with sh_l(R x) = D_l(R) sh_l(x), by least squares."""
    rng = np.random.default_rng(12345 + l)
    pts = rng.normal(size=(64, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    A = sh_np(pts, l)                 # [K, 2l+1]
    B = sh_np(pts @ R.T, l)           # [K, 2l+1]
    D, *_ = np.linalg.lstsq(A, B, rcond=None)
    return D.T                        # B^T = D @ A^T


@functools.lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG tensor [2l1+1, 2l2+1, 2l3+1], unit Frobenius norm."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        raise ValueError(f"inadmissible path {(l1, l2, l3)}")
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    rng = np.random.default_rng(0)
    rows = []
    eye = np.eye(d1 * d2 * d3)
    for _ in range(3):
        R = _rotation(rng)
        D1, D2, D3 = (wigner_d(R, l) for l in (l1, l2, l3))  # noqa: E741
        M = np.einsum("ab,cd,ef->acebdf", D1, D2, D3).reshape(
            d1 * d2 * d3, d1 * d2 * d3
        )
        rows.append(M - eye)
    A = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(A)
    null_dim = int(np.sum(s < 1e-8 * max(float(s[0]), 1.0)))
    if null_dim < 1:
        raise ValueError(f"no invariant tensor for {(l1, l2, l3)}: {s[-3:]}")
    T = vt[-1].reshape(d1, d2, d3)    # trailing rows of vt: the null space
    T = T / np.linalg.norm(T)
    flat = T.ravel()
    lead = flat[np.argmax(np.abs(flat) > 1e-9)]
    if lead < 0:
        T = -T
    return T


def admissible_paths(l_max: int):
    """All (l1, l2, l3) with every l <= l_max, |l1-l2| <= l3 <= l1+l2, and
    l1 + l2 + l3 even (parity-allowed in the real polynomial bases)."""
    paths = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if abs(l1 - l2) <= l3 <= l1 + l2 and (l1 + l2 + l3) % 2 == 0:
                    paths.append((l1, l2, l3))
    return paths
