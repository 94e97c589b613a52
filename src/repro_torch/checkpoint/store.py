"""Checkpoint store (port of ``repro/checkpoint/store.py``): atomic,
keep-last-k, with async writes.

The file format is the reference's, so a directory written by either
package reads in the other:

* ``<dir>/step-<step:010d>/arrays.npz`` holds one member ``leaf_{i}`` a
  leaf, in the tree's flattening order;
* ``manifest.json`` holds ``step``, ``paths``, ``dtypes``, ``shapes`` and
  ``extra``.  A path is the reference's ``jax.tree_util`` key path:
  ``['key']`` for a dict key (keys sorted), ``[i]`` for a list or tuple
  index, ``.name`` for a namedtuple field, joined by ``/``.

The port flattens dicts, lists, tuples, namedtuples and ``None`` (an empty
subtree, as in JAX) itself; anything else is a leaf.  A tensor leaf is
copied to the host with ``.detach().cpu()``.  bfloat16 has no numpy dtype
where ``ml_dtypes`` is absent, so a bf16 leaf is stored as its 16 bits in
``uint16`` under the manifest dtype ``"bfloat16"`` (the reference's
``str(dtype)``) and restored by a view.

Writes go to ``<dir>/tmp-<step>`` and are renamed into place, so a crash
mid-write never corrupts the latest checkpoint.  Restore takes ``device=``
(one device) or the reference's ``shardings=`` (each leaf a DTensor on a
``DeviceMesh``, :func:`restore_checkpoint`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"


class CheckpointCorrupt(Exception):
    """A checkpoint directory failed to read back — truncated/partial
    ``arrays.npz``, unparseable or missing ``manifest.json``, or a
    manifest/array mismatch.  One typed error for every corruption mode,
    so recovery code can fall back to an earlier snapshot instead of
    pattern-matching raw ``KeyError`` / ``BadZipFile`` internals."""


def _to_host(x) -> np.ndarray:
    """A leaf as the numpy array the file stores (bf16 as its uint16
    bits)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _dtype_name(x, host: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return BF16
    return str(host.dtype)


def _from_host(a: np.ndarray, dtype: str):
    """A stored leaf back as an array: a CPU bf16 tensor where the
    manifest says ``"bfloat16"`` and the file holds its bits, else numpy."""
    if dtype == BF16 and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


def _read_step_dir(d: str):
    """Read one step directory's (manifest, leaves), raising
    :class:`CheckpointCorrupt` on any decode failure.  Leaves are
    materialized eagerly so a truncated zip member surfaces here, not at
    first use."""
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes") or [""] * len(manifest["paths"])
        with np.load(os.path.join(d, "arrays.npz")) as data:
            leaves = [_from_host(np.asarray(data[f"leaf_{i}"]), dtypes[i])
                      for i in range(len(manifest["paths"]))]
    except Exception as e:
        raise CheckpointCorrupt(
            f"checkpoint at {d} is corrupt or incomplete: "
            f"{type(e).__name__}: {e}") from e
    return manifest, leaves


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree) -> Tuple[List[str], List[Any], Callable]:
    """``(paths, leaves, rebuild)``: the reference's key paths and leaves
    in ``jax.tree_util`` order, and ``rebuild(new_leaves)`` giving a tree
    of the same structure."""
    paths: List[str] = []
    leaves: List[Any] = []

    def walk(x, prefix):
        if x is None:
            return lambda it: None
        if isinstance(x, dict):
            keys = sorted(x)
            subs = [walk(x[k], prefix + [f"[{k!r}]"]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if _is_namedtuple(x):
            subs = [walk(getattr(x, f), prefix + [f".{f}"])
                    for f in x._fields]
            return lambda it: type(x)(*[s(it) for s in subs])
        if isinstance(x, (list, tuple)):
            subs = [walk(v, prefix + [f"[{i}]"]) for i, v in enumerate(x)]
            return lambda it: type(x)(s(it) for s in subs)
        paths.append("/".join(prefix))
        leaves.append(x)
        return lambda it: next(it)

    build = walk(tree, [])
    return paths, leaves, lambda new: build(iter(new))


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    extra: Optional[dict] = None) -> str:
    """Write one atomic checkpoint. Returns its final directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    final = os.path.join(ckpt_dir, f"step-{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    paths, leaves, _ = _flatten_with_paths(tree)
    arrays = {f"leaf_{i}": _to_host(x) for i, x in enumerate(leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = dict(
        step=int(step),
        paths=paths,
        dtypes=[_dtype_name(x, a) for x, a in zip(leaves, arrays.values())],
        shapes=[list(a.shape) for a in arrays.values()],
        extra=extra or {},
    )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def checkpoint_steps(ckpt_dir: str) -> list:
    """All step numbers present in ``ckpt_dir``, sorted ascending
    (``[]`` when the directory is absent or empty)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step-")
    )


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = checkpoint_steps(ckpt_dir)
    return steps[-1] if steps else None


def _cast(leaf, like, device):
    """A stored leaf in the type of its ``tree_like`` counterpart: a tensor
    of ``like``'s dtype, a numpy array of ``like``'s dtype, or the leaf as
    read.  With ``device`` every array leaf becomes a tensor there.  A
    0-dim leaf stays 0-dim (``np.array``, where ``np.ascontiguousarray``
    would give it one dimension)."""
    if isinstance(like, torch.Tensor):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.array(leaf))
        return t.to(device or "cpu", like.dtype)
    if hasattr(like, "dtype"):
        leaf = np.asarray(leaf).astype(like.dtype)
    if device is not None and isinstance(leaf, (np.ndarray, torch.Tensor)):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.array(leaf))
        return t.to(device)
    return leaf


def _distribute(leaf, sharding):
    """A restored leaf as a DTensor of ``sharding``: a
    :class:`~repro_torch.distributed.sharding.NamedSharding` or a ``(mesh,
    spec)`` pair, its mesh a ``DeviceMesh`` with axis names."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import NamedSharding

    if not isinstance(sharding, NamedSharding):
        sharding = NamedSharding(*sharding)
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.array(leaf))
    mesh = sharding.mesh
    return distribute_tensor(t.to(mesh.device_type), mesh,
                             list(sharding.placements()))


class _Leaf:
    """One sharding, held as a leaf of its tree (a ``(mesh, spec)`` pair
    is a tuple, which the flattening would walk into)."""

    def __init__(self, sharding):
        self.sharding = sharding


def _pairs_as_leaves(tree_like, shardings):
    """``shardings`` (a tree like ``tree_like``) with each leaf wrapped,
    so that it flattens in ``tree_like``'s leaf order."""
    from repro_torch.tree import tree_map

    return tree_map(lambda _, sh: _Leaf(sh), tree_like, shardings)


def restore_checkpoint(ckpt_dir: str, tree_like, *, step: Optional[int] = None,
                       device=None, shardings=None):
    """Restore into the structure of ``tree_like``.

    Each leaf takes the dtype of its ``tree_like`` counterpart: a tensor
    counterpart gives a tensor (on the CPU, or on ``device``), a numpy one
    a numpy array.  ``device`` (one device) places every array leaf there
    as a tensor.  ``shardings`` (the reference's target shardings): a tree
    like ``tree_like`` whose leaves are
    :class:`~repro_torch.distributed.sharding.NamedSharding` or ``(mesh,
    spec)`` pairs on a ``DeviceMesh``; each leaf goes through
    ``distribute_tensor`` onto its mesh's device type, a DTensor.
    Returns (tree, step) or (None, None) when no checkpoint exists.
    """
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None, None
    d = os.path.join(ckpt_dir, f"step-{step:010d}")
    manifest, leaves = _read_step_dir(d)
    paths, like_leaves, rebuild = _flatten_with_paths(tree_like)
    if paths != manifest["paths"]:
        raise ValueError(
            "checkpoint tree mismatch:\n"
            f"  saved:    {manifest['paths'][:5]}...\n  expected: {paths[:5]}..."
        )
    dev = None if device is None else torch.device(device)
    out = [_cast(leaf, like, dev) for leaf, like in zip(leaves, like_leaves)]
    if shardings is not None:
        targets = _flatten_with_paths(_pairs_as_leaves(tree_like, shardings))[1]
        out = [_distribute(leaf, sh.sharding)
               for leaf, sh in zip(out, targets)]
    return rebuild(out), step


def load_checkpoint_arrays(ckpt_dir: str, *, step: Optional[int] = None):
    """Load one checkpoint's raw leaves keyed by manifest path.

    Structure-free twin of :func:`restore_checkpoint` for callers that
    rebuild rich host objects from the arrays (e.g. the timeline-service
    checkpoint, :mod:`repro_torch.timeline.checkpoint`) instead of filling
    a ``tree_like``.  Dict-key path segments are normalized back to the
    plain key (``['x']`` -> ``x``), so a checkpoint saved from a flat
    ``{name: array}`` tree round-trips to the same names.

    Returns ``(arrays, extra, step)`` — ``arrays`` a dict path->ndarray (a
    CPU tensor for a bf16 leaf), ``extra`` the manifest's extra dict — or
    ``(None, None, None)`` when no checkpoint exists.
    """
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None, None, None
    d = os.path.join(ckpt_dir, f"step-{step:010d}")
    manifest, leaves = _read_step_dir(d)

    def norm(path: str) -> str:
        return "/".join(
            s[2:-2] if s.startswith("['") and s.endswith("']") else s
            for s in path.split("/"))

    arrays = {norm(p): leaf
              for p, leaf in zip(manifest["paths"], leaves)}
    return arrays, manifest.get("extra", {}), step


class CheckpointManager:
    """Keep-last-k manager with optional async writes."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3, async_save: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def _gc(self):
        for s in checkpoint_steps(self.dir)[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:010d}"),
                          ignore_errors=True)

    def save(self, step: int, tree, extra: Optional[dict] = None):
        # copy to the host synchronously (the caller may change the device
        # tensors right after), write + gc on a worker thread when async
        _, leaves, rebuild = _flatten_with_paths(tree)
        host = rebuild([x.detach().cpu().clone()
                        if isinstance(x, torch.Tensor) else np.array(x)
                        for x in leaves])

        def work():
            save_checkpoint(self.dir, step, host, extra=extra)
            self._gc()

        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, tree_like, device=None):
        self.wait()
        return restore_checkpoint(self.dir, tree_like, device=device)
