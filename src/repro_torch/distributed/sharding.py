"""Sharding rules: logical-axis -> mesh-axis mapping per workload family
(port of ``repro/distributed/sharding.py``).

Rather than hand-writing a partition spec for every array of every
architecture, arrays carry *logical axes* (strings) and each workload family
declares one rule table.  ``spec(...)`` resolves logical axes to mesh axes,
dropping mesh axes that do not exist on the current mesh (so the same rules
drive the single-pod ``(data, model)`` mesh and the multi-pod
``(pod, data, model)`` mesh).

Conventions (the reference's):
  * ``batch``   -> ('pod', 'data')  : data parallelism (outer pod axis).
  * ``embed``/'mlp'/'heads'/'experts'/'vocab' -> 'model' : tensor parallel.
  * ``fsdp``    -> ('pod', 'data')  : parameter sharding over the data axis
                   (FSDP); used for LM parameter/optimizer-state storage.
  * ``edges``   -> ('pod', 'data', 'model') flattened: graph edge shards.
  * ``rows``    -> 'model' : embedding-table row sharding (recsys).

The port keeps its own :class:`PartitionSpec`, with the reference's
semantics: one entry a tensor dim, each ``None``, a mesh-axis name or a
tuple of names.  A mesh is anything with axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``, or
an :class:`AbstractMesh` (names and sizes only, no process group), which
is enough to resolve specs.  :meth:`NamedSharding.placements` turns a spec
into DTensor placements on a ``DeviceMesh``: one a mesh dim, ``Shard(d)``
where the spec names that mesh axis for tensor dim ``d``, else
``Replicate()``.

A tensor dim over several mesh axes (``P(('model', 'data'))``, the decode
override's ``mlp``) takes them **in mesh order**: DTensor's plain ``Shard``
orders the shards by mesh dim, so a ``(data, model)`` mesh gives device
``(i, j)`` shard ``i * n_model + j`` where the reference's layout gives
``j * n_data + i``.  Each device holds the same number of elements either
way (the per-device bytes and every roofline term are the same); only which
slice a device holds differs.  The port does not use DTensor's private
``_StridedShard`` to reproduce the reference's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "seq": (),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),
    "kv_len": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "rows": ("model",),
    "edges": ("pod", "data", "model"),
    "nodes": (),
    "feat": ("model",),
    "stack": (),
    None: (),
}


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), a mesh-axis name, or
    a tuple of names (the dim split over their product, first name
    outermost)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axes(self, dim: int) -> tuple:
        """The mesh axes of tensor dim ``dim`` (empty beyond the spec)."""
        p = self[dim] if dim < len(self) else None
        if p is None:
            return ()
        return tuple(p) if isinstance(p, tuple) else (p,)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, without devices or a process group
    (the reference's ``jax.sharding.AbstractMesh``)."""

    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of ``mesh`` in mesh order: an
    :class:`AbstractMesh`, or a ``DeviceMesh`` built with
    ``mesh_dim_names``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError(f"a mesh needs axis names, got {mesh!r}")
    return dict(zip(names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: object
    spec: PartitionSpec

    def placements(self) -> tuple:
        """DTensor placements on a ``DeviceMesh``: one a mesh dim, mesh
        order (see the module docstring for multi-axis dims).  A mesh dim
        of size 1 replicates, whatever the spec says: a shard of one is
        the whole tensor, and DTensor refuses some views of it."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name, n in mesh_axes(self.mesh).items():
            dims = [d for d in range(len(self.spec))
                    if name in self.spec.axes(d)]
            out.append(Shard(dims[0]) if dims and n > 1 else Replicate())
        return tuple(out)

    def shard_shape(self, shape) -> tuple:
        """The per-device shape of a ``shape`` tensor (every kept axis
        divides its dim: :func:`repro_torch.launch.steps._safe_spec`)."""
        sizes = mesh_axes(self.mesh)
        return tuple(
            n // math.prod(sizes[a] for a in self.spec.axes(d))
            for d, n in enumerate(shape))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_RULES))

    def with_overrides(self, **over) -> "ShardingRules":
        r = dict(self.rules)
        for k, v in over.items():
            r[k] = tuple(v) if isinstance(v, (list, tuple)) else (v,)
        return ShardingRules(r)

    def spec(self, mesh, logical_axes: Sequence[Optional[str]]) -> P:
        names_on_mesh = mesh_axes(mesh)
        parts = []
        used: set = set()
        for ax in logical_axes:
            names = self.rules.get(ax, ())
            resolved = tuple(
                n for n in names if n in names_on_mesh and n not in used
            )
            used.update(resolved)
            if len(resolved) == 0:
                parts.append(None)
            elif len(resolved) == 1:
                parts.append(resolved[0])
            else:
                parts.append(resolved)
        return P(*parts)

    def named(self, mesh, logical_axes: Sequence[Optional[str]]
              ) -> NamedSharding:
        return NamedSharding(mesh, self.spec(mesh, logical_axes))


def is_axes(x) -> bool:
    """Whether ``x`` is a logical-axes leaf: a tuple of names and
    ``None``."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def map_axes(fn, axes_tree, *rest):
    """``fn`` over the logical-axes leaves of ``axes_tree`` (and the nodes
    of ``rest`` at the same places).  ``repro_torch.tree.tree_map`` would
    walk into the axes tuples, so the logical trees have this walker of
    their own (dicts by sorted key, lists by index)."""
    if is_axes(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, axes_tree[k], *(r[k] for r in rest))
                for k in sorted(axes_tree)}
    if isinstance(axes_tree, list):
        return [map_axes(fn, a, *(r[i] for r in rest))
                for i, a in enumerate(axes_tree)]
    raise TypeError(f"not a logical-axes tree node: {axes_tree!r}")


def tree_shardings(mesh, logical_tree, rules: ShardingRules | None = None):
    """Map a tree of logical-axis tuples to a tree of NamedShardings."""
    rules = rules or ShardingRules()
    return map_axes(lambda axes: rules.named(mesh, axes), logical_tree)


__all__ = ["DEFAULT_RULES", "PartitionSpec", "P", "AbstractMesh",
           "NamedSharding", "ShardingRules", "mesh_axes", "map_axes",
           "tree_shardings"]
