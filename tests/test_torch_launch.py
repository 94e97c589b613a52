"""The port's launch layer (``repro_torch.launch.steps``,
``repro_torch.distributed.sharding``, ``repro_torch.roofline``) against the
JAX package's on the CPU: the reference's ``tests/test_launch.py`` cases
(``_safe_spec``, the collective parser's sample, the cell matrix), the six
``param_logical_axes`` trees, and every cell of ``all_cells()`` built on
both production meshes by both packages' ``build_cell``, compared field by
field on abstract meshes (no process group, no devices).

The one exemption: the sampled GNN step takes its neighbour draws (int32
``[Bn*f1 + Bn*f1*f2]``) where the reference takes a ``jax.random`` key
(uint32 ``[2]``), which torch cannot use; that leaf's shape, dtype and
bytes are left out of the comparison.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

import repro.models.gnn.gat as JGAT
import repro.models.gnn.gatedgcn as JGG
import repro.models.gnn.gcn as JGCN
import repro.models.gnn.nequip as JNQ
import repro.models.recsys.bst as JBST
import repro.models.transformer as JT
from repro.configs import all_cells as j_all_cells
from repro.configs import get_spec as j_spec
from repro.launch.steps import build_cell as j_build
from repro_torch.configs import ARCH_IDS, all_cells, get_spec
from repro_torch.distributed.sharding import (
    AbstractMesh, NamedSharding, P, ShardingRules, tree_shardings,
)
from repro_torch.launch.steps import _safe_spec, arg_bytes, build_cell
from repro_torch.models import transformer as TT
from repro_torch.models.gnn import gat, gatedgcn, gcn, nequip
from repro_torch.models.recsys import bst
from repro_torch.roofline.analyze import collective_bytes
from repro_torch.tree import tree_leaves

RULES = ShardingRules()
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _j_mesh(shape, axes):
    try:
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))
    except TypeError:
        return jax.sharding.AbstractMesh(shape, axes)


def _mesh(shape=(4, 2), axes=("data", "model")):
    return AbstractMesh(shape, axes)


# ---- the reference's test_launch.py cases --------------------------------

def test_safe_spec_basic():
    mesh = _mesh()
    assert _safe_spec(mesh, RULES, ("batch", None), (8, 16)) == P("data", None)
    assert _safe_spec(mesh, RULES, ("fsdp", "mlp"), (8, 16)) == P("data", "model")


def test_safe_spec_divisibility_drop():
    mesh = _mesh()
    assert _safe_spec(mesh, RULES, ("batch",), (15,)) == P(None)
    spec = _safe_spec(mesh, RULES, ("experts", "mlp"), (3, 8))
    assert spec == P(None, "model")


def test_safe_spec_no_double_use():
    mesh = _mesh()
    assert _safe_spec(mesh, RULES, ("heads", "mlp"), (8, 8)) == P("model", None)


def test_safe_spec_multi_axis_dim():
    mesh = _mesh()
    spec = _safe_spec(mesh, RULES.with_overrides(mlp=("model", "data")),
                      ("mlp",), (16,))
    assert spec == P(("model", "data"))


def test_multi_axis_dim_takes_mesh_order():
    """The port's layout choice for a dim over several mesh axes: DTensor
    placements in mesh order (Shard on each), the reference's per-device
    shard shape."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh()
    sh = NamedSharding(mesh, P(("model", "data"), None))
    assert sh.placements() == (Shard(0), Shard(0))
    assert sh.shard_shape((16, 3)) == (2, 3)
    assert NamedSharding(mesh, P(None, "model")).placements() == (
        Replicate(), Shard(1))


def test_size_one_axis_replicates():
    """A mesh dim of size 1 replicates whatever the spec names (the
    spec stays the reference's)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh((1, 2))
    spec = _safe_spec(mesh, RULES, ("batch", "mlp"), (4, 8))
    assert spec == P("data", "model")
    assert NamedSharding(mesh, spec).placements() == (Replicate(), Shard(1))


def test_collective_bytes_records():
    """The reference's HLO sample as the port's records of the same ops:
    the all-gather-done, the iota and a wait are not collectives."""
    records = [
        dict(kind="all-gather", shape=(128, 256), dtype=torch.bfloat16),
        ("all-reduce", (64,), "float32"),
        dict(kind="collective-permute", shape=(4,), dtype="float32"),
        dict(kind="wait", shape=(128, 256), dtype="bfloat16"),
        ("iota", (2,), torch.int32),
    ]
    out = collective_bytes(records)
    assert out["all-gather"] == 128 * 256 * 2
    assert out["all-reduce"] == 64 * 4
    assert out["collective-permute"] == 16
    assert out["reduce-scatter"] == out["all-to-all"] == 0
    assert out["total"] == 128 * 256 * 2 + 256 + 16
    assert out["n_ops"] == {"all-gather": 1, "all-reduce": 1,
                            "collective-permute": 1}


def test_all_cells_matrix():
    cells = all_cells()
    assert len(cells) == 40
    skips = [c for c in cells if c[2] is not None]
    assert len(skips) == 3
    assert all(s == "long_500k" for _, s, _ in skips)
    assert cells == j_all_cells()
    assert all_cells(include_graph=True) == j_all_cells(include_graph=True)


def test_tree_shardings_resolves_each_leaf():
    mesh = _mesh()
    tree = tree_shardings(mesh, dict(w=("fsdp", "mlp"), b=[(None,)]))
    assert tree == dict(w=NamedSharding(mesh, P("data", "model")),
                        b=[NamedSharding(mesh, P(None))])


# ---- param_logical_axes ---------------------------------------------------

AXES = [
    ("lm", TT.param_logical_axes, JT.param_logical_axes),
    ("gcn", gcn.param_logical_axes, JGCN.param_logical_axes),
    ("gat", gat.param_logical_axes, JGAT.param_logical_axes),
    ("gatedgcn", gatedgcn.param_logical_axes, JGG.param_logical_axes),
    ("nequip", nequip.param_logical_axes, JNQ.param_logical_axes),
    ("bst", bst.param_logical_axes, JBST.param_logical_axes),
]
FAMILY = {"gcn-cora": "gcn", "gat-cora": "gat", "gatedgcn": "gatedgcn",
          "nequip": "nequip", "bst": "bst"}


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "louvain"])
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_param_logical_axes_equal_reference(arch, which):
    kind = FAMILY.get(arch, "lm")
    port, ref = next((p, r) for k, p, r in AXES if k == kind)
    assert port(getattr(get_spec(arch), which)) == ref(
        getattr(j_spec(arch), which))


# ---- build_cell, cell by cell ---------------------------------------------

def _cells():
    return [(a, s) for a, s, skip in all_cells(include_graph=True)
            if skip is None]


def _dtype_name(dt) -> str:
    return np.dtype(dt).name if not isinstance(dt, torch.dtype) else \
        str(dt).split(".")[-1]


def _spec(sh) -> tuple:
    return tuple(sh.spec)


def _pad(a, b):
    n = max(len(a), len(b))
    return a + (None,) * (n - len(a)), b + (None,) * (n - len(b))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", _cells())
def test_build_cell_matches_reference(arch, shape, mesh_name):
    dims, axes = MESHES[mesh_name]
    jp = j_build(j_spec(arch), shape, _j_mesh(dims, axes))
    tp = build_cell(get_spec(arch), shape, AbstractMesh(dims, axes))
    assert (tp.step_name, tp.model_flops) == (jp.step_name, jp.model_flops)
    if arch == "louvain":
        return
    assert tuple(tp.donate) == tuple(jp.donate)
    j_args, t_args = jax.tree.leaves(jp.args), tree_leaves(tp.args)
    j_in = jax.tree.leaves(jp.in_shardings)
    assert len(j_args) == len(t_args) == len(j_in)
    draws = None
    if get_spec(arch).shapes[shape]["kind"] == "sampled":
        # the exempt leaf: the draws where the reference takes a key; it is
        # the third argument, after the parameters and the optimiser state
        draws = len(tree_leaves(tp.args[:2]))
        assert j_args[draws].shape == (2,) and t_args[draws].dtype == \
            torch.int32
    for i, (j, t) in enumerate(zip(j_args, t_args)):
        if i != draws:
            assert (tuple(j.shape), _dtype_name(j.dtype)) == (
                tuple(t.shape), _dtype_name(t.dtype)), i
    for J, T in ((jp.in_shardings, tp.in_shardings),
                 (jp.out_shardings, tp.out_shardings)):
        js, ts = jax.tree.leaves(J), tree_leaves(T)
        assert len(js) == len(ts)
        for i, (j, t) in enumerate(zip(js, ts)):
            a, b = _pad(tuple(j.spec), _spec(t))
            assert a == b, (i, j.spec, t.spec)
    want = sum(int(np.prod(sh.shard_shape(j.shape)))
               * np.dtype(j.dtype).itemsize
               for i, (j, sh) in enumerate(zip(j_args, j_in)) if i != draws)
    got = arg_bytes(tp)
    if draws is not None:
        got -= t_args[draws].nbytes
    assert got == want
