"""The checkpoint store of the PyTorch port (``repro_torch.checkpoint``)
held against the JAX package's ``repro.checkpoint``, on the CPU.

The cases of tests/test_checkpoint.py on torch trees, then the shared file
format: a directory written by either package reads in the other, with
float32, float64, int32, int64 and bool leaves equal bit for bit and the
same manifest; a bfloat16 leaf round trip (stored as its 16 bits); a
truncated ``arrays.npz`` raising ``CheckpointCorrupt``; and ``device=``
restore.

``test_elastic_restore_with_shardings`` has no counterpart here: it
restores onto JAX shardings, and the port's sharding comes with ROADMAP
A.12.  Restore takes one ``device`` instead.
"""
import json
import os

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

from repro import checkpoint as jck
from repro.checkpoint import store as jstore
from repro_torch.checkpoint import (
    CheckpointCorrupt, CheckpointManager, checkpoint_steps, latest_step,
    load_checkpoint_arrays, restore_checkpoint, save_checkpoint,
)


def _tree(v=0.0):
    return dict(
        params=dict(w=torch.full((4, 3), 1.0 + v), b=torch.zeros(3)),
        opt=dict(m=torch.full((4, 3), 2.0 + v),
                 step=torch.tensor(7, dtype=torch.int32)),
    )


# ---------------------------------------------------------------------------
# the cases of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, _tree(1.0))
    restored, step = restore_checkpoint(d, _tree())
    assert step == 3
    np.testing.assert_allclose(restored["params"]["w"].numpy(), 2.0)
    assert int(restored["opt"]["step"]) == 7
    assert restored["opt"]["step"].dtype == torch.int32


def test_latest_and_retention(tmp_path):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, keep=2, async_save=False)
    for s in [1, 5, 9]:
        mgr.save(s, _tree(float(s)))
    assert latest_step(d) == 9
    steps = sorted(int(x.split("-")[1]) for x in os.listdir(d))
    assert steps == [5, 9] == checkpoint_steps(d)


def test_async_save(tmp_path):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, keep=3, async_save=True)
    tree = _tree(0.5)
    mgr.save(1, tree)
    tree["params"]["w"].fill_(-1.0)       # the save copied the leaves first
    mgr.wait()
    restored, step = mgr.restore_latest(_tree())
    assert step == 1
    np.testing.assert_allclose(restored["params"]["w"].numpy(), 1.5)


def test_tree_mismatch_raises(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 0, _tree())
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(d, dict(other=torch.zeros(3)))


def test_missing_dir_returns_none(tmp_path):
    restored, step = restore_checkpoint(str(tmp_path / "nope"), _tree())
    assert restored is None and step is None
    assert load_checkpoint_arrays(str(tmp_path / "nope")) == (None, None,
                                                             None)


# ---------------------------------------------------------------------------
# one file format for both packages
# ---------------------------------------------------------------------------

def _numpy_tree(seed=0):
    """A tree of every dtype both packages can hold, in dicts, lists,
    tuples and a ``None`` subtree, with a scalar leaf."""
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.normal(size=(5, 3)).astype(np.float32),
        "f64": rng.normal(size=7),
        "i32": rng.integers(-2**31, 2**31 - 1, 9, dtype=np.int64).astype(
            np.int32),
        "i64": rng.integers(-2**62, 2**62, (2, 4), dtype=np.int64),
        "mask": rng.random(6) < 0.5,
        "nested": [np.arange(3, dtype=np.int32),
                   (np.float32(2.5) * np.ones(2, np.float32), None)],
        "scalar": 7,
        "z": None,
    }


def _leaves_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _manifest(d, step):
    with open(os.path.join(d, f"step-{step:010d}", "manifest.json")) as f:
        return json.load(f)


def test_manifest_equals_the_reference(tmp_path):
    tree = _numpy_tree()
    jck.save_checkpoint(str(tmp_path / "ref"), 4, tree, extra={"k": 1})
    save_checkpoint(str(tmp_path / "port"), 4, tree, extra={"k": 1})
    assert _manifest(str(tmp_path / "port"), 4) == \
        _manifest(str(tmp_path / "ref"), 4)


def test_port_reads_the_reference(tmp_path):
    d = str(tmp_path / "ck")
    tree = _numpy_tree(1)
    jck.save_checkpoint(d, 2, tree)
    like = {k: v for k, v in tree.items()}
    got, step = restore_checkpoint(d, like)
    assert step == 2
    for k in ("f32", "f64", "i32", "i64", "mask"):
        _leaves_equal(got[k], tree[k])
    _leaves_equal(got["nested"][0], tree["nested"][0])
    _leaves_equal(got["nested"][1][0], tree["nested"][1][0])
    assert got["nested"][1][1] is None and got["z"] is None
    assert int(got["scalar"]) == 7
    # into torch leaves of the same dtypes, bit for bit
    like_t = {k: torch.from_numpy(np.asarray(tree[k]))
              for k in ("f32", "f64", "i32", "i64", "mask")}
    d2 = str(tmp_path / "flat")
    jck.save_checkpoint(d2, 0, {k: tree[k] for k in like_t})
    got_t, _ = restore_checkpoint(d2, like_t)
    for k, v in got_t.items():
        assert isinstance(v, torch.Tensor) and v.dtype == like_t[k].dtype
        _leaves_equal(v.numpy(), tree[k])


def test_reference_reads_the_port(tmp_path):
    d = str(tmp_path / "ck")
    tree = _numpy_tree(2)
    torch_tree = {k: torch.from_numpy(np.asarray(tree[k]))
                  for k in ("f32", "f64", "i32", "i64", "mask")}
    save_checkpoint(d, 6, torch_tree)
    got, step = jstore.restore_checkpoint(
        d, {k: tree[k] for k in torch_tree})
    assert step == 6
    for k in torch_tree:
        _leaves_equal(got[k], tree[k])
    arrays, extra, step = jstore.load_checkpoint_arrays(d)
    assert step == 6 and extra == {} and sorted(arrays) == sorted(torch_tree)
    for k in torch_tree:
        _leaves_equal(arrays[k], tree[k])


def test_load_arrays_names_equal_the_reference(tmp_path):
    tree = _numpy_tree(3)
    jck.save_checkpoint(str(tmp_path / "ref"), 0, tree, extra={"a": [1]})
    save_checkpoint(str(tmp_path / "port"), 0, tree, extra={"a": [1]})
    ra, rx, rs = jstore.load_checkpoint_arrays(str(tmp_path / "ref"))
    pa, px, ps = load_checkpoint_arrays(str(tmp_path / "port"))
    assert (px, ps) == (rx, rs) and list(pa) == list(ra)
    for k in ra:
        _leaves_equal(pa[k], ra[k])


def test_bfloat16_round_trip(tmp_path):
    d = str(tmp_path / "ck")
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    save_checkpoint(d, 0, {"x": x, "y": torch.arange(3)})
    man = _manifest(d, 0)
    assert man["dtypes"] == ["bfloat16", "int64"]
    assert man["shapes"] == [[5, 4], [3]]
    got, _ = restore_checkpoint(d, {"x": torch.zeros(5, 4, dtype=torch.bfloat16),
                                    "y": torch.zeros(3, dtype=torch.int64)})
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))
    arrays, _, _ = load_checkpoint_arrays(d)
    assert torch.equal(arrays["x"].view(torch.int16), x.view(torch.int16))


def test_truncated_npz_raises_checkpoint_corrupt(tmp_path):
    tree = {"w": torch.arange(1000, dtype=torch.float32)}
    save_checkpoint(str(tmp_path), 1, tree)
    path = os.path.join(str(tmp_path), f"step-{1:010d}", "arrays.npz")
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(CheckpointCorrupt):
        restore_checkpoint(str(tmp_path), tree, step=1)
    with pytest.raises(CheckpointCorrupt):
        load_checkpoint_arrays(str(tmp_path), step=1)


def test_missing_manifest_raises_checkpoint_corrupt(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"w": torch.ones(3)})
    os.remove(os.path.join(str(tmp_path), f"step-{0:010d}",
                           "manifest.json"))
    with pytest.raises(CheckpointCorrupt):
        restore_checkpoint(str(tmp_path), {"w": torch.ones(3)})


def test_restore_onto_a_device(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 0, {"a": np.arange(4, dtype=np.int32),
                           "b": torch.ones(2, dtype=torch.float64)})
    got, _ = restore_checkpoint(d, {"a": np.zeros(4, np.int32),
                                    "b": torch.zeros(2, dtype=torch.float64)},
                                device="cpu")
    assert isinstance(got["a"], torch.Tensor) and got["a"].dtype == torch.int32
    assert got["b"].device.type == "cpu"
    assert got["a"].tolist() == [0, 1, 2, 3]


def test_elastic_restore_with_shardings(tmp_path):
    """Restore with explicit target shardings (the reference's case): a
    one-rank gloo group on the CPU, every leaf on a ``(data,)`` mesh, as a
    NamedSharding or as a (mesh, spec) pair (a spec over the mesh's one
    rank replicates: ``NamedSharding.placements``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.tree import tree_map

    d = str(tmp_path / "ck")
    save_checkpoint(d, 2, _tree(3.0))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        sh = tree_map(lambda _: NamedSharding(mesh, P()), _tree())
        sh["opt"]["m"] = (mesh, P("data", None))
        restored, step = restore_checkpoint(d, _tree(), shardings=sh)
        assert step == 2
        w = restored["params"]["w"]
        assert isinstance(w, DTensor) and w.placements == (Replicate(),)
        assert torch.equal(w.full_tensor(), _tree(3.0)["params"]["w"])
        m = restored["opt"]["m"]
        assert isinstance(m, DTensor) and m.placements == (Replicate(),)
        assert torch.equal(m.full_tensor(), _tree(3.0)["opt"]["m"])
        assert int(restored["opt"]["step"].full_tensor()) == 7
    finally:
        dist.destroy_process_group()
