"""The port's collective wrappers (``repro_torch.distributed.collectives``)
on the CPU: the identity without a group, and on meshes of 2 and 3 CPU
ranks over gloo (``launch/mesh.py``, one worker process a rank) equal to
numpy bit for bit for int32 and float32 sums, mins and maxes, with the
caller's tensor unchanged.  A float sum of disjoint-support vectors
returns each owner's value exactly, which the sharded driver leans on.

The meshes start once a module (a few seconds: spawn, import torch, join
the group) and every call has its own limit (``Mesh.run``'s timeout).
"""
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

import _torch_mesh_jobs as jobs
from repro_torch.distributed import collectives as col
from repro_torch.launch import make_host_mesh

CALL_S = 60.0          # each mesh call's own limit


@pytest.fixture(scope="module")
def meshes():
    ms = {n: make_host_mesh(n, device="cpu") for n in (2, 3)}
    yield ms
    for m in ms.values():
        m.close()


@pytest.mark.parametrize("fn", [col.psum, col.pmin, col.pmax])
def test_identity_without_a_group(fn):
    x = torch.arange(5, dtype=torch.float32)
    assert fn(x) is x
    assert col.all_gather(x) is x
    assert col.axis_size() == 1


def test_wrappers_refuse_other_dtypes():
    with pytest.raises(TypeError, match="int32 or float32"):
        col.all_reduce(torch.zeros(3, dtype=torch.int64), "sum", None)


def _values(n, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return [rng.integers(-2**20, 2**20, 37).astype(np.int32)
                for _ in range(n)]
    return [rng.normal(size=37).astype(np.float32) for _ in range(n)]


def _want(values, op):
    if op == "sum":
        out = values[0].copy()
        for v in values[1:]:
            out = out + v
        return out
    return (np.minimum if op == "min" else np.maximum).reduce(values)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32],
                         ids=["int32", "float32"])
@pytest.mark.parametrize("n", [2, 3])
def test_reduce_equals_numpy(meshes, n, dtype, op):
    values = _values(n, dtype, seed=n)
    if dtype == np.float32 and op == "sum" and n == 3:
        # three float addends: make every partial sum exact, so any order
        # of the ring gives numpy's bits
        values = [np.round(v * 64).astype(np.float32) for v in values]
    got = meshes[n].run(jobs.reduce_each, values, op, timeout=CALL_S)
    want = _want(values, op)
    for r, out in enumerate(got):
        assert out["out"].dtype == dtype
        np.testing.assert_array_equal(out["out"].view(np.int32),
                                      want.view(np.int32), err_msg=f"rank {r}")
        assert out["unchanged"] and not out["same_object"]
        assert out["calls"] == 1 and out["bytes"] == 37 * 4
        assert out["size"] == n


@pytest.mark.timeout(120)
@pytest.mark.parametrize("n", [2, 3])
def test_disjoint_support_float_sum_is_each_owners_value(meshes, n):
    """Rank r owns the slots ``i % n == r`` and holds zeros elsewhere: the
    sum returns every owner's value bit for bit, subnormals and all."""
    rng = np.random.default_rng(7)
    full = np.concatenate([rng.normal(size=60), [1e-40, 3.4e38, 0.0]]
                          ).astype(np.float32)
    slot = np.arange(full.shape[0]) % n
    values = [np.where(slot == r, full, np.float32(0.0)).astype(np.float32)
              for r in range(n)]
    for out in meshes[n].run(jobs.reduce_each, values, "sum",
                             timeout=CALL_S):
        np.testing.assert_array_equal(out["out"].view(np.int32),
                                      full.view(np.int32))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("tiled", [True, False])
def test_all_gather_in_rank_order(meshes, tiled):
    values = _values(3, np.int32, seed=4)
    want = (np.concatenate if tiled else np.stack)(values)
    for out in meshes[3].run(jobs.gather_each, values, tiled,
                             timeout=CALL_S):
        np.testing.assert_array_equal(out, want)


@pytest.mark.timeout(120)
def test_cpu_ranks_run_one_thread_each(meshes):
    got = meshes[2].run(jobs.where_am_i, timeout=CALL_S)
    assert [g["rank"] for g in got] == [0, 1]
    assert all(g["size"] == 2 and g["device"] == "cpu" and g["threads"] == 1
               for g in got)
    assert meshes[2].backend == "gloo"
