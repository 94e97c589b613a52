"""The port's segment primitives held bit for bit against the JAX package.

``repro_torch.kernels.ops.segreduce_sorted`` on a CPU tensor runs the plain
version of the CUDA kernel (``kernels/ref.py``); it must fold every segment
in index order, exactly as the reference's Pallas kernel (run in interpret
mode, as ``tests/test_seg_backend.py`` runs it) and its XLA path do.  The
cases are those of ``tests/test_seg_backend.py``: ragged runs, multichannel
and int32 payloads, empty and tail segments, the in-order fold.  Inputs are
made with numpy from a seed.  Tolerance: none — every comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import _segments as jseg
from repro.core.local_move import _hash_parity as j_hash_parity
from repro.kernels import ops as jops
from repro.kernels.segsum import segscan_blocked
from repro_torch.core import _segments as tseg
from repro_torch.core.local_move import _hash_parity as t_hash_parity
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import _build
from repro_torch.kernels.segsum import segreduce_sorted_cuda

J_IMPLS = ("pallas", "xla")


def _assert_matches_reference(values, ids, nseg, op, block_m=64):
    got = tops.segreduce_sorted(torch.from_numpy(values),
                                torch.from_numpy(ids), nseg, op=op).numpy()
    for impl in J_IMPLS:
        want = np.asarray(jops.segreduce_sorted(
            jnp.asarray(values), jnp.asarray(ids), nseg, op=op, impl=impl,
            block_m=block_m))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(
            got, want, err_msg=f"op={op} impl={impl} not bit-identical")


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("seed,block_m", [(0, 16), (1, 64), (2, 512),
                                          (3, 64)])
def test_segreduce_ragged_runs(op, seed, block_m):
    """Many short runs, some long, empty segments interleaved.  Shapes are
    fixed so the reference compiles once per (op, block_m)."""
    rng = np.random.default_rng(seed)
    m, nseg = 397, 53
    ids = np.sort(rng.integers(0, nseg, m) ** 2 // nseg).astype(np.int32)
    v = rng.normal(size=m).astype(np.float32)
    _assert_matches_reference(v, ids, nseg, op, block_m=block_m)


@pytest.mark.parametrize("seed", range(2))
def test_segreduce_multichannel_and_int(seed):
    """2-channel f32 (the fused sweep's pass-A layout), int32 D=1 and D=2."""
    rng = np.random.default_rng(100 + seed)
    m, nseg = 150, 20
    ids = np.sort(rng.integers(0, nseg, m)).astype(np.int32)
    vf = rng.normal(size=(m, 2)).astype(np.float32)
    vi = rng.integers(-99, 99, m).astype(np.int32)
    vi2 = rng.integers(-99, 99, (m, 2)).astype(np.int32)
    for op in ("sum", "max", "min"):
        _assert_matches_reference(vf, ids, nseg, op)
        _assert_matches_reference(vi, ids, nseg, op)
        _assert_matches_reference(vi2, ids, nseg, op)


def test_segreduce_empty_and_tail_segments():
    """Empty heads and tails take the jax.ops.segment_* fills."""
    ids = np.array([3, 3, 3, 3, 7], np.int32)
    v = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    for op in ("sum", "max", "min"):
        _assert_matches_reference(v, ids, 10, op, block_m=2)
        _assert_matches_reference(v.astype(np.int32), ids, 10, op, block_m=2)
    out = tops.segreduce_sorted(torch.from_numpy(v), torch.from_numpy(ids),
                                10, op="max")
    assert out[0] == -np.inf and out[9] == -np.inf
    assert out[3] == 4.0 and out[7] == 5.0
    imin = tops.segreduce_sorted(torch.from_numpy(v.astype(np.int32)),
                                 torch.from_numpy(ids), 10, op="min")
    assert int(imin[0]) == np.iinfo(np.int32).max


def test_segreduce_inorder_fold():
    """The in-order case of the reference's test_segscan_inorder_fold: each
    segment's value is the strict float32 left fold of its rows, equal to
    the Pallas scan's running value at the segment's last row."""
    rng = np.random.default_rng(7)
    m = 96
    x = rng.normal(size=(m, 1)).astype(np.float32)
    starts = np.zeros(m, np.int32)
    starts[[0, 5, 6, 40, 80]] = 1
    ids = (np.cumsum(starts) - 1).astype(np.int32)
    got = tops.segreduce_sorted(torch.from_numpy(x), torch.from_numpy(ids),
                                5, op="sum").numpy()[:, 0]
    scan = np.asarray(segscan_blocked(jnp.asarray(x), jnp.asarray(starts),
                                      op="sum", block_m=32))[:, 0]
    last = np.r_[np.flatnonzero(starts)[1:] - 1, m - 1]
    np.testing.assert_array_equal(got, scan[last])
    fold = []
    for i in range(m):
        acc = np.float32(x[i, 0]) if starts[i] else np.float32(acc + x[i, 0])
        if i == m - 1 or starts[i + 1]:
            fold.append(acc)
    np.testing.assert_array_equal(got, np.array(fold, np.float32))
    _assert_matches_reference(x, ids, 5, "sum", block_m=32)


def test_segreduce_large_sums_fold_in_order():
    """Long f32 runs with mixed magnitudes, where any other order rounds
    differently: the plain version equals a sequential numpy fold."""
    rng = np.random.default_rng(11)
    m, nseg = 50_000, 7
    ids = np.sort(rng.integers(0, nseg, m)).astype(np.int32)
    v = (rng.normal(size=(m, 2)) * 10.0 ** rng.integers(-3, 4, (m, 2))
         ).astype(np.float32)
    want = np.zeros((nseg, 2), np.float32)
    np.add.at(want, ids, v)                 # unbuffered, in index order
    got = tref.segreduce_sorted_ref(torch.from_numpy(v),
                                    torch.from_numpy(ids), nseg).numpy()
    np.testing.assert_array_equal(got, want)
    _assert_matches_reference(v, ids, nseg, "sum", block_m=512)


@pytest.mark.parametrize("seed", range(3))
def test_segment_sum_inorder_matches_unsorted_scatter(seed):
    """The Sigma-recompute formulation (stable sort + sorted segment sum)
    equals the reference's unsorted in-order jax.ops.segment_sum."""
    rng = np.random.default_rng(seed)
    n, nseg = 3000, 50
    ids = rng.integers(0, nseg, n).astype(np.int32)
    v = (rng.integers(1, 9, n) * rng.random(n)).astype(np.float32)
    got = tops.segment_sum_inorder(torch.from_numpy(v),
                                   torch.from_numpy(ids), nseg).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(ids),
                                          num_segments=nseg))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("it", [0, 1, 2, 7, 19, 2**20 + 3])
def test_hash_parity_equal(it):
    rng = np.random.default_rng(it % 97)
    ids = np.concatenate([
        np.arange(4096), rng.integers(0, 2**31 - 1, 4096),
        [2**31 - 1, 2**31 - 2, 2**16, 2**16 - 1]]).astype(np.int32)
    got = t_hash_parity(torch.from_numpy(ids), it).numpy()
    want = np.asarray(j_hash_parity(jnp.asarray(ids), jnp.int32(it)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_sort_runs_and_run_ids_equal():
    rng = np.random.default_rng(3)
    m, nv = 4000, 300
    k1 = rng.integers(0, nv, m).astype(np.int32)
    k2 = rng.integers(0, nv, m).astype(np.int32)
    k2[::7] = nv - 1                        # many ties, stable order matters
    t_out = tseg.sort_runs(torch.from_numpy(k1), torch.from_numpy(k2))
    j_out = jseg.sort_runs(jnp.asarray(k1), jnp.asarray(k2))
    for name, a, b in zip(("k1", "k2", "perm"), t_out, j_out):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    w = rng.random(m).astype(np.float32)
    t_sorted = tseg.sort_by_key2(torch.from_numpy(k1), torch.from_numpy(k2),
                                 torch.from_numpy(w))
    j_sorted = jseg.sort_by_key2(jnp.asarray(k1), jnp.asarray(k2),
                                 jnp.asarray(w))
    for a, b in zip(t_sorted, j_sorted):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    starts_t = tseg.run_starts(t_out[0], t_out[1])
    starts_j = jseg.run_starts(j_out[0], j_out[1])
    np.testing.assert_array_equal(starts_t.numpy(), np.asarray(starts_j))
    rid_t = tseg.run_ids(starts_t)
    assert rid_t.dtype == torch.int32
    np.testing.assert_array_equal(rid_t.numpy(),
                                  np.asarray(jseg.run_ids(starts_j)))
    for fill in (nv - 1, -1):
        f_t, v_t = tseg.run_field(t_out[0], starts_t, rid_t, m, fill)
        f_j, v_j = jseg.run_field(j_out[0], starts_j,
                                  jseg.run_ids(starts_j), m, fill)
        np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("seed", range(3))
def test_renumber_and_count_equal(seed):
    rng = np.random.default_rng(seed)
    nv = 257
    labels = rng.integers(0, nv - 1, nv).astype(np.int32)
    n_nodes = int(rng.integers(1, nv))
    valid = np.arange(nv) < n_nodes
    d_t, n_t = tseg.renumber(torch.from_numpy(labels),
                             torch.from_numpy(valid), nv)
    d_j, n_j = jseg.renumber(jnp.asarray(labels), jnp.asarray(valid), nv)
    assert d_t.dtype == torch.int32 and n_t.dtype == torch.int32
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert int(n_t) == int(n_j)
    assert int(tseg.count_communities(torch.from_numpy(labels),
                                      torch.from_numpy(valid), nv)) == int(
        jseg.count_communities(jnp.asarray(labels), jnp.asarray(valid), nv))


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    """The wrapper validates before it builds or launches anything."""
    ids = torch.zeros(4, dtype=torch.int32)
    v = torch.zeros((4, 1))
    with pytest.raises(ValueError, match="CUDA"):
        segreduce_sorted_cuda(v, ids, 2)
    with pytest.raises(TypeError):
        segreduce_sorted_cuda(v.double(), ids, 2)
    with pytest.raises(TypeError):
        segreduce_sorted_cuda(v, ids.long(), 2)
    with pytest.raises(ValueError):
        segreduce_sorted_cuda(v, ids, 2, op="mean")
    assert segreduce_sorted_cuda.launches == 0


def test_build_is_keyed_by_source_hash():
    path = _build.library_path("segreduce")
    assert path.name == "libsegreduce.so"
    assert path.parent.parent == _build.BUILD_ROOT
    assert set(_build.SOURCES) == {
        p.stem for p in _build.CSRC.glob("*.cu")}
