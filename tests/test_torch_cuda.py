"""Tests of the port that need a CUDA card (marker ``cuda``).

They skip where there is no card; on one, run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports no jax, so it runs where only PyTorch is installed: the
kernel is held against its plain version (f32 sums against the plain
version on a CPU copy, since CUDA's ``index_add_`` folds in no fixed
order), and ``detect()`` on the card against ``detect()`` on the CPU.
Exact comparisons throughout.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import detect
from repro_torch.graph import rmat_graph, sbm_graph
from repro_torch.kernels import ops, ref
from repro_torch.kernels.segsum import segreduce_sorted_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_kernel_equals_plain(cuda, op, dtype, d):
    rng = np.random.default_rng(d)
    m, nseg = 20_000, 700
    ids = np.sort(rng.integers(0, nseg, m)).astype(np.int32)
    ids[5000:9000] = ids[5000]                     # one long segment
    ids = np.sort(ids)
    if dtype == torch.float32:
        v = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    else:
        v = torch.from_numpy(rng.integers(-999, 999, (m, d)).astype(np.int32))
    ids_t = torch.from_numpy(ids)
    before = segreduce_sorted_cuda.launches
    got = ops.segreduce_sorted(v.to(cuda), ids_t.to(cuda), nseg + 5,
                               op=op).cpu()
    assert segreduce_sorted_cuda.launches == before + 1
    want = ref.segreduce_sorted_ref(v, ids_t, nseg + 5, op=op)
    assert torch.equal(got, want)


def test_kernel_wrapper_validates_on_card(cuda):
    v = torch.zeros((4, 2), device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        segreduce_sorted_cuda(v.t(), ids, 2)       # not contiguous
    with pytest.raises(ValueError):
        segreduce_sorted_cuda(v, ids[:3], 2)
    out = segreduce_sorted_cuda(v, ids, 0)
    assert out.shape == (0, 2)


@pytest.mark.parametrize("make", [
    lambda d: rmat_graph(scale=10, edge_factor=8, seed=3, device=d),
    lambda d: sbm_graph(512, 8, 0.2, 0.004, seed=1, device=d)[0],
])
def test_detect_card_equals_cpu(cuda, make):
    on_card = detect(make(cuda))
    on_cpu = detect(make("cpu"), device="cpu")
    assert torch.equal(on_card.labels.cpu(), on_cpu.labels)
    assert on_card.n_disconnected == on_cpu.n_disconnected == 0
    assert on_card.stats == on_cpu.stats
