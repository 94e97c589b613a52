"""Tests of the port that need a CUDA card (marker ``cuda``).

They skip where there is no card; on one, run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports no jax, so it runs where only PyTorch is installed: the
segment-reduce kernel is held against its plain version (f32 sums against
the plain version on a CPU copy, since CUDA's ``index_add_`` folds in no
fixed order), and ``detect()`` on the card against ``detect()`` on the CPU,
exactly, for every tier and split policy (and the modularity that decides
max-quality's pick, bit for bit), with either scan, and
``update_communities`` on the card against the CPU and across scans, and
the batched engine's detect batches (one a default bucket) and update
batch on the card against the CPU.  The kernels of the kernel API are held
against their plain versions within stated bounds: float32 rounding bounds
against float64 for the sums, the reference's own tolerances for spmm and
float32 attention, and the output's bf16 rounding (``chip_smoke.py`` phase
5) for 16-bit attention, on both routes of
``kernels/flash_attn.py:tensor_core_route``.
"""
import numpy as np
import pytest
import torch
from _torch_layouts import INORDER_LAYOUTS, TILED_LAYOUTS, tiled_layout

from repro_torch.core import (DetectOptions, GraphUpdate, LouvainConfig,
                               detect, louvain_staged, modularity,
                               update_communities)
from repro_torch.core.louvain import SPLITS
from repro_torch.graph import rmat_graph, sbm_graph
from repro_torch.graph.container import strip_padding
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attn import (flash_attention_cuda,
                                            tensor_core_route)
from repro_torch.kernels.onehot_segsum import (emulate, onehot_segsum_cuda,
                                               plan_for, scratch_bytes)
from repro_torch.kernels.segsum import (cumsum_cuda, emulate_inorder,
                                       route, segreduce_sorted_cuda)
from repro_torch.kernels.spmm import bucket_spmm_cuda

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


# --- the tiled route: order-free folds at the layouts that could stall it ----

ORDER_FREE = [("max", torch.float32), ("min", torch.float32),
              ("max", torch.int32), ("min", torch.int32), ("sum", torch.int32)]


def _order_free_values(ids, d, op, dtype, seed):
    """f32: normal values with ±0 ties and ±inf, NaN in some segments (ids
    = 1 mod 3); int32: the full range for sums (so they wrap), small values
    and both extremes for max/min."""
    rng = np.random.default_rng(seed)
    m = ids.shape[0]
    if dtype == torch.float32:
        v = rng.normal(size=(m, d)).astype(np.float32)
        pick = rng.random((m, d))
        v[pick < 0.05] = -0.0
        v[(pick >= 0.05) & (pick < 0.1)] = 0.0
        v[(pick >= 0.1) & (pick < 0.12)] = np.inf
        v[(pick >= 0.12) & (pick < 0.14)] = -np.inf
        v[(pick >= 0.14) & (pick < 0.15) & (ids[:, None] % 3 == 1)] = np.nan
    elif op == "sum":
        v = rng.integers(-2**31, 2**31, (m, d), dtype=np.int64).astype(np.int32)
    else:
        v = rng.integers(-1000, 1000, (m, d)).astype(np.int32)
        v[rng.random((m, d)) < 0.01] = np.iinfo(np.int32).min
        v[rng.random((m, d)) < 0.01] = np.iinfo(np.int32).max
    return torch.from_numpy(v)


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("layout", TILED_LAYOUTS)
@pytest.mark.parametrize("op,dtype", ORDER_FREE)
@pytest.mark.parametrize("d", [1, 2, 3])
def test_tiled_kernel_equals_plain(cuda, layout, op, dtype, d):
    """The tiled route, bit for bit (NaN bits included) the plain version
    on a CPU copy, at every layout of ``_torch_layouts.tiled_layout``."""
    assert route(op, dtype) == "tiled"
    ids, nseg = tiled_layout(layout)
    v = _order_free_values(ids, d, op, dtype, seed=d)
    ids_t = torch.from_numpy(ids)
    before = segreduce_sorted_cuda.launches
    got = ops.segreduce_sorted(v.to(cuda), ids_t.to(cuda), nseg, op=op).cpu()
    assert segreduce_sorted_cuda.launches == before + 1
    want = ref.segreduce_sorted_ref(v, ids_t, nseg, op=op)
    assert _same_bits(got, want)


@pytest.mark.parametrize("op,dtype", ORDER_FREE)
def test_tiled_kernel_same_bits_twice(cuda, op, dtype):
    """Two launches on the same inputs give the same bits (the atomics on
    crossing segments are exact in any order)."""
    ids, nseg = tiled_layout("inside")
    v = _order_free_values(ids, 2, op, dtype, seed=5).to(cuda)
    ids_t = torch.from_numpy(ids).to(cuda)
    a = ops.segreduce_sorted(v, ids_t, nseg, op=op)
    b = ops.segreduce_sorted(v, ids_t, nseg, op=op)
    assert _same_bits(a.cpu(), b.cpu())


def test_tiled_kernel_signed_zero_and_nan(cuda):
    """The reference's IEEE max/min on the card: [-0, +0 | +0, -0 | 1, NaN
    | 2, NaN] gives max [+0, +0, nan, nan] and min [-0, -0, nan, nan]."""
    v = torch.tensor([-0.0, 0.0, 0.0, -0.0, 1.0, float("nan"), 2.0,
                      float("nan")])
    ids = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3], dtype=torch.int32)
    for op in ("max", "min"):
        got = ops.segreduce_sorted(v.to(cuda), ids.to(cuda), 5, op=op).cpu()
        assert _same_bits(got, ref.segreduce_sorted_ref(v, ids, 5, op=op))
        assert bool(torch.signbit(got[:2]).all()) == (op == "min")
        assert bool(torch.isnan(got[2:4]).all())


# --- the in-order route: the f32 sum, carried from tile to tile --------------

def _inorder_values(ids, d, seed, inf_nan=True):
    """float32 normal values with ±0 and subnormals mixed in, and with
    ``inf_nan`` ±inf and NaN too."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(ids.shape[0], d)).astype(np.float32)
    pick = rng.random(v.shape)
    v[pick < 0.05] = -0.0
    v[(pick >= 0.05) & (pick < 0.08)] = 0.0
    sub = (pick >= 0.2) & (pick < 0.4)
    v[sub] = (np.float32(1e-40) * rng.integers(-64, 65, v.shape))[sub]
    if inf_nan:
        v[(pick >= 0.08) & (pick < 0.09)] = np.inf
        v[(pick >= 0.09) & (pick < 0.10)] = -np.inf
        v[(pick >= 0.10) & (pick < 0.105)] = np.nan
    return torch.from_numpy(v)


def _same_bits_any_nan(a, b):
    """Equal float32 bits, NaN matching NaN of any payload (the card's
    adds give the canonical NaN, the CPU's keep an operand's payload)."""
    nan = torch.isnan(a) & torch.isnan(b)
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | nan).all())


@pytest.mark.parametrize("layout", INORDER_LAYOUTS)
@pytest.mark.parametrize("d", [1, 2, 3])
def test_inorder_kernel_equals_plain(cuda, layout, d):
    """The in-order route, bit for bit the plain version's left fold on a
    CPU copy, at every layout and the multi-tile hub; two launches give the
    same bits, each counted once."""
    assert route("sum", torch.float32) == "in-order"
    ids, nseg = tiled_layout(layout)
    v = _inorder_values(ids, d, seed=d)
    ids_t = torch.from_numpy(ids)
    vc, ic = v.to(cuda), ids_t.to(cuda)
    before = segreduce_sorted_cuda.launches
    a = ops.segreduce_sorted(vc, ic, nseg, op="sum").cpu()
    b = ops.segreduce_sorted(vc, ic, nseg, op="sum").cpu()
    assert segreduce_sorted_cuda.launches == before + 2
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    want = ref.segreduce_sorted_ref(v, ids_t, nseg, op="sum")
    assert _same_bits_any_nan(a, want)


def test_inorder_kernel_finite_bits_exact(cuda):
    """Without inf or NaN, every bit is the plain version's and the plan
    emulation's (``segsum.emulate_inorder``), subnormals and ±0 included;
    a segment of -0.0 rows sums to +0.0."""
    ids, nseg = tiled_layout("hub")
    ids = np.concatenate([np.zeros(5, np.int32), ids + 1])
    v = _inorder_values(ids, 2, seed=4, inf_nan=False)
    v[:5] = -0.0
    ids_t = torch.from_numpy(ids)
    got = ops.segreduce_sorted(v.to(cuda), ids_t.to(cuda), nseg + 1).cpu()
    for want in (ref.segreduce_sorted_ref(v, ids_t, nseg + 1),
                 emulate_inorder(v, ids, nseg + 1)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not bool(torch.signbit(got[0]).any())


def test_sum_inorder_card_equals_cpu(cuda):
    """``ops.sum_inorder`` gives the same bits on the card and on the CPU."""
    x = torch.from_numpy((np.random.default_rng(3).normal(size=300_001) *
                          1e3).astype(np.float32))
    assert torch.equal(ops.sum_inorder(x.to(cuda)).cpu().view(torch.int32),
                       ops.sum_inorder(x).view(torch.int32))


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


SMALL_GRAPHS = {
    "rmat10": lambda d: rmat_graph(scale=10, edge_factor=8, seed=3, device=d),
    "sbm512": lambda d: sbm_graph(512, 8, 0.2, 0.004, seed=1, device=d)[0],
}
TIER_RUNS = [("standard", s) for s in SPLITS] + [("fast", "sp-pj"),
                                                 ("max-quality", "sp-pj")]


@pytest.mark.parametrize("algorithm,split", TIER_RUNS,
                         ids=[f"{a}-{s}" for a, s in TIER_RUNS])
@pytest.mark.parametrize("graph", sorted(SMALL_GRAPHS))
def test_tier_and_split_card_equals_cpu(cuda, graph, algorithm, split):
    """Every tier and split policy gives the CPU's labels on the card."""
    opts = DetectOptions(algorithm=algorithm,
                         louvain=LouvainConfig(split=split))
    on_card = detect(SMALL_GRAPHS[graph](cuda), options=opts)
    on_cpu = detect(SMALL_GRAPHS[graph]("cpu"), options=opts, device="cpu")
    assert torch.equal(on_card.labels.cpu(), on_cpu.labels)
    assert on_card.stats == on_cpu.stats
    assert on_card.n_disconnected == on_cpu.n_disconnected
    assert on_card.modularity == on_cpu.modularity


@pytest.mark.parametrize("graph", sorted(SMALL_GRAPHS))
def test_louvain_staged_card_equals_cpu(cuda, graph):
    C_card, st_card = louvain_staged(SMALL_GRAPHS[graph](cuda))
    C_cpu, st_cpu = louvain_staged(SMALL_GRAPHS[graph]("cpu"), device="cpu")
    assert torch.equal(C_card.cpu(), C_cpu)
    assert st_card["passes"] == st_cpu["passes"] == \
        len(st_card["pass_seconds"])


@pytest.mark.parametrize("graph", sorted(SMALL_GRAPHS))
def test_modularity_card_equals_cpu(cuda, graph):
    """Q, which decides max-quality's pick, has the same bits on the card
    and on the CPU, for its own labels and for labels drawn at random."""
    g = SMALL_GRAPHS[graph]("cpu")
    live = strip_padding(g.src, g.dst, g.w, g.ghost)
    labels = detect(g, device="cpu").labels
    rand = torch.from_numpy(np.random.default_rng(0).integers(
        0, 40, g.nv).astype(np.int32))
    for C in (labels, rand):
        q_cpu = modularity(*live, C)
        q_card = modularity(*(t.to(cuda) for t in live), C.to(cuda)).cpu()
        assert torch.equal(q_card.view(torch.int32), q_cpu.view(torch.int32))


@pytest.mark.parametrize("algorithm,split", TIER_RUNS,
                         ids=[f"{a}-{s}" for a, s in TIER_RUNS])
def test_dense_scan_card_equals_cpu_and_sort(cuda, algorithm, split):
    """``scan='dense'`` on the card gives the CPU's dense result and the
    card's sortscan result, labels, stats and Q bits."""
    make = SMALL_GRAPHS["sbm512"]

    def run(scan, device):
        return detect(make(device), device=device, options=DetectOptions(
            algorithm=algorithm, scan=scan,
            louvain=LouvainConfig(split=split)))

    dense, on_cpu, sort = run("dense", cuda), run("dense", "cpu"), \
        run("sort", cuda)
    for other in (on_cpu, sort):
        assert torch.equal(dense.labels.cpu(), other.labels.cpu())
        assert dense.stats == other.stats
        assert dense.n_disconnected == other.n_disconnected
        assert dense.modularity == other.modularity


def _churn_update(g_cpu, seed):
    """A seeded batch: 4 removals, 2 additions wired to survivors, 8
    deletions of surviving edges and 8 insertions (ids after the rewrite)."""
    rng = np.random.default_rng(seed)
    n = int(g_cpu.n_nodes)
    src, dst, w = g_cpu.src.numpy(), g_cpu.dst.numpy(), g_cpu.w.numpy()
    rem = np.sort(rng.choice(n, 4, replace=False))
    perm = np.full(g_cpu.nv, -1)
    keep = np.setdiff1d(np.arange(n), rem)
    perm[keep] = np.arange(keep.size)
    ok = (src < g_cpu.n_cap) & (src < dst) & (perm[src] >= 0) & \
        (perm[dst] >= 0)
    idx = rng.choice(np.flatnonzero(ok), 8, replace=False)
    n2 = keep.size + 2
    u = np.concatenate([perm[src[idx]], [n2 - 2, n2 - 1],
                        rng.integers(0, n2 - 2, 8)])
    v = np.concatenate([perm[dst[idx]], rng.integers(0, n2 - 2, 2),
                        rng.integers(0, n2 - 2, 8)])
    dw = np.concatenate([-w[idx], np.ones(10)]).astype(np.float32)
    return GraphUpdate(u=u, v=v, dw=dw, add=2, remove=rem)


@pytest.mark.parametrize("scan", ["sort", "dense"])
@pytest.mark.parametrize("graph", sorted(SMALL_GRAPHS))
def test_update_communities_card_equals_cpu(cuda, graph, scan):
    """One churn batch: card and CPU, and either scan, give the same graph,
    labels and stats (Q bits included), with no disconnected community."""
    g_card, g_cpu = SMALL_GRAPHS[graph](cuda), SMALL_GRAPHS[graph]("cpu")
    labels = detect(g_cpu, device="cpu").labels
    upd = _churn_update(g_cpu, 3)
    before = segreduce_sorted_cuda.launches
    gc, Cc, sc = update_communities(g_card, labels.to(cuda), upd, scan=scan)
    assert segreduce_sorted_cuda.launches > before
    gh, Ch, sh = update_communities(g_cpu, labels, upd, scan=scan,
                                    device="cpu")
    gs, Cs, ss = update_communities(g_card, labels.to(cuda), upd,
                                    scan="sort")
    for name in ("src", "dst", "w", "n_nodes"):
        assert torch.equal(getattr(gc, name).cpu(), getattr(gh, name))
        assert torch.equal(getattr(gc, name), getattr(gs, name))
    assert torch.equal(Cc.cpu(), Ch) and torch.equal(Cc, Cs)
    assert sc == sh == ss
    assert sc["n_disconnected"] == 0 and sc["n_removed"] == 4


# --- the kernel API: cumsum, segsum, spmm, flash attention --------------------

def _f64_prefix_bound(x):
    """The float32 rounding bound of csrc/cumsum.cu: depth * 2^-24 * the
    prefix of |x|, with depth 64 + ceil(M / 2^20) (see the source)."""
    depth = 64 + -(-x.shape[0] // 2**20)
    return depth * 2.0**-24 * torch.cumsum(x.double().abs(), 0)


# the kernel's tiles: 8192 elements of the flat [M*D] array for D in
# {1, 2, 4}, 128 rows for any other D (csrc/cumsum.cu); each at its edge and
# one row either side, and about 3M rows, so that thousands of tiles look back
CUMSUM_SHAPES = [(1, 1), (4097, 1), (100_000, 2), (9000, 3), (5000, 33)] + [
    (8192 // d + off, d) for d in (1, 2, 4) for off in (-1, 0, 1)] + [
    (128 + off, 3) for off in (-1, 0, 1)] + [
    (3_000_001, d) for d in (1, 2, 3, 4)]


@pytest.mark.parametrize("m,d", CUMSUM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cumsum_kernel(cuda, m, d, dtype):
    x = torch.from_numpy(np.random.default_rng(m).normal(size=(m, d))
                         .astype(np.float32)).to(dtype)
    before = cumsum_cuda.launches
    got = ops.cumsum(x.to(cuda)).cpu()
    assert cumsum_cuda.launches == before + 1
    assert got.dtype == torch.float32
    want = torch.cumsum(x.double(), 0)
    assert bool(((got.double() - want).abs()
                 <= _f64_prefix_bound(x) + 1e-30).all())


def test_cumsum_kernel_back_to_back(cuda):
    """20 launches in a row on one stream, each on its own zeroed status
    words and each within the bound; then an input that starts 4 bytes
    past a 16-byte boundary (scalar loads, the same tiles)."""
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.normal(size=(1_000_003, 2)).astype(np.float32))
    xs = x.to(cuda)
    before = cumsum_cuda.launches
    outs = [ops.cumsum(xs) for _ in range(20)]
    assert cumsum_cuda.launches == before + 20
    want = torch.cumsum(x.double(), 0)
    bound = _f64_prefix_bound(x) + 1e-30
    for got in outs:
        assert bool(((got.cpu().double() - want).abs() <= bound).all())
    flat = torch.from_numpy(rng.normal(size=500_001).astype(np.float32))
    shifted = flat.to(cuda)[1:]
    assert shifted.data_ptr() % 16 == 4
    got = ops.cumsum(shifted).cpu()
    assert bool(((got.double() - torch.cumsum(flat[1:].double(), 0)).abs()
                 <= _f64_prefix_bound(flat[1:]) + 1e-30).all())


def test_segsum_sorted_on_card(cuda):
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(np.sort(rng.integers(0, 300, 50_000))
                           .astype(np.int32))
    x = torch.from_numpy(rng.normal(size=(50_000, 2)).astype(np.float32))
    got = ops.segsum_sorted(x.to(cuda), ids.to(cuda), 310).cpu()
    want = ref.segsum_sorted_ref(x.double(), ids, 310)
    # each segment: the prefix bounds at its end and start rows, and one
    # rounding of the difference
    ends = torch.cat([torch.zeros((1, 2), dtype=torch.float64),
                      _f64_prefix_bound(x)])
    b = torch.searchsorted(ids, torch.arange(311, dtype=torch.int32))
    t = ends[b[1:]] + ends[b[:-1]]
    bound = t + 2.0**-24 * (want.abs() + t)
    assert bool(((got.double() - want).abs() <= bound).all())


@pytest.mark.parametrize("n,nseg,d", [(1, 1, 1), (70_000, 5000, 1),
                                      (30_000, 40, 4), (5000, 9000, 3),
                                      (20_000, 700, 1500)])
def test_segsum_kernel_deterministic(cuda, n, nseg, d):
    rng = np.random.default_rng(n + d)
    v = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, nseg, n).astype(np.int32))
    before = onehot_segsum_cuda.launches
    a = ops.segsum(v.to(cuda), ids.to(cuda), nseg + 2).cpu()
    b = ops.segsum(v.to(cuda), ids.to(cuda), nseg + 2).cpu()
    assert onehot_segsum_cuda.launches == before + 2
    assert torch.equal(a, b)                         # same bits every run
    assert not a[nseg:].any()
    want = ref.onehot_segsum_ref(v.double(), ids, nseg + 2)
    count = torch.zeros(nseg + 2, dtype=torch.float64).index_add_(
        0, ids, torch.ones(n, dtype=torch.float64))
    absum = ref.onehot_segsum_ref(v.double().abs(), ids, nseg + 2)
    # a term meets at most count - 1 adds in its warp, then at most count
    # nonzero partials across warps and slices
    bound = (2 * count[:, None] + 16) * 2.0**-24 * absum
    assert bool(((a.double() - want).abs() <= bound).all())


def _segsum_inputs(n, nseg, d, seed, skew=False):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    ids = rng.integers(0, nseg, n).astype(np.int32)
    if skew:                                   # half the rows in segment 0
        ids[rng.permutation(n)[: n // 2]] = 0
    return v, torch.from_numpy(ids)


# the cases of test_segsum_kernel_deterministic, then a giant segment split
# over many pieces, D between 4 and 32, a huge C with few rows, C past the
# shared counters (D = 1, 2 and 40), and C = 10^8 with N = 1000
EMULATED = [(1, 1, 1, False), (70_000, 5000, 1, False),
            (30_000, 40, 4, False), (5000, 9000, 3, False),
            (20_000, 700, 1500, False), (300_000, 524_288, 1, True),
            (8000, 2000, 12, False), (1000, 10**6, 1, False),
            (1000, 5 * 10**6, 1, False), (300_000, 8 * 10**6, 2, False),
            (5000, 200_000, 40, False), (1000, 10**8, 1, False)]


@pytest.mark.parametrize("n,nseg,d,skew", EMULATED)
def test_segsum_kernel_equals_emulation(cuda, n, nseg, d, skew):
    """Bit for bit: the kernel folds in the order that
    ``onehot_segsum.emulate`` runs on the CPU."""
    v, ids = _segsum_inputs(n, nseg, d, n + d, skew)
    got = ops.segsum(v.to(cuda), ids.to(cuda), nseg + 2).cpu()
    want = emulate(v, ids, nseg + 2)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 4, 40])
def test_segsum_kernel_half_types(cuda, dtype, d):
    """16-bit values: summed in float32, rounded once to the input type,
    bit for bit the emulation's."""
    v, ids = _segsum_inputs(50_000, 3000, d, d, skew=True)
    v = v.to(dtype)
    got = ops.segsum(v.to(cuda), ids.to(cuda), 3000).cpu()
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int16), emulate(v, ids, 3000).view(
        torch.int16))


@pytest.mark.parametrize("n,c,d", [(2_097_153, 857_336, 1),
                                   (2_097_152, 524_288, 4), (20_000, 702, 1500),
                                   (10, 5, 3072), (0, 1, 1),
                                   (1000, 10**8, 1), (300_000, 8 * 10**6, 2)])
def test_segsum_scratch_bytes(cuda, n, c, d):
    """The source's layout holds each region: counters and their scan, the
    permuted rows, the partial tiles, each aligned to 256 bytes."""
    p = plan_for(n, c, d)
    m = p.buckets * p.chunks
    need = 12 * m + 4 * n + 4 * n * d + \
        4 * p.partial_slots * p.tile_segments * d + \
        (32 * m if p.shared_counters else 0)
    assert need <= scratch_bytes(p, 4) <= need + 7 * 256 + 8 * m
    # D = 1 keeps 8-byte records (value in float32) whatever the type
    half = scratch_bytes(p, 4) - (0 if d == 1 else 2 * n * d)
    assert half <= scratch_bytes(p, 2) <= half + 256


def test_segsum_scratch_refuses_a_plan_the_kernel_does_not_take(cuda):
    p = plan_for(100, 10, 4)
    with pytest.raises(ValueError, match="does not take"):
        scratch_bytes(p._replace(tile_segments=2 * p.tile_segments), 4)


def test_segsum_kernel_channel_limit(cuda):
    v, ids = _segsum_inputs(64, 3, 3072, 1)
    got = ops.segsum(v.to(cuda), ids.to(cuda), 3).cpu()
    assert torch.equal(got, emulate(v, ids, 3))
    wide = torch.zeros((64, 3073), device=cuda)
    with pytest.raises(ValueError, match="3072 channels"):
        ops.segsum(wide, ids.to(cuda), 3)


# K across the 32-wide id chunks and the 8-wide gather groups; D across the
# 128-channel passes (csrc/spmm.cu)
SPMM_SHAPES = [(1000, 16, 300, 128), (333, 10, 5000, 602), (7, 1, 3, 1)] + [
    (300, k, 2000, d) for k in (1, 31, 32, 33, 40) for d in (1, 3, 130, 602)]


def _spmm_inputs(n, k, nx, d, dtype, seed):
    rng = np.random.default_rng(seed)
    nbr = torch.from_numpy(rng.integers(0, nx, (n, k)).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    w[torch.from_numpy(rng.random((n, k)) < 0.1)] = 0.0
    x = torch.from_numpy(rng.normal(size=(nx, d)).astype(np.float32)).to(dtype)
    return nbr, w, x


@pytest.mark.parametrize("n,k,nx,d", SPMM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_spmm_kernel(cuda, n, k, nx, d, dtype):
    nbr, w, x = _spmm_inputs(n, k, nx, d, dtype, n + k)
    args = (nbr.to(cuda), w.to(cuda), x.to(cuda))
    before = bucket_spmm_cuda.launches
    got = ops.spmm(*args)
    again = ops.spmm(*args)
    assert bucket_spmm_cuda.launches == before + 2
    assert torch.equal(got.view(torch.int16 if dtype != torch.float32
                                else torch.int32),
                       again.view(torch.int16 if dtype != torch.float32
                                  else torch.int32))   # the same bits
    want = ref.bucket_spmm_ref(nbr, w, x)
    tol = dict(rtol=2e-5, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(got.cpu().float(), want.float(), **tol)


def test_spmm_kernel_gathers_zero_weight_neighbours(cuda):
    """A NaN and an inf in rows of x that only w == 0 neighbours name: the
    kernel gathers and multiplies them, so the rows that name them are NaN
    exactly where the plain version's are."""
    nbr, w, x = _spmm_inputs(200, 12, 400, 130, torch.float32, 31)
    x[5, 7] = float("nan")
    x[9, 100] = float("inf")
    hit = (nbr == 5) | (nbr == 9)
    w[hit] = 0.0
    got = ops.spmm(nbr.to(cuda), w.to(cuda), x.to(cuda)).cpu()
    want = ref.bucket_spmm_ref(nbr, w, x)
    assert bool(torch.isnan(want).any())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-4,
                               equal_nan=True)


def test_spmm_kernel_unaligned_x(cuda):
    """An x that starts 4 bytes past a 16-byte boundary gives the same bits
    as an aligned copy."""
    nbr, w, x = _spmm_inputs(500, 16, 300, 128, torch.float32, 7)
    nbr, w, xc = nbr.to(cuda), w.to(cuda), x.to(cuda)
    flat = torch.empty(x.numel() + 1, device=cuda)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(xc)
    assert shifted.data_ptr() % 16 == 4
    assert torch.equal(ops.spmm(nbr, w, shifted), ops.spmm(nbr, w, xc))


def test_out_of_range_ids_add_nothing_on_card(cuda):
    """A neighbour or segment id outside its range is skipped by the
    kernels, never read, as the plain versions drop it."""
    rng = np.random.default_rng(23)
    nbr = torch.from_numpy(rng.integers(0, 300, (64, 4)).astype(np.int32))
    nbr[[3, 17, 40], [0, 2, 3]] = torch.tensor([-1, 300, 2**31 - 1],
                                               dtype=torch.int32)
    w = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(300, 8)).astype(np.float32))
    got = ops.spmm(nbr.to(cuda), w.to(cuda), x.to(cuda)).cpu()
    torch.testing.assert_close(got, ref.bucket_spmm_ref(nbr, w, x),
                               rtol=2e-5, atol=1e-4)
    ids, v = nbr.reshape(-1), x[:256, 0].contiguous()
    got = ops.segsum(v.to(cuda), ids.to(cuda), 300).cpu()
    torch.testing.assert_close(got, ref.onehot_segsum_ref(v, ids, 300),
                               rtol=2e-5, atol=1e-5)
    assert bool(torch.isfinite(ops.spmm(
        nbr.to(cuda), w.to(cuda), x[:0].to(cuda))).all())


def _assert_output_rounding_bound(got, q, k, v, causal, window):
    """chip_smoke.py phase 5's bound for 16-bit attention: the output's
    bf16 rounding, |err| <= 2^-8 * |out| + 1e-4, against the plain version
    on float32 copies of the inputs (CPU tensors)."""
    want = ops.flash_attention(q.float(), k.float(), v.float(),
                               causal=causal, window=window).double()
    err = (got.cpu().double() - want).abs()
    tol = 2.0**-8 * want.abs() + 1e-4
    assert bool((err <= tol).all()), \
        f"largest err/tol {float((err / tol).max())}"


@pytest.mark.parametrize("b,sq,sk,hq,hkv,dh,causal,window", [
    (2, 70, 70, 4, 2, 64, True, None),
    (1, 129, 129, 2, 1, 128, True, 33),
    (1, 40, 75, 2, 2, 16, False, None),
    (1, 64, 64, 1, 1, 200, False, 10),
    (1, 8, 8, 1, 1, 8, True, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, b, sq, sk, hq, hkv, dh, causal, window,
                                dtype):
    rng = np.random.default_rng(sq + dh)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, dh))
                                .astype(np.float32)).to(dtype)
               for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                              causal=causal, window=window).cpu()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == dtype
    if dtype == torch.float32:
        want = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        _assert_output_rounding_bound(got, q, k, v, causal, window)


def test_flash_attention_reads_strides(cuda):
    """A [B, H, S, Dh] tensor transposed to [B, S, H, Dh] is read in place."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 50, 32))
                                .astype(np.float32)).to(cuda).transpose(1, 2)
               for _ in range(3))
    got = ops.flash_attention(q, k, v, window=9)
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               window=9)
    assert torch.equal(got, want)


# --- flash attention: the tensor-core route (flash_fwd_wgmma) ---------------

def _flash_inputs(seed, b, sq, sk, hq, hkv, dh, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(b, s, h, dh))
                                  .astype(np.float32)).to(dtype)
                 for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))


def _flash_on_card(cuda, q, k, v, causal, window, tensor_cores):
    """ops.flash_attention on card copies of q, k, v; asserts one launch,
    through the tensor-core kernel or not as ``tensor_cores`` says."""
    qc, kc, vc = q.to(cuda), k.to(cuda), v.to(cuda)
    assert tensor_core_route(qc, kc, vc) == tensor_cores
    before = (flash_attention_cuda.launches,
              flash_attention_cuda.tensor_core_launches)
    got = ops.flash_attention(qc, kc, vc, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches,
            flash_attention_cuda.tensor_core_launches) == \
        (before[0] + 1, before[1] + int(tensor_cores))
    assert got.dtype == q.dtype and got.shape == q.shape
    return got.cpu()


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_wgmma_single_tile(cuda, dh):
    """One 64 x 64 tile, one head, no mask: the descriptors, the swizzle
    and the accumulator-to-A conversion of the tensor-core kernel."""
    q, k, v = _flash_inputs(dh, 1, 64, 64, 1, 1, dh, torch.bfloat16)
    got = _flash_on_card(cuda, q, k, v, False, None, True)
    _assert_output_rounding_bound(got, q, k, v, False, None)


# name: (b, sq, sk, hq, hkv, causal, window)
TENSOR_CORE_CASES = {
    "ragged_s": (2, 200, 200, 4, 2, True, None),
    "gqa_4": (1, 256, 256, 8, 2, True, None),
    "gqa_8": (1, 192, 192, 8, 1, True, None),
    "window_edge_in_tile": (1, 300, 300, 2, 1, True, 100),
    "non_causal_sq_ne_sk": (1, 100, 333, 2, 2, False, None),
    "window_0_sees_nothing": (1, 130, 130, 2, 1, True, 0),
}


@pytest.mark.parametrize("case", sorted(TENSOR_CORE_CASES))
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_tensor_core_route(cuda, case, dh, dtype):
    b, sq, sk, hq, hkv, causal, window = TENSOR_CORE_CASES[case]
    q, k, v = _flash_inputs(sq + sk + dh, b, sq, sk, hq, hkv, dh, dtype)
    got = _flash_on_card(cuda, q, k, v, causal, window, True)
    _assert_output_rounding_bound(got, q, k, v, causal, window)
    if window == 0:
        assert not got.any()


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_tensor_core_reads_transposed_views(cuda, dh, dtype):
    """Aligned [B, H, S, Dh] tensors transposed to [B, S, H, Dh] go through
    the tensor cores in place and give what their contiguous copies give."""
    rng = np.random.default_rng(dh)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 4, 150, dh))
                                .astype(np.float32)).to(dtype).transpose(1, 2)
               for _ in range(3))
    got = _flash_on_card(cuda, q, k, v, True, 40, True)
    want = _flash_on_card(cuda, q.contiguous(), k.contiguous(),
                          v.contiguous(), True, 40, True)
    assert torch.equal(got, want)
    _assert_output_rounding_bound(got, q, k, v, True, 40)


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 64),
                                      (torch.bfloat16, 200)])
def test_flash_cuda_core_route(cuda, dtype, dh):
    """float32 inputs and a head size the tensor-core kernel does not take
    launch the CUDA-core kernel."""
    q, k, v = _flash_inputs(5, 1, 96, 96, 4, 2, dh, dtype)
    got = _flash_on_card(cuda, q, k, v, True, None, False)
    if dtype == torch.float32:
        want = ops.flash_attention(q, k, v, causal=True, window=None)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        _assert_output_rounding_bound(got, q, k, v, True, None)


# ---------------------------------------------------------------------------
# the batched engine and the store's batched warm updates, card vs CPU
# ---------------------------------------------------------------------------

ENGINE_GRAPHS = {   # one small family a default bucket, three seeds each
    (64, 512): lambda s: sbm_graph(30, 3, 0.4, 0.04, seed=s,
                                   device="cpu")[0],
    (64, 2048): lambda s: sbm_graph(56, 4, 0.7, 0.08, seed=s,
                                    device="cpu")[0],
    (256, 2048): lambda s: sbm_graph(100, 4, 0.2, 0.02, seed=s,
                                     device="cpu")[0],
    (256, 8192): lambda s: sbm_graph(200, 4, 0.3, 0.02, seed=s,
                                     device="cpu")[0],
    (1024, 16384): lambda s: sbm_graph(1024, 16, 0.2, 0.003, seed=s + 3,
                                       device="cpu")[0],
}


def _engine_batch(bucket):
    from repro_torch.service import Bucket
    from repro_torch.service.buckets import admit

    b = Bucket(*bucket)
    graphs = []
    for s in range(3):
        g, got = admit(ENGINE_GRAPHS[bucket](s))
        assert got == b, (bucket, got)
        graphs.append(g)
    return graphs


@pytest.mark.parametrize("bucket", list(ENGINE_GRAPHS))
def test_engine_card_equals_cpu(cuda, bucket):
    from repro_torch.service import BatchedLouvainEngine

    graphs = _engine_batch(bucket)
    on_cpu = BatchedLouvainEngine(device="cpu").detect_batch(graphs)
    on_card = BatchedLouvainEngine().detect_batch(
        [g.to(cuda) for g in graphs])
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_array_equal(a.C, b.C)
        assert (a.n_communities, a.n_disconnected, a.fraction, a.passes,
                a.sweeps, a.split_moved, a.q) == (
            b.n_communities, b.n_disconnected, b.fraction, b.passes,
            b.sweeps, b.split_moved, b.q)
        assert a.n_disconnected == 0


def test_update_batch_card_equals_cpu(cuda):
    from repro_torch.service import BatchedLouvainEngine, ResultStore

    graphs = _engine_batch((1024, 16384))
    cpu = BatchedLouvainEngine(device="cpu")
    store = ResultStore(device="cpu")
    items = []
    for i, (g, r) in enumerate(zip(graphs, cpu.detect_batch(graphs))):
        store.put(f"g{i}", g, r.C, n_communities=r.n_communities,
                  n_disconnected=r.n_disconnected, q=r.q)
        rng = np.random.default_rng(i)
        n = int(g.n_nodes)
        upd = GraphUpdate(u=rng.integers(0, n - 4, 24),
                          v=rng.integers(0, n - 4, 24),
                          dw=np.ones(24, np.float32), add=2,
                          remove=[5 + i, 300 + i])
        p = store.prepare_update(f"g{i}", upd)
        items.append((p.graph, p.C_prev, p.touched))
    want = cpu.update_batch(items)
    got = BatchedLouvainEngine().update_batch(items)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.C, b.C)
        assert (a.n_communities, a.n_disconnected, a.fraction, a.iterations,
                a.n_affected, a.split_moved, a.q) == (
            b.n_communities, b.n_disconnected, b.fraction, b.iterations,
            b.n_affected, b.split_moved, b.q)
        assert a.n_disconnected == 0


# ---------------------------------------------------------------------------
# the checkpoint store, the timeline and the degraded tier (ROADMAP A.10)
# ---------------------------------------------------------------------------

def _store_pair(cuda, **kw):
    """A store on the card and one on the CPU, each with a timeline
    manager on its commit hook, holding the same detection."""
    from repro_torch.service import ResultStore
    from repro_torch.timeline import TimelineConfig, TimelineManager

    g = _engine_batch((1024, 16384))[0]
    det = detect(g, device="cpu")
    out = []
    for dev, gg in ((cuda, g.to(cuda)), ("cpu", g)):
        tl = TimelineManager(TimelineConfig(**kw), clock=lambda: 0.0)
        store = ResultStore(device=dev, on_commit=tl.observe_commit)
        store.put("g", gg, det.labels.numpy(), n_communities=det.n_communities,
                  n_disconnected=det.n_disconnected, q=det.modularity)
        out.append(type("Holder", (), dict(store=store, timelines=tl))())
    return out


def _churn(n, seed):
    rng = np.random.default_rng(seed)
    m = n - 6 + 3
    return GraphUpdate(u=rng.integers(0, m, 40), v=rng.integers(0, m, 40),
                       dw=np.ones(40, np.float32), add=3,
                       remove=np.sort(rng.choice(n, 6, replace=False)))


def _same_entry(a, b):
    for k in ("src", "dst", "w", "n_nodes"):
        assert torch.equal(getattr(a.graph, k).cpu(), getattr(b.graph, k).cpu())
    np.testing.assert_array_equal(a.C, b.C)
    np.testing.assert_array_equal(a.deferred, b.deferred)
    assert (a.version, a.n_communities, a.n_disconnected, a.q) == (
        b.version, b.n_communities, b.n_disconnected, b.q)


def test_service_checkpoint_round_trip_on_card(cuda, tmp_path):
    from repro_torch.timeline import (restore_service_checkpoint,
                                      save_service_checkpoint)

    card, cpu = _store_pair(cuda)
    n = int(cpu.store.get("g").graph.n_nodes)
    for h in (card, cpu):
        h.store.apply_update("g", _churn(n, 0))
    save_service_checkpoint(card, str(tmp_path))
    back, _ = _store_pair(cuda)
    assert restore_service_checkpoint(back, str(tmp_path)) == 0
    got = back.store.get("g")
    assert got.graph.device.type == "cuda"
    _same_entry(got, card.store.get("g"))
    _same_entry(got, cpu.store.get("g"))
    n = int(got.graph.n_nodes)
    for h in (back, cpu):
        h.store.apply_update("g", _churn(n, 1))
    _same_entry(back.store.get("g"), cpu.store.get("g"))
    assert back.store.get("g").n_disconnected == 0


def test_lpa_result_card_equals_cpu(cuda):
    from repro_torch.resilience import lpa_result

    for g in _engine_batch((1024, 16384)):
        a = lpa_result("g", g.to(cuda))
        b = lpa_result("g", g, device="cpu")
        np.testing.assert_array_equal(a.C, b.C)
        assert (a.n_communities, a.n_disconnected, a.q) == (
            b.n_communities, b.n_disconnected, b.q)
        assert not a.guarantee and a.contract.tier == "fast"


@pytest.mark.parametrize("wbd", [False, True])
def test_timeline_state_card_equals_cpu(cuda, wbd):
    card, cpu = _store_pair(cuda, weight_by_degree=wbd)
    for step in range(3):
        n = int(cpu.store.get("g").graph.n_nodes)
        for h in (card, cpu):
            h.timelines.set_time("g", float(step + 1))
            h.store.apply_update("g", _churn(n, 10 + step))
    (aa, am), (ba, bm) = card.timelines.state(), cpu.timelines.state()
    assert am == bm and list(aa) == list(ba)
    for k in aa:
        assert aa[k].dtype == ba[k].dtype and np.array_equal(aa[k], ba[k]), k
    assert card.timelines.n_idmap_resets == 0


# ---------------------------------------------------------------------------
# the front end (ROADMAP A.11): the sync adapter, the async service and
# the timeline's ingest, on the card against the CPU
# ---------------------------------------------------------------------------

def _mixed_requests():
    """Ego-nets in Bucket(64, 512) and SBM graphs in Bucket(256, 2048),
    then seeded edge updates on two of them."""
    small = [sbm_graph(n_nodes=30, n_blocks=3, p_in=0.4, p_out=0.04,
                       seed=s, device="cpu")[0] for s in range(4)]
    big = [sbm_graph(n_nodes=100, n_blocks=4, p_in=0.2, p_out=0.02,
                     seed=s, device="cpu")[0] for s in range(2)]
    return small + big


def _serve_mixed(device, update_batch_size):
    from repro_torch.service import Bucket, CommunityService, ServiceConfig

    cfg = ServiceConfig(buckets=(Bucket(64, 512), Bucket(64, 2048),
                                 Bucket(256, 2048)),
                        batch_size=4, max_delay_s=10.0,
                        update_batch_size=update_batch_size)
    svc = CommunityService(config=cfg, device=device)
    for i, g in enumerate(_mixed_requests()):
        svc.submit_detect(f"g{i}", g, tenant=f"t{i % 2}")
    assert svc.drain() == 6
    rng = np.random.default_rng(4)
    for i in (0, 4):
        n = int(svc.result(f"g{i}").graph.n_nodes)
        u, v = rng.integers(0, n, 4), rng.integers(0, n, 4)
        keep = u != v
        svc.submit_update(f"g{i}", (u[keep], v[keep],
                                    np.ones(int(keep.sum()), np.float32)))
    svc.drain()
    return svc


@pytest.mark.parametrize("update_batch_size", [1, 4])
def test_service_mixed_card_equals_cpu(cuda, update_batch_size):
    card = _serve_mixed(cuda, update_batch_size)
    cpu = _serve_mixed("cpu", update_batch_size)
    assert card.frontend.device.type == "cuda"
    for i in range(6):
        a, b = card.result(f"g{i}"), cpu.result(f"g{i}")
        assert a.graph.device.type == "cuda"
        _same_entry(a, b)
        assert a.n_disconnected == 0
    assert card.metrics.n_detect == cpu.metrics.n_detect == 6
    assert card.metrics.n_update == cpu.metrics.n_update == 2


def test_async_service_on_card_resolves_every_future(cuda):
    import asyncio

    from repro_torch.service import AsyncCommunityService, ServiceConfig

    graphs = _mixed_requests()

    async def go():
        cfg = ServiceConfig(batch_size=4, max_delay_s=0.01,
                            max_pending_per_tenant=4)
        async with AsyncCommunityService(cfg, device=cuda) as svc:
            futs = [await svc.submit_detect(f"g{i}", g, tenant=f"t{i % 3}")
                    for i, g in enumerate(graphs)]
            return await asyncio.gather(*futs)

    entries = asyncio.run(go())
    for g, e in zip(graphs, entries):
        assert e.graph.device.type == "cuda" and e.n_disconnected == 0
        d = detect(e.graph, device="cpu")
        np.testing.assert_array_equal(e.C, d.labels.numpy())
        assert e.q == d.modularity


def test_ingest_window_planted_card_equals_cpu(cuda):
    from repro_torch.data import planted_timeline_script
    from repro_torch.service import CommunityService, ServiceConfig

    out = []
    for device in (cuda, "cpu"):
        g0, windows, expected = planted_timeline_script(device=device)
        svc = CommunityService(config=ServiceConfig(
            timeline_enabled=True, telemetry_enabled=False), device=device)
        svc.frontend.set_snapshot_time("g", 0.0)
        svc.submit_detect("g", g0)
        svc.pump(force=True)
        for i, evs in enumerate(windows):
            svc.ingest_window("g", evs, t=float(i + 1))
        events = [(e.kind, e.t, e.community, e.parents)
                  for e in svc.lifecycle_events("g")]
        got = sorted((e.t, e.kind) for e in svc.lifecycle_events("g")
                     if e.kind != "continuation" and e.t > 0)
        assert got == [(float(i + 1), k) for i, ks in enumerate(expected)
                       for k in ks]
        out.append((events, svc.timelines.state(),
                    svc.store.get("g")))
        svc.close()
    (ea, (aa, am), xa), (eb, (ba, bm), xb) = out
    assert ea == eb and am == bm
    for k in aa:
        assert np.array_equal(aa[k], ba[k]), k
    assert xa.graph.device.type == "cuda"
    _same_entry(xa, xb)
