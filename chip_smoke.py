#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py            # needs one CUDA card, nvcc and the repo

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``.
2. Kernel vs plain, on the card, at the main path's sizes (the edge arrays
   of the full-size graph of phase 4): every (op, dtype, D) the main path
   uses, with empty segments, the graph's hub segments and a 96-row
   in-order fold; one segment of all M rows; the run-field layout (ids
   ``0..n_runs-1`` over ``m_cap`` slots, an empty tail of tens of millions
   of segments); a small case of ±0 ties and NaNs.  Exactness is required
   bit for bit (int32 bits of float32, NaN bits included).  f32 sums and
   the ±0/NaN case are held against the plain version run on a CPU copy of
   the same inputs, because on CUDA the plain version's ``index_add_`` is
   atomic and folds in no fixed order; the other max/min and int32 results
   are held against the plain version on the card, which is exact in any
   order there.  Prints each case's route (``in-order`` or ``tiled``,
   ``kernels/segsum.py:route``), median time, byte bound, the plain
   version's time and the library call's (``index_add_`` /
   ``scatter_reduce_``), which the port never calls.
3. End to end, small: ``detect()`` on the card and on the CPU give equal
   labels and zero disconnected communities.
4. End to end, full size: ``detect()`` with default options on
   ``rmat_graph(scale=21, edge_factor=16, seed=1)`` (about 2.1M vertices
   and 63.5M directed edges, the scale of com-LiveJournal), with zero
   disconnected communities, a modularity in (0, 1), and the segment-reduce
   kernel launched on the way (its count is reset just before the run).

5. The kernel API vs plain, on the card: ``repro_torch.kernels.ops``'s
   ``cumsum``, ``segsum_sorted``, ``segsum``, ``spmm`` and
   ``flash_attention`` at full-width shapes (the full-size graph's edge
   weights, its per-vertex K keyed by phase 4's labels, one giant
   community among 524,288, a sampled Reddit GNN layer, TinyLlama and
   Mixtral prefill), each kernel's launch count reset just before and read
   just after one pass through the API.  Each
   output is held against its plain version within the tolerance the
   phase prints, with its largest err/tol: float32 rounding bounds against
   float64 for the sums (per segment for ``segsum_sorted``), the
   reference's tolerance for spmm, the output's bfloat16 rounding for
   attention, whose inputs also go through once as float32 at 2e-5;
   ``segsum`` bit for bit across two launches, and at the Sigma recompute's
   shape bit for bit the CPU emulation of its fold order
   (``kernels/onehot_segsum.py:emulate``).  Both flash cases are
   bf16 and must go through the tensor-core kernel (``flash_fwd_wgmma``):
   the flash entry counts launches by route.  Then the median time of
   each case, its bound, the plain version's time and one PyTorch call's.

``--profile`` adds a traced run of phase 4 (device time by kernel, the
device's busy share, and each segment-reduce kernel's total) and, in phase 5, three traced calls of each
``segsum`` case (device time a launch by kernel).  The second-to-last lines are
one JSON object for the kernels (``kernels``) and the card line; the last
line is the result object.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
REPLACES = "src/repro/kernels/segsum.py:130"   # segscan_blocked -> pallas_call
SOURCE = "src/repro_torch/kernels/csrc/segreduce.cu"
REPS = 10                        # timed calls per kernel measurement
SLOW_MS = 1000.0                 # ... or SLOW_REPS where one call is slower
SLOW_REPS = 3


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn()`` over ``reps`` calls after one warm-up,
    each bracketed by CUDA events; over ``SLOW_REPS`` calls (and said so)
    where the first timed call took longer than ``SLOW_MS``."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        if times[0] > SLOW_MS and len(times) == SLOW_REPS < reps:
            log(f"    (a call took {times[0]:.0f} ms: median of "
                f"{SLOW_REPS} calls)")
            break
    return statistics.median(times)


def max_abs_err(got, want) -> float:
    """0.0 exactly when ``got`` equals ``want`` bit for bit (float32 as
    its int32 bits, so -0 differs from +0 and NaN bits must agree); else
    the largest difference of unequal elements (inf where one is NaN)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    if got.dtype == torch.float32:
        same = got.view(torch.int32) == want.view(torch.int32)
    else:
        same = got == want
    if bool(same.all()):
        return 0.0
    diff = (got.double() - want.double()).abs()
    diff = torch.where(torch.isnan(diff), float("inf"), diff)
    return float(torch.where(same, torch.zeros_like(diff), diff).max())


def run_lengths_ids(m: int, hub: int, device):
    """Sorted run ids over ``m`` rows: geometric runs (mean 2) and one hub
    run of ``hub`` rows, spread over [0, m) so that many segments between
    and after the runs are empty (as in the run-sum pass, whose ids index
    ``m_cap`` run slots)."""
    import numpy as np
    import torch

    lens = np.random.default_rng(0).geometric(0.5, m)
    lens[m // 3] = hub
    n_runs = int(np.searchsorted(np.cumsum(lens), m)) + 1
    lens = lens[:n_runs]
    lens[-1] -= int(lens.sum()) - m
    run = np.repeat(np.arange(n_runs, dtype=np.int64), lens)
    ids = run * (m - 1) // max(n_runs - 1, 1)
    return torch.from_numpy(ids.astype(np.int32)).to(device)


def run_field_ids(m: int, device):
    """Run ids as ``aggregate``'s run fields see them: ``0..n_runs-1`` over
    ``m`` slots (geometric runs of mean 4), so the segments after
    ``n_runs - 1`` are an empty tail."""
    import numpy as np
    import torch

    lens = np.random.default_rng(1).geometric(0.25, m)
    n_runs = int(np.searchsorted(np.cumsum(lens), m)) + 1
    run = np.repeat(np.arange(n_runs, dtype=np.int32), lens[:n_runs])[:m]
    return torch.from_numpy(run).to(device)


def special_values(m: int, d: int, gen):
    """float32 ``[m, d]`` drawn from ±0, ±1, 2.5, ±inf and NaN."""
    import torch

    pool = torch.tensor([-0.0, 0.0, 1.0, -1.0, 2.5, float("inf"),
                         float("-inf"), float("nan")])
    return pool[torch.randint(0, len(pool), (m, d), generator=gen)]


def kernel_phase(g) -> dict:
    """Phase 2.  Returns the kernel's JSON entry (launches filled later)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.segsum import route

    dev = g.src.device
    gen = torch.Generator(device="cpu").manual_seed(0)
    m = g.m_cap
    src = g.src
    rid = run_lengths_ids(m, 150_000, dev)
    hub = int(torch.diff(torch.searchsorted(
        src, torch.arange(g.nv + 1, dtype=torch.int32, device=dev))).max())
    log(f"  rows M={m}  segments by src nv={g.nv}  largest src segment "
        f"{hub} rows  run-id layout: {int(rid[-1]) + 1} runs over {m} slots")

    def f32(d):
        return torch.randn((m, d), generator=gen).to(dev)

    def i32(lo, hi):
        return torch.randint(lo, hi, (m, 1), generator=gen,
                             dtype=torch.int32).to(dev)

    dq = f32(2)
    dq[torch.rand((m, 2), generator=gen).to(dev) < 0.5] = float("-inf")
    cmin = i32(0, g.nv)
    cmin[torch.rand((m, 1), generator=gen).to(dev) < 0.5] = 2**31 - 1
    fid = run_field_ids(m, dev)
    small = 10_000
    sid = torch.sort(torch.randint(0, 1500, (small,), generator=gen,
                                   dtype=torch.int32)).values.to(dev)
    # (name, values, ids, nseg, op): each (op, dtype, D) the main path
    # runs, then the layouts that would bring back a hub, then ±0 and NaN
    cases = [
        ("sum f32 D=2 (pass A run sums)", f32(2), rid, m, "sum"),
        ("sum f32 D=1 (K by src)", f32(1), src, g.nv, "sum"),
        ("max f32 D=2 (pass B by src)", dq, src, g.nv, "max"),
        ("min i32 D=1 (argmax, split)", cmin, src, g.nv, "min"),
        ("max i32 D=1 (pruning wake-up)", i32(0, 2), src, g.nv, "max"),
        ("sum i32 D=1 (detector pieces)", i32(0, 2), rid, m, "sum"),
        ("sum i32 D=2 (aggregate run fields)", i32(0, g.nv).repeat(1, 2),
         rid, m, "sum"),
        ("min i32 D=1 (one segment of all M rows)", i32(-2**31, 2**31 - 1),
         torch.zeros(m, dtype=torch.int32, device=dev), 1, "min"),
        (f"sum i32 D=2 (run fields: {int(fid[-1]) + 1} runs over m_cap "
         "slots, empty tail)", i32(0, g.nv).repeat(1, 2), fid, m, "sum"),
        ("max f32 D=2 (±0 ties and NaN, 10,000 rows)",
         special_values(small, 2, gen).to(dev), sid, 1600, "max"),
    ]
    variants, worst = [], 0.0
    for name, v, ids, nseg, op in cases:
        how = route(op, v.dtype)
        got = ops.segreduce_sorted(v, ids, nseg, op=op)
        torch.cuda.synchronize()
        if how == "in-order" or v.shape[0] == small:   # f32 sums, ±0/NaN
            want = ref.segreduce_sorted_ref(v.cpu(), ids.cpu(), nseg, op=op)
            got_c = got.cpu()
        else:
            want = ref.segreduce_sorted_ref(v, ids, nseg, op=op)
            got_c = got
        err = max_abs_err(got_c, want)
        worst = max(worst, err)
        if err != 0.0:
            raise AssertionError(f"kernel disagrees with plain: {name}: "
                                 f"max_abs_err={err}")
        ms = median_ms(lambda: ops.segreduce_sorted(v, ids, nseg, op=op))
        plain_ms = median_ms(
            lambda: ref.segreduce_sorted_ref(v, ids, nseg, op=op))
        out = torch.zeros((nseg, v.shape[1]), dtype=v.dtype, device=dev)
        if op == "sum":
            lib = lambda: out.index_add_(0, ids, v)  # noqa: E731
        else:
            idx = ids.long()[:, None].expand_as(v)
            lib = lambda: out.scatter_reduce_(  # noqa: E731
                0, idx, v, "amax" if op == "max" else "amin")
        library_ms = median_ms(lib)
        nbytes = v.numel() * 4 + ids.numel() * 4 + nseg * v.shape[1] * 4
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        variants.append(dict(case=name, route=how, rows=v.shape[0],
                             segments=nseg, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             library_ms=library_ms))
        log(f"  {name} [{how}]: bit-identical  ms={ms:.4f}  "
            f"bound_ms={bound_ms:.4f}  plain_ms={plain_ms:.4f}  "
            f"library_ms={library_ms:.4f}")
        del got, got_c, want, out

    # the 96-row in-order case of the reference's test_segscan_inorder_fold
    rng = torch.Generator().manual_seed(7)
    x = torch.randn((96, 1), generator=rng)
    starts = torch.zeros(96, dtype=torch.int32)
    starts[[0, 5, 6, 40, 80]] = 1
    ids96 = torch.cumsum(starts, 0).to(torch.int32) - 1
    got = ops.segreduce_sorted(x.to(dev), ids96.to(dev), 5, op="sum").cpu()
    acc, fold = None, []
    for i in range(96):
        xi = x[i, 0]
        acc = xi if starts[i] else acc + xi       # float32 left fold
        if i == 95 or starts[i + 1]:
            fold.append(acc)
    if not torch.equal(got[:, 0], torch.stack(fold)):
        raise AssertionError("96-row in-order fold differs")
    log("  96-row in-order fold: exact")

    head = variants[0]
    entry = dict(name="segreduce_sorted", route="cuda", source=SOURCE,
                 replaces=REPLACES, launches=0, max_abs_err=worst,
                 ms=head["ms"], plain_ms=head["plain_ms"],
                 bound_ms=head["bound_ms"], bound_by="bytes",
                 library_ms=head["library_ms"], variants=variants)
    return entry


U32 = 2.0**-24                   # float32 unit roundoff
BF16_U = 2.0**-8                 # bfloat16 unit roundoff
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
API_SOURCES = {
    "cumsum": ("src/repro_torch/kernels/csrc/cumsum.cu",
               "src/repro/kernels/segsum.py:67"),
    "onehot_segsum": ("src/repro_torch/kernels/csrc/onehot_segsum.cu",
                      "src/repro/kernels/onehot_segsum.py:39"),
    "bucket_spmm": ("src/repro_torch/kernels/csrc/spmm.cu",
                    "src/repro/kernels/spmm.py:42"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn.py:92"),
}


TENSOR_CORE_KERNEL = "flash_fwd_wgmma"
SIGMA_CASE = "segsum K by labels (Sigma recompute)"


def ptxas_lines(report: str, kernel: str) -> list[str]:
    """One line for each entry function of an ``nvcc -Xptxas -v`` report
    whose (mangled) name contains ``kernel``: its template arguments, then
    what ptxas says of registers, shared memory, stack and spills."""
    entries, cur = [], None
    for line in report.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            cur = None
            if kernel in line:
                m = re.search(kernel + r"I\d+(\w+?)Li(\d+)E", line)
                cur = [f"{kernel}<{m[1]}, {m[2]}>" if m else kernel]
                entries.append(cur)
        elif cur is not None and "Function properties" not in line and \
                "Compile time" not in line:
            cur.append(line.removeprefix("ptxas info    : "))
    return [": ".join((e[0], "; ".join(e[1:]))) for e in entries]


def api_wrappers() -> dict:
    """The launch-counting wrapper of each kernel of the kernel API."""
    from repro_torch.kernels.flash_attn import flash_attention_cuda
    from repro_torch.kernels.onehot_segsum import onehot_segsum_cuda
    from repro_torch.kernels.segsum import cumsum_cuda
    from repro_torch.kernels.spmm import bucket_spmm_cuda

    return {"cumsum": cumsum_cuda, "onehot_segsum": onehot_segsum_cuda,
            "bucket_spmm": bucket_spmm_cuda,
            "flash_attention": flash_attention_cuda}


def attention_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through, per batch and head."""
    import numpy as np

    qpos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None \
        else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def api_cases(g, labels):
    """The full-width inputs of phase 5, made on the card from seeds:
    ``(kernel, name, op, args, kwargs)``; ``op`` is the ``ops`` function."""
    import torch

    from repro_torch.kernels import ops

    dev = g.src.device
    gen = torch.Generator(device=dev).manual_seed(5)
    m = g.m_cap
    n = g.nv

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    giant = randint(524_288, n)
    giant[torch.randperm(n, generator=gen, device=dev)[: n // 2]] = 0
    w_pad = randn(262_144, 16)
    w_pad[torch.rand((262_144, 16), generator=gen, device=dev) < 0.1] = 0.0
    tl = dict(b=1, s=4096, hq=32, hkv=4, dh=64)        # TinyLlama-1.1B
    mx = dict(b=1, s=8192, hq=32, hkv=8, dh=128)       # Mixtral-8x7B

    def qkv(c):
        return (randn(c["b"], c["s"], c["hq"], c["dh"], dtype=torch.bfloat16),
                randn(c["b"], c["s"], c["hkv"], c["dh"], dtype=torch.bfloat16),
                randn(c["b"], c["s"], c["hkv"], c["dh"], dtype=torch.bfloat16))

    return [
        ("cumsum", "cumsum f32 [M] (edge weights g.w)", ops.cumsum,
         (g.w,), {}),
        ("cumsum", "cumsum f32 [M, 2]", ops.cumsum, (randn(m, 2),), {}),
        ("cumsum", "segsum_sorted g.w by g.src", ops.segsum_sorted,
         (g.w, g.src, n), {}),
        ("onehot_segsum", SIGMA_CASE, ops.segsum,
         (g.vertex_weights(), labels, int(labels.max()) + 1), {}),
        ("onehot_segsum", "segsum D=4, C=524288 (TPU envelope edge)",
         ops.segsum, (randn(n, 4), randint(524_288, n), 524_288), {}),
        ("onehot_segsum", "segsum D=1, C=524288, half the rows in segment 0 "
         "(one giant community)", ops.segsum,
         (randn(n), giant, 524_288), {}),
        ("bucket_spmm", "spmm N=262144 K=16 x 16384x128 (10% padding)",
         ops.spmm, (randint(16_384, 262_144, 16), w_pad,
                    randn(16_384, 128)), {}),
        ("bucket_spmm", "spmm Reddit layer N=15360 K=10 x 232965x602",
         ops.spmm, (randint(232_965, 15_360, 10), randn(15_360, 10),
                    randn(232_965, 602)), {}),
        ("flash_attention", "flash TinyLlama S=4096 Hq=32 Hkv=4 Dh=64 causal",
         ops.flash_attention, qkv(tl), dict(causal=True, window=None)),
        ("flash_attention", "flash Mixtral S=8192 Hq=32 Hkv=8 Dh=128 "
         "causal window=4096", ops.flash_attention, qkv(mx),
         dict(causal=True, window=4096)),
    ]


def check_case(kernel, name, op, args, kw, got
               ) -> tuple[float, str, object]:
    """Hold one output against its plain version; returns (max_abs_err,
    the stated tolerance, the plain function of the case).  Raises on a
    miss."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.onehot_segsum import emulate

    if kernel == "cumsum" and name.startswith("cumsum"):
        (x,) = args
        x2 = x[:, None] if x.dim() == 1 else x
        # along the inner dimension: torch.cumsum along dim 0 of a narrow
        # [M, D] array takes a path seconds slow (PERF.md)
        xt = x2.double().t().contiguous()
        exact = torch.cumsum(xt, 1).t()
        depth = 64 + -(-x2.shape[0] // 2**20)       # csrc/cumsum.cu
        tol = depth * U32 * torch.cumsum(xt.abs(), 1).t()
        del xt
        err = (got.reshape(x2.shape).double() - exact).abs()
        del exact
        stated = f"|err| <= {depth} * 2^-24 * prefix of |x| (vs float64)"
        plain = ref.cumsum_ref
    elif kernel == "cumsum":
        x, ids, nseg = args
        exact = ref.segsum_sorted_ref(x.double(), ids, nseg)
        depth = 64 + -(-x.shape[0] // 2**20)
        # each output is a difference of two prefixes, each within the
        # cumsum bound at its own row, and one rounding of the difference
        ends = depth * U32 * torch.cat([x.new_zeros(1, dtype=torch.float64),
                                        torch.cumsum(x.double().abs(), 0)])
        b = torch.searchsorted(ids, torch.arange(nseg + 1, dtype=ids.dtype,
                                                 device=ids.device))
        pre = ends[b[1:]] + ends[b[:-1]]
        tol = pre + U32 * (exact.abs() + pre)
        del ends, b
        err = (got.double() - exact).abs()
        rel = err / exact.abs().clamp_min(1e-30)
        nz = exact != 0
        log(f"    segsum_sorted f32 error vs float64 direct sum: max abs "
            f"{float(err.max())}, max relative {float(rel[nz].max())}, "
            f"segments with any error {int((err > 0).sum())} of {nseg}, "
            f"largest true segment sum {float(exact.abs().max())}")
        del exact, rel, pre
        stated = f"|err| <= t + 2^-24 * (|out| + t), t = {depth} * 2^-24 * " \
                 "(prefix of |x| at the segment's end + at its start) " \
                 "(vs float64 direct sum)"

        def plain(v, i, c):
            return ref.prefix_difference(ref.cumsum_ref(v), i, c)
    elif kernel == "onehot_segsum":
        v, ids, nseg = args
        again = op(*args)
        if not torch.equal(again, got):
            raise AssertionError(f"{name}: two launches differ")
        v2 = v[:, None] if v.dim() == 1 else v
        # the kernel's fold order, run on the host: the same bits.  The
        # Sigma case's whole-number K sum exactly in any order, so the
        # random values of the other two cases are what test the order
        want = emulate(v2.cpu(), ids.cpu(), nseg)
        if not torch.equal(got.reshape(want.shape).cpu().view(torch.int32),
                           want.view(torch.int32)):
            raise AssertionError(f"{name}: differs from the CPU "
                                 "emulation of its fold order")
        log("    bit-identical to the CPU emulation of the fold order")
        del want
        exact = ref.onehot_segsum_ref(v2.double(), ids, nseg)
        count = torch.zeros(nseg, dtype=torch.float64, device=v.device)
        count.index_add_(0, ids, torch.ones_like(ids, dtype=torch.float64))
        absum = ref.onehot_segsum_ref(v2.double().abs(), ids, nseg)
        tol = (2 * count[:, None] + 16) * U32 * absum
        err = (got.reshape(exact.shape).double() - exact).abs()
        del exact, count, absum, again
        stated = "bit-identical across two launches; |err| <= (2 * count " \
                 "+ 16) * 2^-24 * sum|v| per segment (vs float64)"
        plain = ref.onehot_segsum_ref
    elif kernel == "bucket_spmm":
        plain = ref.bucket_spmm_ref
        want = plain(*args)
        tol = 1e-4 + 2e-5 * want.double().abs()
        err = (got.double() - want.double()).abs()
        del want
        stated = "rtol 2e-5, atol 1e-4 vs plain (tests/test_kernels.py)"
    else:
        q, k, v = args
        plain = ref.flash_attention_gqa_ref
        f32 = [a.float() for a in args]
        want = plain(*f32, **kw).double()
        # the same values as float32 inputs: only the sum order differs
        err32 = (op(*f32, **kw).double() - want).abs()
        tol32 = 2e-5 + 2e-5 * want.abs()
        log(f"    float32 inputs: max_abs_err={float(err32.max())}, largest "
            f"err/tol {float((err32 / tol32).max())} (rtol 2e-5, atol 2e-5 "
            "vs plain)")
        if bool((err32 > tol32).any()):
            raise AssertionError(f"{name}: float32 inputs beyond rtol 2e-5, "
                                 "atol 2e-5")
        del f32, err32, tol32
        # the output's bfloat16 rounding, plus room for the sum order
        tol = 1e-4 + BF16_U * want.abs()
        err = (got.double() - want).abs()
        del want
        stated = "|err| <= 2^-8 * |out| + 1e-4 vs plain in float32 " \
                 "(bfloat16 rounding of the output)"
    miss = int((err > tol).sum())
    worst = float(err.max()) if err.numel() else 0.0
    log(f"    largest err/tol {float((err / tol.clamp_min(1e-300)).max())}")
    del err, tol
    if miss:
        raise AssertionError(f"{name}: {miss} elements beyond the stated "
                             f"tolerance ({stated}); max_abs_err={worst}")
    return worst, stated, plain


def library_call(kernel, name, args, kw):
    """One PyTorch call computing the case's function (never called by the
    port), and a note naming it; ``None`` where the plain version is that
    very call, whose reading then serves for both."""
    import torch
    import torch.nn.functional as F

    if kernel == "cumsum" and name.startswith("cumsum"):
        return None, "torch.cumsum (the plain version's reading)"
    if kernel in ("cumsum", "onehot_segsum"):
        v, ids, nseg = args
        out = torch.zeros((nseg,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=v.device)
        return (lambda: out.index_add_(0, ids, v)), "index_add_ (atomic)"
    if kernel == "bucket_spmm":
        nbr, w, x = args
        return (lambda: F.embedding_bag(nbr, x, mode="sum",
                                        per_sample_weights=w)), \
            "F.embedding_bag(mode='sum', per_sample_weights=w)"
    q, k, v = (a.transpose(1, 2) for a in args)
    if kw["window"] is None:
        return (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)), \
            "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
    # no fused backend takes a window with grouped heads: a boolean band
    # mask over kv heads repeated beforehand (outside the timing)
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    pos = torch.arange(q.shape[2], device=q.device)
    band = (pos[None, :] <= pos[:, None]) & \
        (pos[:, None] - pos[None, :] < kw["window"])
    return (lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=band)), \
        "F.scaled_dot_product_attention(attn_mask=band) over repeated kv " \
        "heads, backend chosen by PyTorch"


def case_bound(kernel, name, args, kw, out) -> tuple[float, str]:
    """Least time for the case's work: inputs read once (of x in a gather,
    the rows named) and the output written once at the memory rate, or its
    operations at the peak rate, whichever is longer."""
    import torch

    nbytes = sum(a.numel() * a.element_size() for a in args
                 if hasattr(a, "numel")) + out.numel() * out.element_size()
    if kernel == "bucket_spmm":
        # a gather needs only the rows of x that some neighbour names
        nbr, w, x = args
        rows = torch.unique(nbr).numel()
        nbytes -= (x.shape[0] - rows) * x.shape[1] * x.element_size()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if kernel != "flash_attention":
        return bytes_ms, "bytes"
    q, k, _ = args
    b, sq, hq, dh = q.shape
    flops = 4 * dh * b * hq * attention_pairs(sq, k.shape[1], kw["causal"],
                                              kw["window"])
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def device_time_by_kernel(fn, calls: int = 3) -> str:
    """Traced calls of ``fn()``: device microseconds a launch, by kernel
    name (averaged over the launches traced: a trace can miss the first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / e.count, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return "; ".join(f"{name[:60]} {us:.1f} us (x{n})"
                     for us, n, name in sorted(rows, reverse=True))


def api_phase(g, labels, profile=False) -> list[dict]:
    """Phase 5: the kernel API through ``repro_torch.kernels.ops`` at
    full-width shapes; returns the kernels' JSON entries.  With
    ``profile``, each ``segsum`` case is traced three times more."""
    import torch

    from repro_torch.kernels.flash_attn import (launch_kernel,
                                                tensor_core_route)

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    cases = api_cases(g, labels)
    wrappers = api_wrappers()
    flash = wrappers["flash_attention"]
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    flash.tensor_core_launches = 0
    outs = [op(*args, **kw) for _, _, op, args, kw in cases]
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    flash_routes = {TENSOR_CORE_KERNEL: flash.tensor_core_launches,
                    "flash_fwd_kernel": flash.launches
                    - flash.tensor_core_launches}
    log(f"  launches on the API run: {launches}; flash_attention by "
        f"route: {flash_routes}")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"the kernel API launched no {k} kernel")
    # every full-width flash case is bf16: each must take the tensor cores
    flash_cases = [args for kernel, _, _, args, _ in cases
                   if kernel == "flash_attention"]
    if not all(tensor_core_route(*a) for a in flash_cases) or \
            flash_routes[TENSOR_CORE_KERNEL] != len(flash_cases):
        raise AssertionError(
            f"{len(flash_cases)} flash cases, {flash_routes} launches: not "
            f"all went through {TENSOR_CORE_KERNEL}")

    entries = {}
    for (kernel, name, op, args, kw), got in zip(cases, outs):
        err, stated, plain = check_case(kernel, name, op, args, kw, got)
        bound_ms, bound_by = case_bound(kernel, name, args, kw, got)
        ms = median_ms(lambda: op(*args, **kw))
        plain_ms = median_ms(lambda: plain(*args, **kw))
        lib, lib_name = library_call(kernel, name, args, kw)
        if lib is None:     # the plain version is that one library call
            library_ms = plain_ms
        else:
            library_ms = median_ms(lib)
        torch.cuda.empty_cache()
        log(f"  {name}: max_abs_err={err} ({stated})")
        log(f"    ms={ms}  bound_ms={bound_ms} ({bound_by})  "
            f"plain_ms={plain_ms}  library_ms={library_ms} [{lib_name}]")
        variant = dict(case=name, max_abs_err=err, tolerance=stated, ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms,
                       library=lib_name)
        if profile and kernel == "onehot_segsum":
            log(f"    traced calls, device time a launch by kernel: "
                f"{device_time_by_kernel(lambda: op(*args, **kw))}")
        if kernel == "flash_attention":
            # the CUDA-core kernel on the same inputs, for comparison on
            # this card (uncounted: not the path's launch)
            spare = torch.empty_like(args[0])
            variant["cuda_core_ms"] = median_ms(lambda: launch_kernel(
                *args, spare, tensor_cores=False, **kw))
            log(f"    flash_fwd_kernel (CUDA cores) on the same inputs: "
                f"ms={variant['cuda_core_ms']}")
            del spare
        source, replaces = API_SOURCES[kernel]
        entry = entries.setdefault(kernel, dict(
            name=kernel, route="cuda", source=source, replaces=replaces,
            launches=launches[kernel], max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, variants=[]))
        if kernel == "flash_attention":
            entry["launches_by_route"] = flash_routes
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["variants"].append(variant)
    del outs, cases
    torch.cuda.empty_cache()
    return list(entries.values())


def small_phase():
    """Phase 3: card vs CPU, labels equal, zero disconnected."""
    import torch

    from repro_torch.core import detect
    from repro_torch.graph import rmat_graph, sbm_graph

    graphs = {
        "rmat_graph(scale=12, edge_factor=8, seed=1)":
            lambda d: rmat_graph(scale=12, edge_factor=8, seed=1, device=d),
        "sbm_graph(2048, 24, 0.12, 0.002, seed=2)":
            lambda d: sbm_graph(2048, 24, 0.12, 0.002, seed=2, device=d)[0],
    }
    for name, make in graphs.items():
        on_card = detect(make("cuda"))
        on_cpu = detect(make("cpu"), device="cpu")
        equal = torch.equal(on_card.labels.cpu(), on_cpu.labels)
        log(f"  {name}: labels equal={equal}  communities="
            f"{on_card.n_communities}/{on_cpu.n_communities}  disconnected="
            f"{on_card.n_disconnected}/{on_cpu.n_disconnected}  Q="
            f"{on_card.modularity:.9f}/{on_cpu.modularity:.9f}")
        if not equal or on_card.n_disconnected or on_cpu.n_disconnected:
            raise AssertionError(f"card vs CPU mismatch on {name}")


def profile_phase(g):
    """A second, traced detect(): device time by kernel and the device's
    busy share of the traced wall time (kernels run on one stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import detect

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        detect(g)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"  traced detect: wall={wall} s  device busy={busy_us / 1e6} s "
        f"({100 * busy_us / 1e6 / wall} %)")
    log(events.table(sort_by="self_device_time_total", row_limit=25,
                     max_name_column_width=70))
    seg = sorted(((e.self_device_time_total, e.count, e.key) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "segreduce" in e.key), reverse=True)
    for us, n, name in seg:
        log(f"  {name[:100]}: {us / 1e3} ms device, {n} launches")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=21,
                    help="R-MAT scale of the full-size graph (default 21)")
    ap.add_argument("--profile", action="store_true",
                    help="after phase 4, run detect() once more under "
                    "torch.profiler and print device time by kernel; trace "
                    "one call of each segsum case of phase 5 too")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import detect
    from repro_torch.graph import rmat_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.segsum import segreduce_sorted_cuda

    card = card_line()
    log("phase 1: environment")
    log(f"  card: {card}")
    log(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"  kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(reports) or 'cached'})")
    for name, rep in reports.items():
        for line in rep.strip().splitlines():
            log(f"    [{name}] {line}")
    for line in ptxas_lines(reports.get("flash_attn", ""),
                            TENSOR_CORE_KERNEL) or [
            "flash_attn cached: no build report in this run"]:
        log(f"  ptxas: {line}")

    t0 = time.perf_counter()
    g = rmat_graph(scale=args.scale, edge_factor=16, seed=1, device="cuda")
    log(f"  graph rmat_graph(scale={args.scale}, edge_factor=16, seed=1): "
        f"n_cap={g.n_cap} m_cap={g.m_cap}, built on the host in "
        f"{time.perf_counter() - t0:.1f} s")

    log("phase 2: kernel vs plain, on the card")
    entry = kernel_phase(g)

    log("phase 3: end to end, small, card vs CPU")
    small_phase()

    log("phase 4: end to end, full size, on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phase_seconds = {}
    segreduce_sorted_cuda.launches = 0
    t0 = time.perf_counter()
    res = detect(g, phase_seconds=phase_seconds)
    wall = time.perf_counter() - t0
    launches = segreduce_sorted_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = res.stats
    log(f"  passes={st['passes']}  sweeps(li_total)={st['li_total']}  "
        f"communities={res.n_communities}  disconnected={res.n_disconnected}"
        f"  modularity={res.modularity:.6f}")
    log(f"  wall seconds: total={wall}  " + "  ".join(
        f"{k}={v}" for k, v in sorted(phase_seconds.items())))
    log(f"  segreduce_sorted launches={launches}  peak device memory="
        f"{peak:.2f} GiB")
    if res.n_disconnected != 0:
        raise AssertionError(f"{res.n_disconnected} disconnected communities")
    if not 0.0 < res.modularity < 1.0:
        raise AssertionError(f"modularity {res.modularity} not in (0, 1)")
    if launches == 0:
        raise AssertionError("the main path launched no segreduce kernel")
    labels = res.labels[: int(g.n_nodes)]
    if int(labels.min()) < 0 or int(labels.max()) >= res.n_communities:
        raise AssertionError("labels out of [0, n_communities)")

    if args.profile:
        profile_phase(g)

    log("phase 5: the kernel API vs plain, on the card")
    api_entries = api_phase(g, res.labels, profile=args.profile)

    entry["launches"] = launches
    log(json.dumps({"kernels": [entry] + api_entries}))
    log(card)
    # the run uses one card, whatever else the machine holds
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
