#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py            # needs one CUDA card, nvcc and the repo

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (ptxas registers, shared memory and spills of the tensor-core flash,
   cumsum and spmm kernels).
2. Kernel vs plain, on the card, at the main path's sizes (the edge arrays
   of the full-size graph of phase 4): every (op, dtype, D) the main path
   uses, with empty segments, the graph's hub segments and a 96-row
   in-order fold; one segment of all M rows; the run-field layout (ids
   ``0..n_runs-1`` over ``m_cap`` slots, an empty tail of tens of millions
   of segments); a small case of ±0 ties and NaNs; an f32 sum with one
   segment of 2^22 rows (about 2,048 tiles handing a carry on) among the
   src segments.  Exactness is required
   bit for bit (int32 bits of float32, NaN bits included).  f32 sums and
   the ±0/NaN case are held against the plain version run on a CPU copy of
   the same inputs, because on CUDA the plain version's ``index_add_`` is
   atomic and folds in no fixed order; the other max/min and int32 results
   are held against the plain version on the card, which is exact in any
   order there.  Prints each case's route (``in-order`` or ``tiled``,
   ``kernels/segsum.py:route``), median time, byte bound (and for the
   in-order route the chain bound: the longest segment's rows times 4
   cycles of dependent float adds at the card's maximum SM clock, and the
   kernel's time on that segment alone), the
   plain version's time and the library call's (``index_add_`` /
   ``scatter_reduce_``), which the port never calls.  Then the fixed-order
   flat sum of the three decision sums (``ops.sum_inorder``) on the graph's
   edge weights, bit for bit between the card and the CPU.
3. End to end, small: ``detect()`` on the card and on the CPU, for every
   tier and split policy, give equal labels, stats and modularity bits,
   and zero disconnected communities wherever the run promises it
   (max-quality, and the standard tier with a split policy).  Then the
   dense scan at its full width, ``nv = 1025`` in the largest default
   service bucket (``sbm_graph(1024, 16, 0.2, 0.003, seed=3, n_cap=1024,
   m_cap=16384)``): for every tier and split policy, ``scan='dense'`` on
   the card, on the CPU and ``scan='sort'`` on the card all equal, each
   card run with its wall time and segment-reduce launches;
   ``DetectOptions.resolved_scan`` against the reference's answers; and
   ``update_communities`` with a seeded churn batch (removals, wired
   additions, deletions, insertions) on that graph with each scan and on
   the SBM below (sort only), card and CPU and both scans giving the same
   graph, labels and stats (Q bits included) and no disconnected
   community.
4. End to end, full size, on ``rmat_graph(scale=21, edge_factor=16,
   seed=1)`` (about 2.1M vertices and 63.5M directed edges, the scale of
   com-LiveJournal): ``detect()`` with default options (zero disconnected
   communities, a modularity in (0, 1)), then with 'max-quality' (zero
   disconnected; its two candidates' modularities ``q_r`` and ``q_s``, the
   same bits on the card and the CPU, and its pick) and with 'fast'
   (LPA: its disconnected count reported), then ``louvain_staged`` (the
   labels of the default ``detect()``).  Then one update batch at full
   size from the default ``detect()``'s labels: 1,024 vertices removed,
   1,024 added (each wired to 2), 32,768 undirected edges deleted and
   16,384 inserted, with fewer slots filled than freed; the host prepare
   (``prepare_graph_update``) timed apart from the warm update on the card
   (zero disconnected, Q in (0, 1)), which runs twice on the same inputs
   with the same bits.  Each run prints its wall time, peak device memory
   and segment-reduce launches, whose count is set to 0 just before it and
   must be above 0 after it.

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
   (``kernels/onehot_segsum.py:emulate``); ``spmm`` beside the bytes its
   gathers move through L2.  Both flash cases are
   bf16 and must go through the tensor-core kernel (``flash_fwd_wgmma``):
   the flash entry counts launches by route.  Then the median time of
   each case, its bound, the plain version's time and one PyTorch call's.

6. The batched engine and the result store, on the card
   (``repro_torch.service``): 32 graphs of phase 3's family,
   ``sbm_graph(1024, 16, 0.2, 0.003, seed=s, n_cap=1024, m_cap=16384)``
   for the first 32 seeds from 3 that fit the largest default bucket
   ``Bucket(1024, 16384)`` (3..35 but 11),
   and 32 ego-nets, ``sbm_graph(56, 4, 0.7, 0.08, seed=s)`` for s = 0..31
   admitted into ``Bucket(64, 2048)`` (the reference's service workload,
   at its batch of 32).  ``engine.warm(bucket)`` (one filler graph a
   tier), then ``detect_batch`` of the 32 graphs with each tier; every
   result must equal ``detect()`` of the same graph on the card (labels,
   ``n_communities``, ``n_disconnected``, ``fraction``, the stats and Q's
   bits) and launch the segment reduce as often as the loop of
   ``detect()`` does, with 0 disconnected for standard and max-quality.  Each batch prints its wall
   time, graphs/s, the same 32 graphs through a loop of ``detect()`` and
   the ratio of the two, segment-reduce launches and sweeps (one host
   sync each) a batch and wall ms a sweep.  Then, on the large bucket, 32
   churn items (phase 3's 16 removals, 8 additions, 64 deletions, 32
   insertions) prepared by ``ResultStore.prepare_update`` from the
   standard labels go through ``update_batch``, and must equal, bit for
   bit, 32 immediate ``ResultStore.apply_update`` calls on a second store.

``--profile`` adds a traced run of phase 4's ``detect()`` of each tier
(device time by kernel, the device's busy share, and each segment-reduce
kernel's total), in phase
5, three traced calls of each ``segsum``, ``cumsum`` and ``spmm`` case
(device time a call by kernel), and in phase 6 one traced standard batch
of each bucket (CUDA kernel launches and the device's busy share).  The second-to-last lines are
one JSON object for the kernels (``kernels``) and the card line; the last
line is the result object.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
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
FADD_CYCLES = 4                  # latency of a dependent float32 add, cycles
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


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock (``nvidia-smi clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def longest_segment(ids) -> tuple[int, int]:
    """First row and rows of the longest run of equal ids."""
    import torch

    counts = torch.unique_consecutive(ids, return_counts=True)[1]
    k = int(counts.argmax())
    return int(counts[:k].sum()), int(counts[k])


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
    # one segment of 2^22 rows among the src segments, starting mid-tile
    long_rows = min(2**22, m // 2)
    a = m // 3
    long_src = src.clone()
    long_src[a: a + long_rows] = src[a]
    clock_mhz = max_sm_clock_mhz()
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
        (f"sum f32 D=1 (a {long_rows}-row segment among the src segments)",
         f32(1), long_src, g.nv, "sum"),
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
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        variant = dict(case=name, route=how, rows=v.shape[0], segments=nseg,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bytes_ms, bound_by="bytes",
                       library_ms=library_ms)
        chain = ""
        if how == "in-order":
            # a segment's adds depend on each other: its rows x the add's
            # latency, at the card's top clock, however the rows are split;
            # and the kernel's time on that segment alone, its carry chain
            first, rows = longest_segment(ids)
            chain_ms = rows * FADD_CYCLES / (clock_mhz * 1e6) * 1e3
            alone = v[first: first + rows].contiguous()
            one = torch.zeros(rows, dtype=torch.int32, device=dev)
            alone_ms = median_ms(
                lambda: ops.segreduce_sorted(alone, one, 1, op=op))
            del alone, one
            variant.update(bytes_bound_ms=bytes_ms, chain_bound_ms=chain_ms,
                           longest_segment=rows, sm_clock_mhz=clock_mhz,
                           longest_alone_ms=alone_ms,
                           bound_ms=max(bytes_ms, chain_ms),
                           bound_by="bytes" if bytes_ms >= chain_ms
                           else "operations")
            chain = (f"  chain_bound_ms={chain_ms:.4f} ({rows} rows x "
                     f"{FADD_CYCLES} cycles at {clock_mhz:.0f} MHz)  "
                     f"longest_alone_ms={alone_ms:.4f}")
        variants.append(variant)
        log(f"  {name} [{how}]: bit-identical  ms={ms:.4f}  "
            f"bytes_bound_ms={bytes_ms:.4f}{chain}  plain_ms={plain_ms:.4f}  "
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

    # the decision sums' fixed order (2m here): the same bits on both devices
    two_m = ops.sum_inorder(g.w)
    two_m_cpu = ops.sum_inorder(g.w.cpu())
    if not torch.equal(two_m.cpu().view(torch.int32), two_m_cpu.view(torch.int32)):
        raise AssertionError(f"sum_inorder(g.w): card {float(two_m)} != CPU "
                             f"{float(two_m_cpu)}")
    log(f"  sum_inorder(g.w) = 2m: card == CPU bit for bit ({float(two_m)}; "
        f"exact {float(g.w.double().sum())}, torch.sum on the card "
        f"{float(g.w.sum())})")

    head = variants[0]
    entry = dict(name="segreduce_sorted", route="cuda", source=SOURCE,
                 replaces=REPLACES, launches=0, max_abs_err=worst,
                 ms=head["ms"], plain_ms=head["plain_ms"],
                 bound_ms=head["bound_ms"], bound_by=head["bound_by"],
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


# (source, kernel) whose ptxas report phase 1 prints, one line an instance
PTXAS_KERNELS = (("flash_attn", TENSOR_CORE_KERNEL), ("cumsum", "cumsum_rows"),
                 ("cumsum", "cumsum_cols"), ("spmm", "bucket_spmm_kernel"))


def demangle(names: list[str]) -> list[str]:
    """``names`` (mangled) through the CUDA toolkit's ``cu++filt``; as
    they were where it cannot run."""
    from repro_torch.kernels import _build

    try:
        filt = os.path.join(os.path.dirname(_build.nvcc_path()), "cu++filt")
        out = subprocess.run([filt], input="\n".join(names), text=True,
                             capture_output=True, check=True).stdout
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return names
    lines = out.splitlines()
    if len(lines) != len(names):
        return names
    return [line.removeprefix("void ").replace("<unnamed>::", "")
            for line in lines]


def ptxas_lines(report: str, kernel: str) -> list[str]:
    """One line for each entry function of an ``nvcc -Xptxas -v`` report
    whose (mangled) name contains ``kernel``: its demangled signature,
    then what ptxas says of registers, shared memory, stack and spills."""
    entries, cur = [], None
    for line in report.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            cur = None
            m = re.search(r"entry function '(\w+)'", line)
            if m and kernel in m[1]:
                cur = [m[1]]
                entries.append(cur)
        elif cur is not None and "Function properties" not in line and \
                "Compile time" not in line:
            cur.append(line.removeprefix("ptxas info    : "))
    names = demangle([e[0] for e in entries]) if entries else []
    return [": ".join((name, "; ".join(e[1:])))
            for name, e in zip(names, entries)]


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
        # the bound of the earlier three-pass design, kept (csrc/cumsum.cu)
        depth = 64 + -(-x2.shape[0] // 2**20)
        tol = depth * U32 * torch.cumsum(xt.abs(), 1).t()
        del xt
        err = (got.reshape(x2.shape).double() - exact).abs()
        del exact
        log(f"    rounding depth seen: largest |err| / (2^-24 * prefix of "
            f"|x|) = {float((err / tol.clamp_min(1e-300)).max()) * depth} "
            f"(csrc/cumsum.cu: at most 19 to first order)")
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
    ``profile``, each ``segsum``, ``cumsum`` and ``spmm`` case is traced
    three times more."""
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
        if profile and kernel in ("onehot_segsum", "cumsum", "bucket_spmm"):
            log(f"    traced calls, device time a call by kernel: "
                f"{device_time_by_kernel(lambda: op(*args, **kw))}")
        if kernel == "bucket_spmm":
            nbr, _, x = args
            variant["gathered_bytes"] = nbr.numel() * x.shape[1] * \
                x.element_size()
            log(f"    gathered through L2: {variant['gathered_bytes'] / 1e9} "
                f"GB (N*K*D*sizeof(x); the bound counts each named row of x "
                f"once)")
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


def tier_runs() -> list[tuple[str, str]]:
    """Every (tier, split policy) that ``detect()`` runs: the standard tier
    with each of the eight split policies, then 'fast' and 'max-quality'
    with the default split."""
    from repro_torch.core.louvain import SPLITS

    return [("standard", s) for s in SPLITS] + [("fast", "sp-pj"),
                                                ("max-quality", "sp-pj")]


def promises_connected(algorithm: str, split: str) -> bool:
    """Whether a run promises zero disconnected communities: max-quality,
    and the standard tier with a split policy (plain Louvain, 'none', and
    LPA, 'fast', do not)."""
    return algorithm == "max-quality" or (
        algorithm == "standard" and split != "none")


def small_phase():
    """Phase 3: card vs CPU on two small graphs, every tier and split
    policy: labels, stats and modularity bits equal, and zero disconnected
    communities wherever the run promises it."""
    import torch

    from repro_torch.core import DetectOptions, LouvainConfig, detect
    from repro_torch.graph import rmat_graph, sbm_graph

    graphs = {
        "rmat_graph(scale=12, edge_factor=8, seed=1)":
            lambda d: rmat_graph(scale=12, edge_factor=8, seed=1, device=d),
        "sbm_graph(2048, 24, 0.12, 0.002, seed=2)":
            lambda d: sbm_graph(2048, 24, 0.12, 0.002, seed=2, device=d)[0],
    }
    for name, make in graphs.items():
        g_card, g_cpu = make("cuda"), make("cpu")
        for algorithm, split in tier_runs():
            opts = DetectOptions(algorithm=algorithm,
                                 louvain=LouvainConfig(split=split))
            on_card = detect(g_card, options=opts)
            on_cpu = detect(g_cpu, options=opts, device="cpu")
            equal = torch.equal(on_card.labels.cpu(), on_cpu.labels) and \
                on_card.stats == on_cpu.stats
            same_q = on_card.modularity == on_cpu.modularity
            log(f"  {name} {algorithm}/{split}: labels and stats equal="
                f"{equal}  Q bits equal={same_q}  communities="
                f"{on_card.n_communities}/{on_cpu.n_communities}  "
                f"disconnected={on_card.n_disconnected}/"
                f"{on_cpu.n_disconnected}  Q={on_card.modularity:.9f}")
            broken = promises_connected(algorithm, split) and (
                on_card.n_disconnected or on_cpu.n_disconnected)
            if not equal or not same_q or broken or \
                    on_card.n_disconnected != on_cpu.n_disconnected:
                raise AssertionError(
                    f"card vs CPU mismatch on {name}, {algorithm}/{split}")


DENSE_GRAPH = ("sbm_graph(1024, 16, 0.2, 0.003, seed=3, n_cap=1024, "
               "m_cap=16384)")
CHURN_GRAPH = "sbm_graph(2048, 24, 0.12, 0.002, seed=2)"


def dense_graph(device):
    """The dense scan's full-width graph: ``nv = 1025`` (``dense_max_nv``)
    in the largest default service bucket, ``Bucket(1024, 16384)``."""
    from repro_torch.graph import sbm_graph

    return sbm_graph(1024, 16, 0.2, 0.003, seed=3, n_cap=1024, m_cap=16384,
                     device=device)[0]


def churn_graph(device):
    from repro_torch.graph import sbm_graph

    return sbm_graph(2048, 24, 0.12, 0.002, seed=2, device=device)[0]


def same_detection(a, b) -> bool:
    """Labels, stats, modularity bits and disconnected counts equal."""
    import torch

    return (torch.equal(a.labels.cpu(), b.labels.cpu()) and a.stats == b.stats
            and a.modularity == b.modularity
            and a.n_disconnected == b.n_disconnected)


def dense_phase() -> int:
    """Phase 3, the dense scan at its full width: ``detect()`` with
    ``scan='dense'`` on the card and on the CPU and with ``scan='sort'`` on
    the card, for every tier and split policy, all equal, and zero
    disconnected communities wherever the run promises it.  Each card run
    alone, with its wall time and segment-reduce launches.  Returns the
    launches of the dense standard run."""
    from repro_torch.core import DetectOptions, LouvainConfig, detect

    g_card, g_cpu = dense_graph("cuda"), dense_graph("cpu")
    n_live = int((g_cpu.src < g_cpu.n_cap).sum())
    if n_live > g_cpu.m_cap:
        raise AssertionError(f"{DENSE_GRAPH}: {n_live} edges do not fit")
    log(f"  {DENSE_GRAPH}: nv={g_cpu.nv}, {n_live} directed edges in "
        f"m_cap={g_cpu.m_cap}")
    standard_launches = 0
    for algorithm, split in tier_runs():
        def opts(scan):
            return DetectOptions(algorithm=algorithm, scan=scan,
                                 louvain=LouvainConfig(split=split))

        dense, wall, n, _ = timed_path(
            lambda: detect(g_card, options=opts("dense")))
        sort, wall_sort, n_sort, _ = timed_path(
            lambda: detect(g_card, options=opts("sort")))
        on_cpu = detect(g_cpu, options=opts("dense"), device="cpu")
        equal = same_detection(dense, on_cpu) and same_detection(dense, sort)
        log(f"  dense {algorithm}/{split}: card dense == CPU dense == card "
            f"sort (labels, stats, Q bits)={equal}  communities="
            f"{dense.n_communities}  disconnected={dense.n_disconnected}  "
            f"sweeps={dense.stats['li_total']}  Q={dense.modularity:.9f}  "
            f"card wall dense={wall} s ({n} segreduce launches)  sort="
            f"{wall_sort} s ({n_sort})")
        if not equal or (promises_connected(algorithm, split)
                         and dense.n_disconnected):
            raise AssertionError(
                f"dense scan mismatch on {DENSE_GRAPH}, {algorithm}/{split}")
        if (algorithm, split) == ("standard", "sp-pj"):
            standard_launches = n
    return standard_launches


def crossover_checks():
    """``scan='auto'``: the reference's ``choose_scan`` answers for the
    shapes of its service test (tests/test_service.py), with the density
    given, and 'dense' for every graph of at most 129 node slots."""
    from repro_torch.core import DetectOptions

    want = {(65, 512): "dense", (257, 2048): "dense", (257, 1024): "sort",
            (1025, 16384): "sort", (1025, 65536): "dense",
            (2049, 10**6): "sort"}
    opts = DetectOptions(dense_min_density=0.02)
    got = {shape: opts.resolved_scan(*shape) for shape in want}
    small = DetectOptions().resolved_scan(129, 10**6)
    log(f"  resolved_scan: {got}; nv=129: {small}")
    if got != want or small != "dense":
        raise AssertionError("resolved_scan differs from the reference's")


def churn_batch(g, *, seed, remove, add, delete, insert):
    """A seeded update batch with every kind of operation, made on the
    host from ``g``: ``remove`` live vertices, ``add`` new vertices each
    wired to 2 surviving ones, ``delete`` surviving undirected edges
    (``dw = -w``) and ``insert`` new undirected edges of weight 1 between
    survivors.  Edge ids are in the post-rewrite id space.  Returns
    ``(GraphUpdate, directed slots freed, directed slots filled)``."""
    import numpy as np

    from repro_torch.core import GraphUpdate

    src, dst, w = (t.cpu().numpy() for t in (g.src, g.dst, g.w))
    n, nv = int(g.n_nodes), g.nv
    rng = np.random.default_rng(seed)
    rem = np.sort(rng.choice(n, remove, replace=False))
    alive = np.zeros(nv, bool)
    alive[:n] = True
    alive[rem] = False
    perm = np.full(nv, -1, np.int64)
    perm[np.flatnonzero(alive)] = np.arange(n - remove)
    n_keep = n - remove
    live = src < g.n_cap
    ps, pd = perm[src], perm[dst]
    freed = int((live & ((ps < 0) | (pd < 0))).sum()) + 2 * delete
    both = live & (ps >= 0) & (pd >= 0)
    idx = rng.choice(np.flatnonzero(both & (src < dst)), delete,
                     replace=False)
    # survivors' keys in the new id space stay sorted (perm keeps order)
    keys = ps[both] * (nv + 1) + pd[both]
    lo, hi = rng.integers(0, n_keep, (2, 4 * insert))
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    cand = lo * (nv + 1) + hi
    pos = np.minimum(np.searchsorted(keys, cand), keys.size - 1)
    fresh = (lo != hi) & (keys[pos] != cand)
    _, first = np.unique(cand, return_index=True)
    pick = np.sort(first[fresh[first]])[:insert]
    if pick.size < insert:
        raise AssertionError("too few new edges drawn")
    new = np.arange(n_keep, n_keep + add)
    a = rng.integers(0, n_keep, add)
    b = (a + rng.integers(1, n_keep, add)) % n_keep    # a second, distinct
    u = np.concatenate([ps[idx], np.repeat(new, 2), lo[pick]])
    v = np.concatenate([pd[idx], np.stack([a, b], 1).ravel(), hi[pick]])
    dw = np.concatenate([-w[idx], np.ones(2 * add + insert, np.float32)])
    filled = 2 * (2 * add + insert)
    return (GraphUpdate(u=u, v=v, dw=dw.astype(np.float32), add=add,
                        remove=rem), freed, filled)


def same_update(a, b) -> bool:
    """Two ``update_communities`` results: graph arrays, labels and stats
    (Q as float32 bits) equal."""
    import torch

    (ga, Ca, sa), (gb, Cb, sb) = a, b
    return (all(torch.equal(getattr(ga, k).cpu(), getattr(gb, k).cpu())
                for k in ("src", "dst", "w", "n_nodes"))
            and torch.equal(Ca.cpu(), Cb.cpu()) and sa == sb)


def dynamic_small_phase() -> int:
    """Phase 3, ``update_communities``: a seeded churn batch on the dense
    graph (each scan) and on the SBM above ``dense_max_nv`` (sort only),
    from the standard tier's labels.  Card and CPU, and the two scans,
    give equal graphs, labels and stats (Q bits included), with no
    disconnected community.  Returns the launches of the dense card run."""
    from repro_torch.core import detect, update_communities

    dense_launches = 0
    for name, make, scans, seed in ((DENSE_GRAPH, dense_graph,
                                     ("sort", "dense"), 5),
                                    (CHURN_GRAPH, churn_graph, ("sort",), 6)):
        g_card, g_cpu = make("cuda"), make("cpu")
        labels = detect(g_card).labels
        upd, freed, filled = churn_batch(g_cpu, seed=seed, remove=16, add=8,
                                         delete=64, insert=32)
        first = None
        for scan in scans:
            on_card, wall, n, _ = timed_path(lambda: update_communities(
                g_card, labels, upd, scan=scan))
            on_cpu = update_communities(g_cpu, labels.cpu(), upd, scan=scan,
                                        device="cpu")
            first = first or on_card
            st = on_card[2]
            equal = same_update(on_card, on_cpu)
            same_scans = same_update(on_card, first)
            log(f"  update {name} {scan}: card == CPU (graph, labels, stats, "
                f"Q bits)={equal}  == sort scan={same_scans}  slots freed "
                f"{freed} >= filled {filled}  iterations={st['iterations']}"
                f"  affected={st['n_affected']}  communities="
                f"{st['n_communities']}  disconnected={st['n_disconnected']}"
                f"  Q={st['q']:.9f}  card wall={wall} s ({n} segreduce "
                f"launches)")
            if not (equal and same_scans) or st["n_disconnected"] \
                    or on_cpu[2]["n_disconnected"]:
                raise AssertionError(f"update mismatch on {name}, {scan}")
            if scan == "dense":
                dense_launches = n
    return dense_launches


def dynamic_phase(g, labels) -> int:
    """Phase 4, one update batch at full size from the standard tier's
    labels: 1,024 vertices removed, 1,024 added (each wired to 2), 32,768
    undirected edges deleted and 16,384 inserted.  The host folds apart
    from the warm update on the card, which runs twice on the same inputs
    and must give the same bits.  Returns the warm update's launches."""
    import torch

    from repro_torch.core.dynamic import prepare_graph_update, warm_update

    t0 = time.perf_counter()
    upd, freed, filled = churn_batch(g, seed=21, remove=1024, add=1024,
                                     delete=32768, insert=16384)
    t_make = time.perf_counter() - t0
    if filled > freed:
        raise AssertionError(f"the batch fills {filled} slots > {freed} freed")
    t0 = time.perf_counter()
    g_new, C_host, touched, info = prepare_graph_update(g, labels, upd)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    C0 = torch.from_numpy(C_host).cuda()
    T0 = torch.from_numpy(touched).cuda()
    out, wall, n, peak = timed_path(lambda: warm_update(g_new, C0, T0))
    again = warm_update(g_new, C0, T0)
    same = torch.equal(out["C"], again["C"]) and out["q"] == again["q"]
    log(f"  update_communities: batch made in {t_make} s (slots freed "
        f"{freed} >= filled {filled}); host prepare={t_prep} s (n_deleted="
        f"{info['n_deleted']} n_added={info['n_added']} n_removed="
        f"{info['n_removed']}); warm update on the card={wall} s  "
        f"iterations={out['iterations']}  affected={out['n_affected']}  "
        f"split_moved={out['split_moved']}  communities="
        f"{out['n_communities']}  disconnected={out['n_disconnected']}  "
        f"Q={out['q']:.6f}  segreduce launches={n}  peak device memory="
        f"{peak:.2f} GiB  second run same bits={same}")
    if out["n_disconnected"] != 0:
        raise AssertionError(f"{out['n_disconnected']} disconnected after "
                             "the update")
    if not 0.0 < out["q"] < 1.0:
        raise AssertionError(f"update: modularity {out['q']} not in (0, 1)")
    if not same:
        raise AssertionError("a second warm_update gave other bits")
    return n


def timed_path(fn):
    """Run ``fn()`` once on the card with the segment-reduce kernel's
    launch count set to 0 just before: ``(result, wall seconds, launches,
    peak device GiB)``.  Raises if the path launched the kernel no time."""
    import torch

    from repro_torch.kernels.segsum import segreduce_sorted_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    segreduce_sorted_cuda.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segreduce_sorted_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches == 0:
        raise AssertionError("the path launched no segreduce kernel")
    return out, wall, launches, peak


def same_bits(a, b) -> bool:
    """float32 tensors equal as int32 bits (on the host)."""
    import torch

    return torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


def tiers_phase(g, standard) -> dict:
    """Phase 4, the other paths at full size: ``detect()`` with
    'max-quality' and with 'fast', and ``louvain_staged``; each run alone
    with the launch count set to 0 just before.  ``standard`` is phase 4's
    default ``detect()``.  Returns the launches by path."""
    import torch

    from repro_torch.core import (DetectOptions, LouvainConfig, detect,
                                  disconnected_communities, louvain_impl,
                                  louvain_staged, modularity, tier_config)
    from repro_torch.graph.container import strip_padding

    # the module (``repro_torch.core.louvain`` names the function)
    louvain_mod = importlib.import_module("repro_torch.core.louvain")

    split_unconnected = louvain_mod._split_unconnected

    launches = {}
    for algorithm in ("max-quality", "fast"):
        phases = {}
        res, wall, n, peak = timed_path(lambda: detect(
            g, options=DetectOptions(algorithm=algorithm),
            phase_seconds=phases))
        launches[f"detect {algorithm}"] = n
        st = res.stats
        log(f"  detect {algorithm}: wall={wall} s  segreduce_sorted "
            f"launches={n}  peak device memory={peak:.2f} GiB  communities="
            f"{res.n_communities}  disconnected={res.n_disconnected}  "
            f"modularity={res.modularity:.6f}  passes={st['passes']}  "
            f"li_total={st['li_total']}")
        log("    phase seconds: " + "  ".join(
            f"{k}={v}" for k, v in sorted(phases.items())))
        if not 0.0 < res.modularity < 1.0 and algorithm != "fast":
            raise AssertionError(f"{algorithm}: modularity {res.modularity}")
        if algorithm == "fast":
            continue
        if res.n_disconnected != 0:
            raise AssertionError(f"max-quality: {res.n_disconnected} "
                                 "disconnected communities")
        # the two candidates again, to show the pick: the GSP one is the
        # default detect() of phase 4; Q of each on the card and the CPU.
        # The refined one's communities that came out unconnected, before
        # the pass loop splits them (the reference keeps them: ROADMAP C.7)
        live = strip_padding(g.src, g.dst, g.w, g.ghost)
        unconnected = []

        def count_then_split(live_, C, node_mask):
            det = disconnected_communities(*live_, C, g.n_nodes)
            unconnected.append(int(det["n_disconnected"]))
            return split_unconnected(live_, C, node_mask)

        louvain_mod._split_unconnected = count_then_split
        try:
            t0 = time.perf_counter()
            C_r, _ = louvain_impl(g, tier_config("max-quality",
                                                 LouvainConfig()))
            torch.cuda.synchronize()
            t_r = time.perf_counter() - t0
        finally:
            louvain_mod._split_unconnected = split_unconnected
        live_cpu = [t.cpu() for t in live]
        q = {}
        for key, C in (("q_r", C_r), ("q_s", standard.labels)):
            q[key] = modularity(*live, C)
            q_cpu = modularity(*live_cpu, C.cpu())
            if not same_bits(q[key], q_cpu):
                raise AssertionError(f"{key}: card {float(q[key])} != CPU "
                                     f"{float(q_cpu)}")
        take_r = bool(q["q_r"] >= q["q_s"])
        want = C_r if take_r else standard.labels
        log(f"    q_r={float(q['q_r'])!r}  q_s={float(q['q_s'])!r} (card == "
            f"CPU bit for bit)  pick={'refine' if take_r else 'sp-pj'}  "
            f"refine candidate alone {t_r} s (with a detector run), "
            f"unconnected before its final split: {unconnected}")
        if not torch.equal(res.labels, want):
            raise AssertionError("max-quality's labels are not its pick's")

    (C, st), wall, n, peak = timed_path(lambda: louvain_staged(g))
    launches["louvain_staged"] = n
    equal = torch.equal(C, standard.labels)
    log(f"  louvain_staged: wall={wall} s  segreduce_sorted launches={n}  "
        f"peak device memory={peak:.2f} GiB  communities="
        f"{st['n_communities']}  passes={st['passes']}  labels equal to "
        f"detect()'s={equal}")
    log("    phase seconds: " + "  ".join(
        f"{k}={v}" for k, v in sorted(st["phase_seconds"].items())) +
        f"  pass seconds: {st['pass_seconds']}")
    if len(st["pass_seconds"]) != st["passes"]:
        raise AssertionError("louvain_staged: a pass time is missing")
    if not equal:
        raise AssertionError("louvain_staged's labels differ from detect()'s "
                             "(float64 tau: see ROADMAP queue C)")
    return launches


def profile_phase(g, algorithm="standard"):
    """A second, traced detect() of a tier: device time by kernel and the
    device's busy share of the traced wall time (kernels run on one
    stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import DetectOptions, detect

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        detect(g, options=DetectOptions(algorithm=algorithm))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"  traced detect {algorithm}: wall={wall} s  device busy="
        f"{busy_us / 1e6} s ({100 * busy_us / 1e6 / wall} %)")
    log(events.table(sort_by="self_device_time_total", row_limit=25,
                     max_name_column_width=70))
    seg = sorted(((e.self_device_time_total, e.count, e.key) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "segreduce" in e.key), reverse=True)
    for us, n, name in seg:
        log(f"  {name[:100]}: {us / 1e3} ms device, {n} launches")


ENGINE_BATCH = 32     # the reference service's batch (bench_service.py)


def engine_families():
    """Phase 6's two workloads: (name, bucket, graphs on the card)."""
    from repro_torch.graph import sbm_graph
    from repro_torch.service import Bucket
    from repro_torch.service.buckets import admit

    big, ego = Bucket(1024, 16384), Bucket(64, 2048)
    dense, skipped, seed = [], [], 3
    while len(dense) < ENGINE_BATCH:
        try:
            dense.append(sbm_graph(1024, 16, 0.2, 0.003, seed=seed,
                                   n_cap=1024, m_cap=16384,
                                   device="cuda")[0])
        except ValueError:      # more directed edges than m_cap
            skipped.append(seed)
        seed += 1
    egos = [admit(sbm_graph(56, 4, 0.7, 0.08, seed=s, device="cuda")[0],
                  [ego])[0] for s in range(ENGINE_BATCH)]
    return [(f"sbm_graph(1024, 16, 0.2, 0.003, seed=3..{seed - 1} but "
             f"{skipped}) in Bucket(1024, 16384)", big, dense),
            ("ego-nets sbm_graph(56, 4, 0.7, 0.08, seed=0..31) in "
             "Bucket(64, 2048)", ego, egos)]


def same_as_detect(r, d) -> bool:
    """An engine result against ``detect()`` of the same graph: labels,
    counts, stats and Q's bits."""
    import numpy as np

    st = d.stats
    return (np.array_equal(r.C, d.labels.cpu().numpy())
            and (r.n_communities, r.n_disconnected, r.passes, r.sweeps,
                 r.split_moved) == (d.n_communities, d.n_disconnected,
                                    st["passes"], st["li_total"],
                                    st["split_moved"])
            and r.fraction == d.fraction and r.q == d.modularity)


def traced_batch(engine, graphs, algorithm):
    """One traced batch: CUDA kernel launches (runtime launch calls) and
    the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.detect_batch(graphs, algorithm=algorithm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall, launches, busy_us / 1e6


def engine_phase(profile=False) -> dict:
    """Phase 6: the batched engine and the result store on the card.
    Returns the segment-reduce launches by path."""
    import numpy as np
    import torch

    from repro_torch.core import DetectOptions, detect
    from repro_torch.core.portfolio import ALGORITHMS
    from repro_torch.service import BatchedLouvainEngine, ResultStore

    engine = BatchedLouvainEngine(algorithms=ALGORITHMS)
    launches = {}
    standard = {}
    for name, bucket, graphs in engine_families():
        n = len(graphs)
        log(f"  {name}: scan={engine.scan_for(bucket)}")
        t0 = time.perf_counter()
        n_warm = engine.warm(bucket)
        torch.cuda.synchronize()
        log(f"    warm(bucket): {n_warm} filler graphs in "
            f"{time.perf_counter() - t0} s  keys={len(engine.cache_keys())}")
        for alg in ("standard", "max-quality", "fast"):
            res, wall, n_seg, peak = timed_path(
                lambda: engine.detect_batch(graphs, algorithm=alg))
            hit = engine.last_detect_info.compile_hit
            opts = DetectOptions(algorithm=alg)
            dets, wall_loop, n_loop, _ = timed_path(
                lambda: [detect(g, options=opts) for g in graphs])
            equal = all(same_as_detect(r, d) for r, d in zip(res, dets))
            sweeps = sum(r.sweeps for r in res)
            n_disc = sum(r.n_disconnected for r in res)
            log(f"    detect_batch {alg}: equal to detect() (labels, counts, "
                f"stats, Q bits)={equal}  key hit={hit}  batch wall={wall} s "
                f"({n / wall} graphs/s)  loop of detect()={wall_loop} s  "
                f"loop/batch={wall_loop / wall}  segreduce launches a batch="
                f"{n_seg} (loop {n_loop})  sweeps (host syncs) a batch="
                f"{sweeps}  wall ms a sweep={1e3 * wall / max(sweeps, 1)}  "
                f"disconnected={n_disc}  peak device memory={peak:.3f} GiB")
            if not equal or not hit or n_seg != n_loop:
                raise AssertionError(f"engine {alg} on {name}: equal={equal}"
                                     f" key hit={hit} segreduce launches "
                                     f"{n_seg} against detect()'s {n_loop}")
            if alg != "fast" and n_disc:
                raise AssertionError(f"engine {alg}: {n_disc} disconnected")
            launches[f"engine detect_batch {alg}, {name}"] = n_seg
            if alg == "standard":
                standard[name] = res
        if profile:
            wall, n_launch, busy = traced_batch(engine, graphs, "standard")
            sweeps = sum(r.sweeps for r in standard[name])
            log(f"    traced detect_batch standard: wall={wall} s  CUDA "
                f"kernel launches={n_launch} ({n_launch / max(sweeps, 1)} a "
                f"sweep)  device busy={busy} s ({100 * busy / wall} %)")

    # the warm updates: 32 churn items on the large bucket, batched through
    # the engine against 32 immediate updates on a second store
    name, bucket, graphs = engine_families()[0]
    batched, immediate = ResultStore(), ResultStore()
    ids = [f"g{i}" for i in range(len(graphs))]
    for gid, g, r in zip(ids, graphs, standard[name]):
        for store in (batched, immediate):
            store.put(gid, g, r.C, n_communities=r.n_communities,
                      n_disconnected=r.n_disconnected, q=r.q)
    upds = [churn_batch(g, seed=100 + i, remove=16, add=8, delete=64,
                        insert=32)[0] for i, g in enumerate(graphs)]
    t0 = time.perf_counter()
    plans = [batched.prepare_update(gid, u) for gid, u in zip(ids, upds)]
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    items = [(p.graph, p.C_prev, p.touched) for p in plans]
    res, wall, n_seg, peak = timed_path(lambda: engine.update_batch(items))
    for p, r in zip(plans, res):
        batched.commit_update(p, C=r.C, n_communities=r.n_communities,
                              n_disconnected=r.n_disconnected, q=r.q)
    _, wall_imm, n_imm, _ = timed_path(lambda: [
        immediate.apply_update(gid, u) for gid, u in zip(ids, upds)])
    equal = True
    for gid in ids:
        a, b = batched.get(gid), immediate.get(gid)
        equal &= (np.array_equal(a.C, b.C) and a.q == b.q
                  and (a.version, a.n_communities, a.n_disconnected)
                  == (b.version, b.n_communities, b.n_disconnected)
                  and all(torch.equal(getattr(a.graph, k),
                                      getattr(b.graph, k))
                          for k in ("src", "dst", "w", "n_nodes")))
    sweeps = sum(r.iterations for r in res)
    n_disc = sum(r.n_disconnected for r in res)
    log(f"  update_batch, {name}: equal to immediate apply_update (graph, "
        f"labels, counts, Q bits)={equal}  host prepare={t_prep} s  batch "
        f"wall={wall} s ({len(res) / wall} graphs/s)  immediate (prepare "
        f"included)={wall_imm} s  segreduce launches a batch={n_seg} "
        f"(immediate {n_imm})  sweeps a batch={sweeps}  wall ms a sweep="
        f"{1e3 * wall / max(sweeps, 1)}  affected="
        f"{sum(r.n_affected for r in res)}  disconnected={n_disc}")
    if not equal or n_disc:
        raise AssertionError(f"update_batch: equal={equal}, {n_disc} "
                             "disconnected")
    launches[f"engine update_batch, {name}"] = n_seg
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=21,
                    help="R-MAT scale of the full-size graph (default 21)")
    ap.add_argument("--profile", action="store_true",
                    help="after phase 4, run detect() once more under "
                    "torch.profiler and print device time by kernel; trace "
                    "calls of each segsum, cumsum and spmm case of phase 5 "
                    "and one engine batch a bucket of phase 6 too")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
    for source, kernel in PTXAS_KERNELS:
        for line in ptxas_lines(reports.get(source, ""), kernel) or [
                f"{source} cached: no build report in this run"]:
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
    dense_launches = dense_phase()
    crossover_checks()
    update_dense_launches = dynamic_small_phase()

    log("phase 4: end to end, full size, on the card")
    phase_seconds = {}
    res, wall, launches, peak = timed_path(
        lambda: detect(g, phase_seconds=phase_seconds))
    st = res.stats
    log(f"  detect standard: passes={st['passes']}  sweeps(li_total)="
        f"{st['li_total']}  communities={res.n_communities}  disconnected="
        f"{res.n_disconnected}  modularity={res.modularity:.6f}")
    log(f"  wall seconds: total={wall}  " + "  ".join(
        f"{k}={v}" for k, v in sorted(phase_seconds.items())))
    log(f"  segreduce_sorted launches={launches}  peak device memory="
        f"{peak:.2f} GiB")
    if res.n_disconnected != 0:
        raise AssertionError(f"{res.n_disconnected} disconnected communities")
    if not 0.0 < res.modularity < 1.0:
        raise AssertionError(f"modularity {res.modularity} not in (0, 1)")
    labels = res.labels[: int(g.n_nodes)]
    if int(labels.min()) < 0 or int(labels.max()) >= res.n_communities:
        raise AssertionError("labels out of [0, n_communities)")
    by_path = {"detect standard": launches}
    by_path.update(tiers_phase(g, res))
    by_path["update_communities (warm update)"] = dynamic_phase(g, res.labels)
    by_path[f"detect dense standard, {DENSE_GRAPH}"] = dense_launches
    by_path[f"update_communities dense, {DENSE_GRAPH}"] = \
        update_dense_launches

    if args.profile:
        for algorithm in ("standard", "max-quality", "fast"):
            profile_phase(g, algorithm)

    log("phase 5: the kernel API vs plain, on the card")
    api_entries = api_phase(g, res.labels, profile=args.profile)

    log("phase 6: the batched engine and the store, on the card")
    by_path.update(engine_phase(profile=args.profile))

    entry["launches"] = launches
    entry["launches_by_path"] = by_path
    log(json.dumps({"kernels": [entry] + api_entries}))
    log(f"chip_smoke total: {time.perf_counter() - t_start} s")
    log(card)
    # the run uses one card, whatever else the machine holds
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
