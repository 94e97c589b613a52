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

7. The timeline, the checkpoint and the degraded tier, on the card
   (``repro_torch.timeline``, ``checkpoint``, ``resilience``).  At full
   size, on phase 4's graph: a ``ResultStore`` on the card with a
   ``TimelineManager`` as its commit hook; ``put`` of phase 4's standard
   detection (the first snapshot: a birth a community, 4,096 resident
   timelines), then ``apply_update`` of phase 4's batch, whose labels,
   community count and Q bits must equal phase 4's warm update, with 0
   disconnected and no id-map reset or binding mismatch (host prepare,
   warm update and hook timed apart); a service checkpoint saved and
   restored into a fresh store and manager, the entry bit for bit, equal
   ``state()`` and equal ``membership_at`` for 10,000 seeded externals
   (the directory is deleted after); ``lpa_result`` equal to phase 4's
   fast tier.  On the dense-scan family, card and CPU side by side: a
   checkpoint round trip after which one churn update gives the same bits
   on the original and the restored entry; an ``engine.detect`` fault on
   phase 6's engine retried to the clean batch; the ``engine.detect.hang``
   seam tripping ``call_with_timeout``; a breaker on an injected clock
   that opens, sheds to the degraded tier, half-opens and closes; and an
   ``AutoCheckpointer`` whose newest snapshot the ``checkpoint.io`` seam
   tears, recovered from the one before.

8. The service front end, on the card (``repro_torch.service``:
   ``CommunityService``, ``ServiceFrontend``, ``AsyncCommunityService``,
   the replay harness), at the default ``ServiceConfig()``'s ladder of
   five buckets and the reference CLI's settings.  (1) The reference
   CLI's sync traffic (``serve_communities.py`` ``run_traffic``: its three
   graph families plus phase 6's ``sbm_graph(1024, 16, 0.2, 0.003)``, 256
   arrivals, 30 % of them ``synth_updates`` of 4 edges, each graph updated
   at most once) through ``CommunityService``: every request served, 0
   disconnected, every detect entry equal to ``detect()`` of its admitted
   graph (labels, counts, Q bits), and the same traffic with
   ``update_batch_size=8`` committing the same entries; then phase 6's two
   families of 32 through the front end against phase 6's bare
   ``detect_batch``.  (2) Three tenants at Zipf-skewed rates pinned to
   the three tiers through ``AsyncCommunityService``
   (``max_pending_per_tenant=12``, blocking submission): every future on
   its tier and equal to its tier's ``detect()``, 0 disconnected for
   standard and max-quality.  (3) The planted lifecycle script through
   ``ingest_window`` (``timeline_enabled``, ``compact_window=4``) on the
   card and on the CPU: the events the timeline test asserts, equal on
   both with equal tracker state and memberships.  (4) ``sweep_rates``
   over 15, 30, 60 and 120 requests/s with the CLI's ``--replay``
   settings (offered, served, rejected, p50/p99, queue/engine/host shares,
   the knee), then one replay at 60/s with a live ``/metrics`` scrape
   mid-window.  (5) Chaos: 64 detects with ``engine.detect`` raising
   twice, one attempt, a breaker and the LPA degraded tier: every
   degraded result flagged, every other equal to the fault-free run's
   bits, the breakers closed at the end.  Each step prints its host time,
   its segment-reduce launches (above 0), its latency p50/p99, and the
   sync and async steps the host ms a request by phase (admission,
   compose, engine, commit, resolve; a batch-level span once a batch).

``--profile`` adds a traced run of phase 4's ``detect()`` of each tier
(device time by kernel, the device's busy share, and each segment-reduce
kernel's total), in phase
5, three traced calls of each ``segsum``, ``cumsum`` and ``spmm`` case
(device time a call by kernel), and in phase 6 one traced standard batch
of each bucket (CUDA kernel launches and the device's busy share), and in
phase 8 the traced replay at 60/s (the device's busy share).  The
second-to-last lines are one JSON object for the kernels (``kernels``) and the card line; the last
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


def dense_graph(device, seed=3):
    """The dense scan's full-width graph: ``nv = 1025`` (``dense_max_nv``)
    in the largest default service bucket, ``Bucket(1024, 16384)``."""
    from repro_torch.graph import sbm_graph

    return sbm_graph(1024, 16, 0.2, 0.003, seed=seed, n_cap=1024,
                     m_cap=16384, device=device)[0]


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


def dynamic_phase(g, labels) -> tuple[int, object, dict]:
    """Phase 4, one update batch at full size from the standard tier's
    labels: 1,024 vertices removed, 1,024 added (each wired to 2), 32,768
    undirected edges deleted and 16,384 inserted.  The host folds apart
    from the warm update on the card, which runs twice on the same inputs
    and must give the same bits.  Returns the warm update's launches, the
    batch and the warm update's output (phase 7 holds the store to it)."""
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
    return n, upd, out


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


def tiers_phase(g, standard) -> tuple[dict, object]:
    """Phase 4, the other paths at full size: ``detect()`` with
    'max-quality' and with 'fast', and ``louvain_staged``; each run alone
    with the launch count set to 0 just before.  ``standard`` is phase 4's
    default ``detect()``.  Returns the launches by path and the fast
    tier's ``Detection`` (phase 7 holds the degraded tier to it)."""
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
            fast = res
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
    return launches, fast


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


def engine_phase(profile=False) -> tuple[dict, object, dict]:
    """Phase 6: the batched engine and the result store on the card.
    Returns the segment-reduce launches by path, the engine and each
    family's standard batch wall seconds (phase 8 compares the front end
    with them)."""
    import numpy as np
    import torch

    from repro_torch.core import DetectOptions, detect
    from repro_torch.core.portfolio import ALGORITHMS
    from repro_torch.service import BatchedLouvainEngine, ResultStore

    engine = BatchedLouvainEngine(algorithms=ALGORITHMS)
    launches = {}
    standard = {}
    walls = {}
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
                walls[name] = wall
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
    return launches, engine, walls


CHECKPOINTS = ROOT / "build" / "chip_smoke_checkpoints"   # ignored by git


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def same_state(a, b) -> bool:
    """Two timeline managers' ``state()``: the same meta and the same
    arrays (dtype and bits)."""
    import numpy as np

    (aa, am), (ba, bm) = a.state(), b.state()
    return am == bm and list(aa) == list(ba) and all(
        aa[k].dtype == ba[k].dtype and np.array_equal(aa[k], ba[k])
        for k in aa)


def same_entry(a, b) -> bool:
    """Two store entries: graph arrays, labels, tombstones, version,
    counts and Q bits equal."""
    import numpy as np
    import torch

    return (all(torch.equal(getattr(a.graph, k).cpu(),
                            getattr(b.graph, k).cpu())
                for k in ("src", "dst", "w", "n_nodes"))
            and np.array_equal(a.C, b.C)
            and np.array_equal(a.deferred, b.deferred)
            and (a.version, a.n_communities, a.n_disconnected, a.q)
            == (b.version, b.n_communities, b.n_disconnected, b.q))


def timeline_phase(g, standard, fast, churn, warm, scale) -> dict:
    """Phase 7 at full size, on phase 4's graph: a store on the card with a
    timeline manager on its commit hook; the standard detection put (the
    first snapshot), then phase 4's update batch through ``apply_update``,
    held to phase 4's warm update; a service checkpoint saved and restored
    into a fresh store and manager, bit for bit; and the degraded tier's
    ``lpa_result``, held to phase 4's fast tier.  Returns the launches by
    path."""
    import collections
    import shutil
    from types import SimpleNamespace

    import numpy as np

    from repro_torch.core.portfolio import contract_for
    from repro_torch.resilience import lpa_result
    from repro_torch.service import ResultStore
    from repro_torch.telemetry.spans import RequestTrace
    from repro_torch.timeline import (TimelineConfig, TimelineManager,
                                      restore_service_checkpoint,
                                      save_service_checkpoint)

    gid = f"rmat{scale}"
    tl = TimelineManager(TimelineConfig())
    kinds = collections.Counter()
    tl.subscribe(lambda evs: kinds.update(e.kind for e in evs))
    hook_s = []

    def hook(graph_id, entry, plan):
        t0 = time.perf_counter()
        tl.observe_commit(graph_id, entry, plan)
        hook_s.append(time.perf_counter() - t0)

    store = ResultStore(on_commit=hook)
    holder = SimpleNamespace(store=store, timelines=tl)
    t0 = time.perf_counter()
    store.put(gid, g, standard.labels, n_communities=standard.n_communities,
              n_disconnected=standard.n_disconnected, q=standard.modularity)
    t_put = time.perf_counter() - t0
    resident = len(tl.communities())
    log(f"  put + first snapshot: {t_put} s (hook {hook_s[-1]} s)  events="
        f"{dict(kinds)}  resident timelines={resident}  "
        f"n_truncated_communities={tl.store.n_truncated_communities}")
    if store.n_commit_hook_errors:
        raise AssertionError(f"commit hook failed: {store.last_hook_error}")
    if dict(kinds) != {"birth": standard.n_communities} or resident != min(
            standard.n_communities, tl.config.max_communities):
        raise AssertionError("first snapshot: a birth a community expected")

    kinds.clear()
    trace = RequestTrace("update", kind="update")
    entry, wall, n_update, peak = timed_path(
        lambda: store.apply_update(gid, churn, trace=trace))
    d = trace.durations()
    same = (np.array_equal(entry.C, warm["C"].cpu().numpy())
            and entry.n_communities == warm["n_communities"]
            and entry.q == warm["q"])
    log(f"  apply_update (phase 4's batch): wall={wall} s  host prepare="
        f"{d['repad']} s  warm update={d['compile'] + d['engine-dispatch']} "
        f"s  device sync={d['device-sync']} s  commit={d['store-commit']} s "
        f"(hook {hook_s[-1]} s)  segreduce launches={n_update}  peak device "
        f"memory={peak:.2f} GiB  == phase 4's warm update (labels, "
        f"communities, Q bits)={same}  communities={entry.n_communities}  "
        f"disconnected={entry.n_disconnected}  events={dict(kinds)}  "
        f"idmap resets={tl.n_idmap_resets}  binding mismatches="
        f"{tl.n_binding_mismatches}")
    if not same or entry.n_disconnected or tl.n_idmap_resets \
            or tl.n_binding_mismatches or store.n_commit_hook_errors:
        raise AssertionError("apply_update + timeline at full size")

    ck = CHECKPOINTS / gid
    shutil.rmtree(ck, ignore_errors=True)
    back = SimpleNamespace(store=ResultStore(),
                           timelines=TimelineManager(TimelineConfig()))
    try:
        t0 = time.perf_counter()
        step = save_service_checkpoint(holder, str(ck))
        t_save = time.perf_counter() - t0
        n_bytes = dir_bytes(ck)
        t0 = time.perf_counter()
        restored = restore_service_checkpoint(back, str(ck))
        t_restore = time.perf_counter() - t0
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    a, b = store.get(gid), back.store.get(gid)
    bits = (restored == step and b.graph.device == g.device
            and same_entry(a, b))
    states = same_state(tl, back.timelines)
    rng = np.random.default_rng(22)
    probes = rng.integers(0, int(tl.external_ids(gid).max()) + 100, 10_000)
    t_first = tl.snapshots(gid)[0].t
    members = all(tl.membership_at(gid, e, t) ==
                  back.timelines.membership_at(gid, e, t)
                  for e in probes.tolist() for t in (None, t_first))
    log(f"  service checkpoint: save={t_save} s ({n_bytes} bytes)  restore="
        f"{t_restore} s  entry bit for bit (src, dst, w, C, deferred, "
        f"version)={bits}  state() equal={states}  membership_at equal for "
        f"10,000 seeded externals at two times={members}")
    if not (bits and states and members):
        raise AssertionError("service checkpoint round trip at full size")
    del back

    lp, wall, n_lpa, peak = timed_path(lambda: lpa_result(gid, g))
    same = (np.array_equal(lp.C, fast.labels.cpu().numpy())
            and lp.n_communities == fast.n_communities
            and lp.n_disconnected == fast.n_disconnected
            and lp.q == fast.modularity)
    log(f"  lpa_result: wall={wall} s  segreduce launches={n_lpa}  peak "
        f"device memory={peak:.2f} GiB  == phase 4's fast tier (labels, "
        f"communities, disconnected, Q bits)={same}  guarantee="
        f"{lp.guarantee}  contract={lp.contract}")
    if not same or lp.guarantee or lp.contract != contract_for("fast") \
            or lp.contract != fast.contract:
        raise AssertionError("lpa_result differs from the fast tier")
    return {f"store.apply_update + timeline, {gid}": n_update,
            f"lpa_result (degraded), {gid}": n_lpa}


def same_batch(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        np.array_equal(x.C, y.C) and x.q == y.q
        and (x.n_communities, x.n_disconnected) == (y.n_communities,
                                                    y.n_disconnected)
        for x, y in zip(a, b))


def resilience_small_phase(engine) -> dict:
    """Phase 7 on the dense-scan family (``nv = 1025``), card and CPU side
    by side: a service checkpoint round trip, after which one churn update
    on the original and on the restored entry gives the same bits; an
    ``engine.detect`` fault on phase 6's engine retried to the clean batch;
    the ``engine.detect.hang`` seam tripping the watchdog; a breaker that
    opens, sheds to the degraded tier, half-opens and closes on an
    injected clock; and an auto-checkpointer whose newest snapshot the
    ``checkpoint.io`` seam tears, recovered from the one before.  Returns
    the launches by path."""
    import shutil
    from types import SimpleNamespace

    import numpy as np

    from repro_torch.core import DetectOptions, detect
    from repro_torch.resilience import (AutoCheckpointer, BreakerConfig,
                                        DispatchTimeout, FaultError,
                                        FaultPlan, FaultSpec,
                                        ResilienceManager, RetryPolicy,
                                        call_with_timeout, lpa_result,
                                        run_with_policy)
    from repro_torch.service import BatchedLouvainEngine, Bucket, ResultStore
    from repro_torch.timeline import (TimelineManager,
                                      restore_service_checkpoint,
                                      save_service_checkpoint)

    launches = {}
    upd = churn_batch(dense_graph("cpu"), seed=5, remove=16, add=8,
                      delete=64, insert=32)[0]
    t0 = time.perf_counter()
    after = {}
    for dev in ("cuda", "cpu"):
        g = dense_graph(dev)
        det = detect(g, device=dev)
        store, back = ResultStore(device=dev), ResultStore(device=dev)
        store.put("d", g, det.labels, n_communities=det.n_communities,
                  n_disconnected=det.n_disconnected, q=det.modularity)
        ck = CHECKPOINTS / f"dense-{dev}"
        shutil.rmtree(ck, ignore_errors=True)
        try:
            save_service_checkpoint(SimpleNamespace(store=store), str(ck))
            restore_service_checkpoint(SimpleNamespace(store=back), str(ck))
        finally:
            shutil.rmtree(ck, ignore_errors=True)
        if not same_entry(store.get("d"), back.get("d")):
            raise AssertionError(f"dense checkpoint round trip on {dev}")
        original = store.apply_update("d", upd)
        if dev == "cuda":
            restored, _, n, _ = timed_path(lambda: back.apply_update("d",
                                                                     upd))
            launches[f"apply_update on a restored entry, {DENSE_GRAPH}"] = n
        else:
            restored = back.apply_update("d", upd)
        after[dev] = (original, restored)
    same = (same_entry(*after["cuda"]) and same_entry(*after["cpu"])
            and same_entry(after["cuda"][1], after["cpu"][1]))
    log(f"  {DENSE_GRAPH}: checkpoint round trip, then one churn update on "
        f"the original and the restored entry: all four equal (card, CPU)="
        f"{same}  disconnected={after['cuda'][1].n_disconnected}  "
        f"{time.perf_counter() - t0} s")
    if not same or after["cuda"][1].n_disconnected:
        raise AssertionError("update after a dense checkpoint round trip")

    graphs = [dense_graph("cuda", seed=s) for s in range(3, 7)]
    t0 = time.perf_counter()
    clean = engine.detect_batch(graphs)
    got = {}
    for dev, eng in (("cuda", engine),
                     ("cpu", BatchedLouvainEngine(device="cpu"))):
        eng.faults = FaultPlan({"engine.detect": FaultSpec(count=1)})
        retried = []
        got[dev] = run_with_policy(
            lambda: eng.detect_batch(graphs),
            RetryPolicy(max_attempts=3, backoff_s=0.0),
            on_retry=lambda a, e: retried.append(type(e).__name__))
        if retried != ["FaultError"]:
            raise AssertionError(f"retry on {dev}: {retried}")
        eng.faults = None
    same = same_batch(got["cuda"], clean) and same_batch(got["cpu"], clean)
    log(f"  engine.detect fault, count=1, under run_with_policy: retried once"
        f", batch of {len(graphs)} equal to the clean batch (card, CPU)="
        f"{same}  {time.perf_counter() - t0} s")
    if not same:
        raise AssertionError("the retried batch differs from the clean one")

    # the hung attempt sleeps on the host; afterwards it fails at the
    # engine.detect seam scoped to its ids, so it queues no kernel
    plan = FaultPlan({"engine.detect.hang": FaultSpec(hang_s=0.5, count=1),
                      "engine.detect": FaultSpec(graph_ids=("hung",))})
    engine.faults = plan
    t0 = time.perf_counter()
    try:
        call_with_timeout(lambda: engine.detect_batch(graphs[:1],
                                                      fault_ids=["hung"]),
                          0.1)
        raise AssertionError("the watchdog did not fire")
    except DispatchTimeout:
        t_fire = time.perf_counter() - t0
    while not plan.injected["engine.detect"] and \
            time.perf_counter() - t0 < 10.0:
        time.sleep(0.01)
    engine.faults = None
    log(f"  engine.detect.hang (0.5 s) under call_with_timeout(0.1 s): "
        f"DispatchTimeout after {t_fire} s; the abandoned attempt ended at "
        f"its seam={plan.injected['engine.detect'] == 1}")
    if plan.injected["engine.detect"] != 1:
        raise AssertionError("the abandoned attempt did not end")

    now = [0.0]
    bucket = Bucket(1024, 16384)
    mgr = ResilienceManager(SimpleNamespace(
        fault_plan=FaultPlan({"engine.detect": FaultSpec(count=2)}),
        retry=RetryPolicy(max_attempts=1), degrade_tenants=None,
        breaker=BreakerConfig(failure_threshold=2, cooldown_s=1.0),
        degrade_enabled=True, degrade_modes=("lpa",),
        detect=DetectOptions()), clock=lambda: now[0])
    engine.faults = mgr.plan
    states = [mgr.breaker_state(bucket)]
    for _ in range(2):
        try:
            mgr.dispatch("detect", bucket,
                         lambda: engine.detect_batch(graphs[:1]))
        except FaultError:
            pass
        states.append(mgr.breaker_state(bucket))
    shut = not mgr.allow(bucket)
    shed = mgr.degraded("d0", graphs[0], ResultStore(), now=now[0])
    on_cpu = lpa_result("d0", graphs[0], device="cpu")
    shed_ok = (not shed.guarantee and np.array_equal(shed.C, on_cpu.C)
               and shed.q == on_cpu.q)
    now[0] += 1.5
    probe = mgr.allow(bucket)
    states.append(mgr.breaker_state(bucket))
    res = mgr.dispatch("detect", bucket,
                       lambda: engine.detect_batch(graphs[:1]))
    states.append(mgr.breaker_state(bucket))
    engine.faults = None
    log(f"  breaker (threshold 2, cooldown 1 s, injected clock): states="
        f"{states}  shut while open={shut}  shed to lpa on the card == CPU="
        f"{shed_ok}  probe admitted={probe}  probe result == clean="
        f"{same_batch(res, clean[:1])}")
    if states != ["closed", "closed", "open", "half-open", "closed"] or \
            not (shut and shed_ok and probe and same_batch(res, clean[:1])):
        raise AssertionError("breaker sequence")

    ck = CHECKPOINTS / "auto"
    shutil.rmtree(ck, ignore_errors=True)
    try:
        tl = TimelineManager()
        holder = SimpleNamespace(store=ResultStore(on_commit=tl.observe_commit),
                                 timelines=tl)
        det = detect(graphs[0])
        holder.store.put("d", graphs[0], det.labels,
                         n_communities=det.n_communities,
                         n_disconnected=det.n_disconnected, q=det.modularity)
        ac = AutoCheckpointer(holder, ckpt_dir=str(ck), faults=FaultPlan(
            {"checkpoint.io": FaultSpec(skip=1, count=1)}))
        good = ac.snapshot(force=True)
        e0, meta0 = holder.store.get("d"), tl.state()[1]
        holder.store.apply_update("d", churn_batch(
            graphs[0], seed=6, remove=16, add=8, delete=64, insert=32)[0])
        torn = ac.snapshot(force=True)
        fresh = SimpleNamespace(store=ResultStore(),
                                timelines=TimelineManager())
        ac2 = AutoCheckpointer(fresh, ckpt_dir=str(ck))
        step = ac2.recover()
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    ok = (ac.n_torn == 1 and step == good != torn
          and ac2.n_corrupt_skipped == 1
          and same_entry(fresh.store.get("d"), e0)
          and fresh.timelines.state()[1] == meta0)
    log(f"  auto-checkpointer: snapshots {good} and {torn} (torn by the "
        f"checkpoint.io seam: {ac.n_torn}); recover() restored step {step}"
        f", skipped {ac2.n_corrupt_skipped} corrupt; the entry and the "
        f"timeline as at step {good}={ok}")
    if not ok:
        raise AssertionError("torn-snapshot recovery")
    return launches



# ---------------------------------------------------------------------------
# phase 8: the service front end (ServiceFrontend, the async service, the
# sync adapter, the replay harness) on the card
# ---------------------------------------------------------------------------

FRONTEND_FAMILIES = ("ego_small", "ego_dense", "road", "sbm1024")
# span names of a request's trace, by the host phase they spend
HOST_PHASES = {"admission": ("submit", "admission", "repad"),
               "compose": ("drr-compose",),
               "engine": ("compile", "engine-dispatch", "device-sync"),
               "commit": ("store-commit",),
               "resolve": ("resolve",)}


def frontend_graph(kind: str, seed: int, device):
    """One request graph of a family: a copy of the reference CLI's
    ``synth_graph`` (``src/repro/launch/serve_communities.py:118-135``:
    sparse ego-nets in ``Bucket(64, 512)``, dense ego-nets in
    ``Bucket(64, 2048)``, road-like grids in ``Bucket(256, 2048)``), and
    phase 6's ``sbm_graph(1024, 16, 0.2, 0.003)`` family in
    ``Bucket(1024, 16384)`` (the next seed that fits it)."""
    import numpy as np

    from repro_torch.graph import grid_graph, sbm_graph

    rng = np.random.default_rng(seed)
    if kind == "ego_small":
        n = int(rng.integers(28, 52))
        return sbm_graph(n_nodes=n, n_blocks=3, p_in=0.35, p_out=0.03,
                         seed=seed, device=device)[0]
    if kind == "ego_dense":
        n = int(rng.integers(48, 60))
        return sbm_graph(n_nodes=n, n_blocks=4, p_in=0.7, p_out=0.08,
                         seed=seed, device=device)[0]
    if kind == "road":
        return grid_graph(int(rng.integers(10, 15)), 16, device=device)
    while True:
        try:
            return sbm_graph(1024, 16, 0.2, 0.003, seed=seed, n_cap=1024,
                             m_cap=16384, device=device)[0]
        except ValueError:      # more directed edges than the bucket
            seed += 1


def synth_updates(entry, seed: int, n_edges: int = 4):
    """The reference CLI's ``synth_updates``: a small undirected edge batch
    inside the stored graph's vertex set."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(entry.graph.n_nodes)
    u = rng.integers(0, n, n_edges)
    v = rng.integers(0, n, n_edges)
    keep = u != v
    return u[keep], v[keep], np.ones(int(keep.sum()), np.float32)


def host_ms_by_phase(futs) -> dict:
    """Wall ms a request of each host phase (:data:`HOST_PHASES`), from
    the requests' traces; a batch-level span (compose, engine) stamped on
    every member counts once.  ``queue`` is the mean wait, not host
    work."""
    seen = {k: set() for k in HOST_PHASES}
    queue = 0.0
    for f in futs:
        for s in f.trace.spans:
            if s.name == "queue-wait":
                queue += s.t_end - s.t_start
            for group, names in HOST_PHASES.items():
                if s.name in names:
                    seen[group].add((s.name, s.t_start, s.t_end))
    n = max(len(futs), 1)
    out = {g: 1e3 * sum(t1 - t0 for _, t0, t1 in ivs) / n
           for g, ivs in seen.items()}
    out["queue (wait)"] = 1e3 * queue / n
    return out


def engine_rate_by_bucket(detect_futs) -> dict:
    """Detections a second of engine time, by bucket: each bucket's
    detect requests over its batches' engine intervals, each once."""
    per = {}
    for f in detect_futs:
        e = f.result()
        b = (e.bucket.n_cap, e.bucket.m_cap)
        n, ivs = per.get(b, (0, set()))
        ivs |= {(s.name, s.t_start, s.t_end) for s in f.trace.spans
                if s.name in HOST_PHASES["engine"]}
        per[b] = (n + 1, ivs)
    return {b: n / max(sum(t1 - t0 for _, t0, t1 in ivs), 1e-9)
            for b, (n, ivs) in sorted(per.items())}


def same_as_detect_entry(e) -> bool:
    """A detect entry against ``detect()`` of its admitted graph on the
    card: labels, counts and Q bits."""
    import numpy as np

    from repro_torch.core import DetectOptions, detect

    d = detect(e.graph, options=DetectOptions(algorithm=e.algorithm),
               device="cuda")
    return (np.array_equal(e.C, d.labels.cpu().numpy())
            and (e.n_communities, e.n_disconnected, e.q)
            == (d.n_communities, d.n_disconnected, d.modularity))


def warmed_sync_service(update_batch_size: int):
    """``CommunityService`` with the default ``ServiceConfig`` (its
    five-bucket ladder, batches of 32, 50 ms) on the card, after a warm
    prologue: one graph and one update a family, then ``engine.warm`` of
    each bucket; its metrics and trace sink reset."""
    from repro_torch.service import CommunityService, ServiceConfig

    svc = CommunityService(config=ServiceConfig(
        update_batch_size=update_batch_size), device="cuda")
    for i, fam in enumerate(FRONTEND_FAMILIES):
        svc.submit_detect(f"warm-{fam}", frontend_graph(fam, 10_000 + i,
                                                         "cuda"))
    svc.drain()
    for fam in FRONTEND_FAMILIES:
        e = svc.result(f"warm-{fam}")
        svc.submit_update(f"warm-{fam}", synth_updates(e, 1))
        svc.engine.warm(e.bucket)
    svc.drain()
    svc.metrics.reset()
    if svc.frontend.mem_sink is not None:
        svc.frontend.mem_sink.reset()
    return svc


def sync_traffic(svc):
    """The reference CLI's sync traffic through a warmed
    ``CommunityService``: 256 arrivals, 30 % of them ``synth_updates`` of
    4 edges on a graph submitted earlier and not updated yet, pumping
    after each.  The plan of arrivals comes from seed 0 alone, and no
    graph takes two updates (two in one batch would fold into one warm
    update), so two runs serve the same traffic and commit the same
    entries whatever their batching.  Returns (detect futures, update
    futures, seconds)."""
    import numpy as np

    n_requests, update_frac, seed = 256, 0.3, 0
    rng = np.random.default_rng(seed)
    submitted, dets, upds = [], [], []
    t0 = time.perf_counter()
    for i in range(n_requests):
        if submitted and rng.random() < update_frac:
            gid = submitted.pop(int(rng.integers(0, len(submitted))))
            if svc.result(gid) is None:     # its detect still queued
                svc.pump(force=True)
            upds.append(svc.frontend.submit_update(
                gid, synth_updates(svc.result(gid), seed + i)))
        else:
            fam = FRONTEND_FAMILIES[int(rng.integers(0,
                                                     len(FRONTEND_FAMILIES)))]
            gid = f"g{i}-{fam}"
            dets.append(svc.detect(gid, frontend_graph(fam, seed + i,
                                                       "cuda")))
            submitted.append(gid)
        svc.pump()
    svc.drain()
    return dets, upds, time.perf_counter() - t0


def report_line(rep) -> str:
    return (f"p50={rep['p50_ms']} ms  p99={rep['p99_ms']} ms  "
            f"detect p50={rep['p50_detect_ms']} ms  update p50="
            f"{rep['p50_update_ms']} ms  graphs/s={rep['graphs_per_s']}")


def frontend_sync_step() -> dict:
    """Phase 8.1: the sync mix twice, immediate and batched updates; each
    service warmed before the launch count is set to 0."""
    launches = {}
    svc = warmed_sync_service(update_batch_size=1)
    (dets, upds, t_run), wall, n, _ = timed_path(lambda: sync_traffic(svc))
    launches["front end sync mix (CommunityService, update_batch_size=1)"] \
        = n
    rep = svc.metrics.report()
    bad = [f.req_id for f in dets + upds if f.exception() is not None]
    n_disc = sum(f.result().n_disconnected for f in dets)
    log(f"  8.1 sync mix, default ServiceConfig, update_batch_size=1: "
        f"{len(dets)} detects + {len(upds)} updates "
        f"({rep['n_rebucketed']} re-bucketed) in {t_run} s "
        f"(with the last sync {wall} s)  failed={len(bad)}  "
        f"disconnected={n_disc}  segreduce launches={n}")
    log(f"    {report_line(rep)}")
    log("    host ms a request by phase: " + "  ".join(
        f"{k}={v:.4f}" for k, v in host_ms_by_phase(dets + upds).items()))
    log("    detections a second of engine time, by bucket: " + "  ".join(
        f"{b}={r:.2f}" for b, r in engine_rate_by_bucket(dets).items()))
    t0 = time.perf_counter()
    equal = all(same_as_detect_entry(f.result()) for f in dets)
    log(f"    every detect entry == detect() of its admitted graph on the "
        f"card (labels, counts, Q bits)={equal}  "
        f"({time.perf_counter() - t0} s)")
    if bad or n_disc or not equal:
        raise AssertionError(f"sync mix: failed={bad} disconnected={n_disc}"
                             f" equal to detect()={equal}")

    svc8 = warmed_sync_service(update_batch_size=8)
    (dets8, upds8, t_run8), wall8, n8, _ = timed_path(
        lambda: sync_traffic(svc8))
    launches["front end sync mix (update_batch_size=8)"] = n8
    rep8 = svc8.metrics.report()
    gids = svc.store.graph_ids()
    same = (sorted(gids) == sorted(svc8.store.graph_ids())
            and all(same_entry(svc.result(g), svc8.result(g))
                    for g in gids)
            and all(same_entry(a.result(), b.result())
                    for a, b in zip(dets, dets8)))
    log(f"  8.1 the same traffic, update_batch_size=8: {rep8['n_update']} "
        f"updates in {rep8['n_update_batches']} batches, in {t_run8} s "
        f"(with the last sync {wall8} s)  every entry equal to "
        f"update_batch_size=1's={same}  segreduce launches={n8}")
    log(f"    {report_line(rep8)}")
    log("    host ms a request by phase: " + "  ".join(
        f"{k}={v:.4f}" for k, v in host_ms_by_phase(dets8 + upds8).items()))
    if not same or any(f.exception() is not None for f in dets8 + upds8):
        raise AssertionError("batched updates differ from immediate ones")
    svc.close()
    svc8.close()
    return launches


# 8.1b's order of runs: front end (F) and bare detect_batch (B) in three
# interleaved pairs, so a drift of the host's speed falls on both
FRONT_VS_BARE_ORDER = "FBBFFB"


def frontend_vs_engine_step(engine_walls) -> dict:
    """Phase 8.1b: phase 6's two families of 32, standard, through a
    warmed ``CommunityService`` (one batch of 32, new graph ids each time)
    and as the bare ``detect_batch`` of the same graphs on the service's
    engine, in :data:`FRONT_VS_BARE_ORDER`; the first front-end batch is
    the counted one.  Prints each time, the medians and their ratio (and
    phase 6's time, from earlier in the run)."""
    import statistics

    import torch

    from repro_torch.service import CommunityService, ServiceConfig

    launches = {}
    for name, bucket, graphs in engine_families():
        svc = CommunityService(config=ServiceConfig(), device="cuda")
        svc.engine.warm(bucket)

        def serve(r):
            futs = [svc.detect(f"r{r}-g{i}", g)
                    for i, g in enumerate(graphs)]
            svc.drain()
            return all(f.exception() is None
                       and not f.result().n_disconnected for f in futs)

        def synced(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        ok, wall, n, _ = timed_path(lambda: serve(0))
        times = {"F": [wall], "B": []}
        for r, kind in enumerate(FRONT_VS_BARE_ORDER[1:], 1):
            if kind == "F":
                served, t = synced(lambda: serve(r))
                ok = ok and served
            else:
                _, t = synced(lambda: svc.engine.detect_batch(graphs))
            times[kind].append(t)
        front, bare = (statistics.median(times[k]) for k in "FB")
        log(f"  8.1b {name}, standard, {len(graphs)} at a time, in the order "
            f"{FRONT_VS_BARE_ORDER}: through CommunityService "
            f"{times['F']} s, median {front} s ({len(graphs) / front} "
            f"graphs/s)  the bare detect_batch {times['B']} s, median "
            f"{bare} s ({len(graphs) / bare} graphs/s)  front end/bare of "
            f"the medians={front / bare}  phase 6's bare detect_batch="
            f"{engine_walls.get(name)} s  segreduce launches (the first "
            f"front-end batch)={n}  served={ok}")
        if not ok:
            raise AssertionError(f"front end on {name}")
        launches[f"front end detect of 32, {name}"] = n
        svc.close()
    return launches


ZIPF_S = 1.5        # the replay harness's tenant skew (ReplayConfig)


def frontend_tiers_step() -> dict:
    """Phase 8.2: 48 requests of three tenants at Zipf-skewed rates pinned
    to the three tiers (the CLI's ``--tiers``) through
    ``AsyncCommunityService`` with ``max_pending_per_tenant=12`` and
    blocking submission.  The service is started and warmed on the event
    loop before the launch count is set to 0; only the submissions and
    awaits are counted."""
    import asyncio

    import numpy as np

    from repro_torch.service import AsyncCommunityService, ServiceConfig
    from repro_torch.service.buckets import admit

    n_requests = 48
    tiers = (("speed", "fast"), ("std", "standard"),
             ("quality", "max-quality"))
    ranks = np.arange(1, len(tiers) + 1, dtype=np.float64)
    p = ranks ** -ZIPF_S / (ranks ** -ZIPF_S).sum()
    rng = np.random.default_rng(3)
    who = rng.choice(len(tiers), n_requests, p=p)
    fams = rng.integers(0, 3, n_requests)
    cfg = ServiceConfig(tenant_tiers=tiers, batch_size=16,
                        max_delay_s=0.025, max_pending_per_tenant=12)

    async def start():
        svc = await AsyncCommunityService(cfg, device="cuda").start()
        for i, fam in enumerate(FRONTEND_FAMILIES[:3]):
            svc.engine.warm(admit(frontend_graph(fam, 20_000 + i, "cuda"),
                                  cfg.buckets)[1])
        svc.metrics.reset()
        return svc

    async def traffic(svc):
        futs = []
        for i in range(n_requests):
            tenant = tiers[int(who[i])][0]
            g = frontend_graph(FRONTEND_FAMILIES[int(fams[i])], 500 + i,
                               "cuda")
            futs.append((tenant, await svc.submit_detect(
                f"t{i}", g, tenant=tenant)))
            await asyncio.sleep(float(rng.exponential(0.01)))
        entries = [(t, await f) for t, f in futs]
        return entries, svc.metrics.report(), [f for _, f in futs]

    with asyncio.Runner() as runner:
        svc = runner.run(start())
        try:
            (entries, rep, futs), wall, n, _ = timed_path(
                lambda: runner.run(traffic(svc)))
        finally:
            runner.run(svc.close())
    pin = dict(tiers)
    ok_tier = all(e.algorithm == pin[t] for t, e in entries)
    equal = all(same_as_detect_entry(e) for _, e in entries)
    disc = {tier: sum(e.n_disconnected for t, e in entries
                      if pin[t] == tier) for _, tier in tiers}
    counts = {t: sum(1 for tt, _ in entries if tt == t) for t, _ in tiers}
    log(f"  8.2 tenants and tiers, AsyncCommunityService: {len(entries)} "
        f"requests {counts} in {wall} s  each on its tier={ok_tier}  each "
        f"== its tier's detect() (labels, counts, Q bits)={equal}  "
        f"disconnected by tier={disc}  segreduce launches={n}")
    log(f"    {report_line(rep)}  by tenant p50: " + "  ".join(
        f"{t}={rep['tenants'][t]['p50_ms']}" for t, _ in tiers
        if t in rep["tenants"]))
    log("    host ms a request by phase: " + "  ".join(
        f"{k}={v:.4f}" for k, v in host_ms_by_phase(futs).items()))
    if not (ok_tier and equal) or disc["standard"] or disc["max-quality"]:
        raise AssertionError("tenants and tiers")
    return {"front end tenants and tiers (AsyncCommunityService)": n}


def planted_run(device):
    """The planted lifecycle script through ``ingest_window`` of a sync
    service with ``timeline_enabled`` and ``compact_window=4``: (events,
    tracker state, memberships at each window, snapshots)."""
    from repro_torch.data import planted_timeline_script
    from repro_torch.service import CommunityService, ServiceConfig

    g0, windows, expected = planted_timeline_script(device=device)
    svc = CommunityService(config=ServiceConfig(
        timeline_enabled=True, compact_window=4), device=device)
    svc.frontend.set_snapshot_time("g", 0.0)
    svc.submit_detect("g", g0)
    svc.pump(force=True)
    for i, evs in enumerate(windows):
        svc.ingest_window("g", evs, t=float(i + 1))
    events = [(e.kind, e.t, e.community, e.parents)
              for e in svc.lifecycle_events("g")]
    exts = range(int(g0.n_nodes) + 8)
    members = [[svc.membership_at("g", x, t) for x in exts]
               for t in (0.0, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0)]
    snaps = svc.timeline_snapshots("g")
    state = svc.timelines.state()
    svc.close()
    return events, state, members, snaps, expected, int(g0.n_nodes)


def frontend_timeline_step() -> dict:
    """Phase 8.3: the planted script on the card and on the CPU: the
    lifecycle events test_planted_lifecycle_end_to_end_sync asserts, and
    the same events, tracker state and memberships on both."""
    import numpy as np

    (ev, (sa, sm), mem, snaps, expected, n0), wall, n, _ = timed_path(
        lambda: planted_run("cuda"))
    ev_c, (ca, cm), mem_c, _, _, _ = planted_run("cpu")
    got = {s.t: sorted(k for k, t, _, _ in ev
                       if t == s.t and k != "continuation")
           for s in snaps if s.t > 0}
    want = {float(i + 1): sorted(k) for i, k in enumerate(expected)}
    m = {t: row for t, row in zip((0.0, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0), mem)}
    lifecycle = (got == want and m[1.5][3] != m[1.5][0]
                 and m[2.0][3] == m[2.0][0] and m[3.0][3] != m[3.0][0]
                 and m[3.0][2] is not None and m[4.0][2] is None
                 and m[5.0][n0] is not None
                 and all(s.n_disconnected == 0 for s in snaps))
    same = (ev == ev_c and mem == mem_c and sm == cm and list(sa) == list(ca)
            and all(np.array_equal(sa[k], ca[k]) for k in sa))
    log(f"  8.3 timeline, planted script through ingest_window "
        f"(compact_window=4): {len(snaps)} snapshots in {wall} s  events="
        f"{got}  lifecycle as the test asserts={lifecycle}  card == CPU "
        f"(events, state, memberships)={same}  segreduce launches={n}")
    if not (lifecycle and same):
        raise AssertionError("planted timeline on the card")
    return {"front end timeline ingest_window (planted script)": n}


REPLAY_RATES = (15.0, 30.0, 60.0, 120.0)


def replay_config():
    """The reference CLI's ``--replay`` settings (``serve_communities.py``
    ``main_replay_async``, its defaults: batch 16, 25 ms, 12 pending a
    tenant, 3 tenants, 30 % updates, 3 s, pool of 24)."""
    from repro_torch.service import ReplayConfig, ServiceConfig

    return (ReplayConfig(duration_s=3.0, n_tenants=3, update_frac=0.3,
                         pool_size=24),
            ServiceConfig(batch_size=16, max_delay_s=0.025,
                          max_pending_per_tenant=12, telemetry_enabled=True,
                          exporter_port=0))


def frontend_replay_step(profile: bool) -> dict:
    """Phase 8.4: ``sweep_rates`` over the rate ladder, then one replay at
    60/s with a live ``/metrics`` scrape in the middle of its window (and
    under ``--profile`` the device's busy share)."""
    import asyncio
    import dataclasses
    import urllib.request

    from repro_torch.service import AsyncCommunityService, sweep_rates
    from repro_torch.service.replay import replay
    from repro_torch.telemetry import metric_names, parse_prometheus

    base, svc_cfg = replay_config()
    rates = REPLAY_RATES
    out, wall, n, _ = timed_path(lambda: sweep_rates(rates, base, svc_cfg,
                                                     device="cuda"))
    for rep in out["rates"]:
        bd = rep.get("phase_breakdown", {})
        log(f"  8.4 replay {rep['rate']}/s: the arrivals of a "
            f"{base.duration_s} s schedule took {rep['window_s']} s "
            f"({rep['offered'] / rep['window_s']}/s)  served "
            f"{rep['served'] / rep['total_s']}/s  offered={rep['offered']} "
            f"served={rep['served']} rejected={rep['rejected']} failed="
            f"{rep['failed']} late={rep['late_arrivals']} goodput="
            f"{rep['goodput']:.3f}  p50={rep['p50_ms']} ms  p99="
            f"{rep['p99_ms']} ms  shares: " + "  ".join(
                f"{k}={v:.4f}" for k, v in sorted(bd.items()))
            + f"  window={rep['window_s']} s  total={rep['total_s']} s")
    knee = out["knee_rate"]
    # the harness's knee reads goodput and p99 alone; an arrival loop that
    # cannot keep its schedule (late arrivals) offers less than the rate,
    # so the first rate whose arrivals took over 10 % longer than their
    # schedule is printed beside it
    held = [r["rate"] for r in out["rates"]
            if r["window_s"] > 1.1 * base.duration_s]
    log(f"  8.4 sweep {list(rates)}: knee (find_knee)="
        + (f"{knee}/s" if knee is not None
           else f"not reached up to {max(rates)}/s")
        + "  first rate whose arrivals ran over 10 % past their schedule="
        + (f"{held[0]}/s" if held else "none")
        + f"  ({wall} s, segreduce launches={n})")
    if any(r["failed"] for r in out["rates"]) or \
            not all(r["served"] for r in out["rates"]):
        raise AssertionError("replay: failed or nothing served")

    async def scraped():
        cfg = dataclasses.replace(base, rate=60.0, duration_s=1.5)
        async with AsyncCommunityService(svc_cfg, device="cuda") as svc:
            url = svc.frontend.exporter.url
            loop = asyncio.get_running_loop()

            async def scrape():
                # the window opens when replay() resets the metrics after
                # seeding the pool as tenant "warmup"
                m = svc.metrics
                while "warmup" not in m.tenants:
                    await asyncio.sleep(0.01)
                while "warmup" in m.tenants:
                    await asyncio.sleep(0.01)
                await asyncio.sleep(cfg.duration_s / 2)
                return await loop.run_in_executor(None, lambda: (
                    urllib.request.urlopen(url, timeout=10).read()
                    .decode()))

            task = asyncio.ensure_future(asyncio.wait_for(scrape(), 120.0))
            rep = await replay(svc, cfg)
            return rep, await task, url

    def go():
        if not profile:
            return asyncio.run(scraped()), None
        import torch
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            res = asyncio.run(scraped())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(e.self_device_time_total for e in p.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        return res, (busy / 1e6, wall)

    ((rep, body, url), busy), wall60, n60, _ = timed_path(go)
    parsed = parse_prometheus(body)
    names = metric_names(parsed)
    served = sum(v for (nm, lk), v in parsed.items()
                 if nm == "repro_requests_served_total")
    log(f"  8.4 replay 60/s for 1.5 s with a live scrape of {url} "
        f"mid-window: "
        f"{len(parsed)} samples, {len(names)} families, requests served "
        f"so far={served}; offered={rep['offered']} served={rep['served']}"
        f"  p50={rep['p50_ms']} ms  p99={rep['p99_ms']} ms  ({wall60} s, "
        f"segreduce launches={n60})")
    if busy is not None:
        log(f"    traced: device busy={busy[0]} s of {busy[1]} s wall "
            f"({100 * busy[0] / busy[1]} %)")
    if not {"repro_requests_served_total",
            "repro_span_duration_seconds_bucket"} <= names or not served:
        raise AssertionError("live scrape")
    return {"front end replay sweep": n, "front end replay 60/s, scraped": n60}


def frontend_chaos_step() -> dict:
    """Phase 8.5: a sync service on a scripted clock serves 64 detects
    with a fault plan (``engine.detect`` raises twice), ``retry``, a
    breaker and the degraded tier; against the same requests without
    faults."""
    from repro_torch.resilience import (BreakerConfig, DegradedResult,
                                        FaultPlan, FaultSpec, RetryPolicy)
    from repro_torch.service import CommunityService, ServiceConfig

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    n_requests = 64
    graphs = [frontend_graph(FRONTEND_FAMILIES[i % 3], 900 + i, "cuda")
              for i in range(n_requests)]
    head = 16

    def serve(faults: bool):
        clock = Clock()
        kw = dict(batch_size=16, max_delay_s=0.025)
        if faults:
            kw.update(fault_plan=FaultPlan({"engine.detect": FaultSpec(
                p=1.0, count=2)}), retry=RetryPolicy(max_attempts=1),
                breaker=BreakerConfig(failure_threshold=2, cooldown_s=1.0),
                degrade_enabled=True, degrade_modes=("lpa",))
        svc = CommunityService(config=ServiceConfig(**kw), clock=clock,
                               device="cuda")
        futs = [svc.detect(f"c{i}", g) for i, g in enumerate(graphs[:head])]
        svc.pump(force=True)
        states = [svc.frontend.resilience.breaker_state(b)
                  for b in svc.config.buckets]
        clock.t += 1.5                    # past the breaker's cooldown
        futs += [svc.detect(f"c{i}", g)
                 for i, g in enumerate(graphs[head:], head)]
        svc.drain()
        return svc, [f.result() for f in futs], states

    (clean_svc, clean, _), wall_c, n_c, _ = timed_path(lambda: serve(False))
    (svc, got, states), wall, n, _ = timed_path(lambda: serve(True))
    res = svc.frontend.resilience
    degraded = [r for r in got if isinstance(r, DegradedResult)]
    flagged = all(not r.guarantee and r.quality == "degraded"
                  and r.mode == "lpa" for r in degraded)
    equal = all(same_entry(a, b) for a, b in zip(got, clean)
                if not isinstance(a, DegradedResult))
    end = set(res.board.states().values())
    log(f"  8.5 chaos: {n_requests} detects, engine.detect raising twice, "
        f"retry once, breaker (2 failures, 1 s cooldown), lpa degraded "
        f"tier: {len(degraded)} degraded (flagged={flagged}), the rest == "
        f"the fault-free run's bits={equal}  injected="
        f"{svc.frontend.config.fault_plan.injected['engine.detect']}  "
        f"splits={res.n_batch_splits}  breaker after the faults={states}, "
        f"at the end={sorted(end)}  {wall} s (fault-free {wall_c} s)  "
        f"segreduce launches={n} (fault-free {n_c})")
    if not (degraded and flagged and equal and end == {"closed"}):
        raise AssertionError("chaos")
    clean_svc.close()
    svc.close()
    return {"front end chaos (retry, breaker, lpa degraded tier)": n}


def frontend_phase(engine_walls: dict, profile: bool) -> dict:
    """Phase 8: the service front end on the card.  Returns the
    segment-reduce launches by path."""
    launches = {}
    for name, step in (
            ("8.1", frontend_sync_step),
            ("8.1b", lambda: frontend_vs_engine_step(engine_walls)),
            ("8.2", frontend_tiers_step),
            ("8.3", frontend_timeline_step),
            ("8.4", lambda: frontend_replay_step(profile)),
            ("8.5", frontend_chaos_step)):
        t0 = time.perf_counter()
        launches.update(step())
        log(f"  step {name}: {time.perf_counter() - t0} s")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=21,
                    help="R-MAT scale of the full-size graph (default 21)")
    ap.add_argument("--profile", action="store_true",
                    help="after phase 4, run detect() once more under "
                    "torch.profiler and print device time by kernel; trace "
                    "calls of each segsum, cumsum and spmm case of phase 5, "
                    "one engine batch a bucket of phase 6 and phase 8's "
                    "replay at 60/s too")
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
    tier_launches, fast = tiers_phase(g, res)
    by_path.update(tier_launches)
    by_path["update_communities (warm update)"], churn, warm = dynamic_phase(
        g, res.labels)
    by_path[f"detect dense standard, {DENSE_GRAPH}"] = dense_launches
    by_path[f"update_communities dense, {DENSE_GRAPH}"] = \
        update_dense_launches

    if args.profile:
        for algorithm in ("standard", "max-quality", "fast"):
            profile_phase(g, algorithm)

    log("phase 5: the kernel API vs plain, on the card")
    api_entries = api_phase(g, res.labels, profile=args.profile)

    log("phase 6: the batched engine and the store, on the card")
    engine_launches, engine, engine_walls = engine_phase(
        profile=args.profile)
    by_path.update(engine_launches)

    log("phase 7: the timeline, the checkpoint and the degraded tier, on "
        "the card")
    t0 = time.perf_counter()
    by_path.update(timeline_phase(g, res, fast, churn, warm, args.scale))
    by_path.update(resilience_small_phase(engine))
    log(f"  phase 7: {time.perf_counter() - t0} s")

    log("phase 8: the service front end, on the card")
    t0 = time.perf_counter()
    by_path.update(frontend_phase(engine_walls=engine_walls,
                                  profile=args.profile))
    log(f"  phase 8: {time.perf_counter() - t0} s")

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
