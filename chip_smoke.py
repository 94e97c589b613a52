#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py            # needs one CUDA card, nvcc and the repo

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (ptxas registers, shared memory and spills of the tensor-core flash,
   cumsum, spmm and dense-scan kernels).
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
   card run with its wall time and segment-reduce launches (and the dense
   half-sweep kernel's, ``csrc/dense_sweep.cu``, which the dense scan runs
   on the card: held bit for bit to its plain version on the card and the
   CPU at ``nv = 1025`` on six sweep states, then with the modularity
   kernel on the stress cases of ``tests/_torch_dense_cases.py`` and one
   vertex past ``MAX_NV``; each with its wrapper time, device time, the
   empty launch's as the floor, and its bound with the chain of its
   longest in-order fold);
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
   at its batch of 32).  ``engine.warm(bucket)`` (one full tile of
   filler graphs a tier, at the card's auto ``sub_batch`` of 8), then
   ``detect_batch`` of the 32 graphs with each tier; every result must
   equal ``detect()`` of the same graph on the card (labels,
   ``n_communities``, ``n_disconnected``, ``fraction``, the stats and Q's
   bits), with 0 disconnected for standard and max-quality; every tier
   takes the tile route, with fewer segment-reduce launches than the
   loop of ``detect()`` and, for standard and max-quality, fewer dense
   launches (LPA launches none either way).  Each batch prints its wall
   time, graphs/s, the same 32 graphs through a loop of ``detect()`` and
   the ratio of the two, launches and sweeps a batch and wall ms a sweep.
   Then each family's batches at the widths of ``TILE_WIDTHS`` (standard
   at ``sub_batch`` 1, 8 and 32, max-quality and fast at 8 and 32): every
   graph equal to its ``detect()``, width 1 (the loop) with the loop's
   launches, the tiles with fewer, max-quality with 0 disconnected, each
   with its wall, graphs/s and launches (``--profile``: one traced
   batch's device busy share); and the dense kernels at ``b`` 8 and 32
   (one launch for the tile) against their batched plain versions on the
   family's sweep and refinement states, every output bit for bit, and
   each graph's slice against its ``b = 1`` launch.
   Phase 3 makes the same check on its family at ``b = 8`` and times
   both kernels at ``b`` 8 and 32.  Then each family's 32 churn items
   (on the large bucket phase 3's 16 removals, 8 additions, 64 deletions
   and 32 insertions a graph; on the ego-nets 2, 2, 8 and 4; an item
   whose churn does not fit its bucket is skipped and printed), prepared
   by ``ResultStore.prepare_update`` from the standard labels, go through
   ``update_batch`` at ``sub_batch`` 1 (the loop), 8 and 32 (the tile,
   ``warm_update_tile``), each batch from a fresh store, and must equal,
   bit for bit, the immediate ``ResultStore.apply_update`` of the same
   items on a second store (graph, labels, counts, Q and version), with
   0 disconnected; the tiles launch fewer segment reduces and dense
   kernels than the loop.  Each batch prints its wall, graphs/s,
   launches, sweeps and affected vertices (``--profile``: one traced
   batch's device busy share).  Then the same for two families on the
   sortscan (``sortscan_families``): 32 ``rmat_graph(scale=12,
   edge_factor=8, seed=s, n_cap=4096, m_cap=65536)`` in ``Bucket(4096,
   65536)``, past the dense scan's 1,025 slots, and 32 sparse
   ``sbm_graph(1000, 20, 0.06, 0.0005, seed=s, n_cap=1024, m_cap=4096)``
   in ``Bucket(1024, 4096)``, under the card's 0.004 crossover; churn
   (64, 32, 256, 128) and (16, 8, 64, 32).  Their tiles run the
   sortscan on one union and launch no dense kernel (0 on the tile and
   on the loop), and their half-sweep on a union of 8 and 32 graphs is
   held on the card to each graph's half-sweep alone, bit for bit.  To
   keep the run inside its time limit they skip width 1 (the loop route,
   which the dense families check), and the sparse family runs the
   standard tier alone, then its update batches.

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
9. The sharded path, on the card (``launch/mesh.py``,
   ``core/distributed.py``): one worker process a rank, two or four ranks
   sharing ``cuda:0`` over gloo (NCCL refuses two ranks on one card).
   (1) ``louvain_sharded`` standard on phase 4's graph with 2 ranks:
   phase 4's labels, stats, community count and Q bits, 0 disconnected.
   (2) ``detect()`` with ``DetectOptions(mesh=...)`` for standard and
   max-quality, and ``louvain_sharded`` with the split policies of the
   reference's sharded test (none, sp-pj, sp-lp, sl-pj, refine), on phase
   3's two graphs with 2 and 4 ranks: each equal to the card's
   single-device bits.  (3) ``BatchedLouvainEngine.detect_sharded``
   equal to ``detect_one`` on phase 3's SBM.  (4) ``make_host_mesh(2)``
   raises on a machine of one card; with two cards or more (1) runs again
   on an NCCL mesh, one rank a card.  Each step prints its wall time and,
   per rank, its segment-reduce launches (above 0, counted in the
   worker), all-reduce calls and bytes, the graph's transfer to the
   worker, passes and sweeps, and the host partition and pass seconds;
   with the halo-byte counter and each mesh's worker start-up time.  A
   failure of any rank fails the phase.
10. Launch, examples and the harness, on the card.  (1) Each of the
   eight drivers of ``python -m repro_torch.launch.serve_communities``
   (the sync pump, ``--async``, ``--churn``, ``--replay``, ``--stream``,
   ``--sharded`` on two ranks sharing ``cuda:0``, ``--chaos``,
   ``--tiers``) in process with ``--smoke --device cuda``: every smoke
   assertion holds; its wall time and B.1 launches (above 0; the sharded
   driver's ranks too).  (2) Each of the six ``examples/torch_*.py`` with
   ``--device cuda``, its own asserts, wall time and launches.  (3)
   ``local_move`` from singletons on phase 4's graph with
   ``seg_impl='auto'`` (the fused sweep) and ``'scatter'`` (the
   reference's unfused one), auto, scatter, scatter, auto: the same C and
   Sigma bits and ``l_i``; each run's wall and launches and the scatter /
   auto ratio, the reference's paired sweep gate.  (4) The approximate
   harness ``run_louvain_multidevice`` on two ranks sharing ``cuda:0``:
   on phase 3's ``rmat_graph(scale=12, edge_factor=8, seed=1)`` its
   labels and stats equal two CPU ranks', then once on phase 4's graph,
   its wall, communities, Q and disconnected count (not phase 4's
   partition: the harness is approximate, ROADMAP C.4), with the caller's
   and each rank's launches.
11. The models, the optimiser and the trainers, on the card
   (``repro_torch.models``, ``optim``, ``launch.train``, ``launch.serve``).
   (a) TinyLlama-1.1B at its published config (22 layers, d_model 2048,
   32 heads, GQA kv 4, vocab 32,000) in bf16 with seeded random weights:
   a flash prefill at 4 x 2048 whose B.5 launches (reset just before)
   must be above 0 and all on the tensor cores, its last logits within
   the stated bf16 tolerance of the chunked route's and, against the
   float32 forward, no further off than the chunked route; decode after
   a 16-token prompt against the forward at that position (float32 at the
   reference test's 2e-2, bf16 at the bf16 tolerance); ``generate`` of 32
   greedy tokens, whose first is the argmax of those logits.  (b)
   Mixtral-8x7B at full width cut to 2 of its 32 layers (the whole model
   does not fit one card): a flash prefill of 8,192 tokens over its
   4,096-token window, ``moe_dropless``, against the chunked route, then 8
   decode tokens from the prefilled rolling cache.  (c) ``train_lm`` on
   smollm-360m (5 steps, 4 x 1024, remat), ``train_recsys`` on BST (5
   steps at 65,536, the 4M-item table) and ``train_gnn`` on the four GNNs
   at Cora's shape: every loss and gradient norm finite.  (d) Each LM
   smoke config's float32 forward with flash on the card against the
   CPU's plain route, within 1e-4.  Each run prints its wall time, tokens
   a second or seconds a step, peak device memory and B.5 launches,
   beside the card's name and power limit.
12. The sharding rules, the step builder, the dry run and the roofline
   (``repro_torch.launch.steps``, ``launch.dryrun``, ``roofline``).  (a)
   The dry run on the card's host: a ``fake`` process group of 256 and of
   512 ranks, the production ``(16, 16)`` and ``(2, 16, 16)`` meshes,
   each cell's step traced once on DTensors of fake tensors (no memory,
   no launch; ``launch.dryrun.TRACE_DEVICE``) for TinyLlama-1.1B train_4k, prefill_32k and
   decode_32k, Mixtral-8x7B train_4k, GCN full_graph_sm, GAT minibatch_lg
   and BST train_batch, at published widths, the LMs' depth cut to
   ``DRYRUN_LM_LAYERS`` layers (the trace runs every op of every layer in
   Python; a full-depth LM cell takes minutes); each record's ``[ok]``
   line and the H100 table beside the card's line.  (b) The roofline
   against the card: a world-size-1 NCCL group in this process, a ``(1,
   1)`` ``(data, model)`` ``DeviceMesh`` on ``cuda:0``, and ``build_cell``
   of TinyLlama-1.1B prefill_32k with ``attn_impl='flash'`` at batch 1,
   smollm-360m train_4k at batch ``SMOLLM_BATCH``, GCN full_graph_sm and
   BST serve_p99 (whole); each plan traced on fake tensors, then run on
   DTensors of seeded inputs: 2 warm-up steps, the median of 5, beside the
   traced bound and bottleneck (a step slower than 2 s: 1 warm-up, 1
   timed), the measured roofline fraction
   ``(model_flops / peak) / s`` and the traced peak bytes beside
   ``torch.cuda.max_memory_allocated``.  It fails where the traced
   argument bytes differ from the real inputs', a step beats its bound by
   more than 5 %, the prefill's step makes other than one B.5 launch a
   layer, or the prefill misses its plain routes
   (:func:`prefill_against_plain`: the same plan's last logits with the
   chunked route, in bfloat16 and float32, as in 11a, and B.5 at one
   layer's shape against its plain version, as in phase 5).  The traced
   peak is read beside the real peak of a step whose predecessor's output
   is no longer live.

``--profile`` adds a traced run of phase 4's ``detect()`` of each tier
(device time by kernel, the device's busy share, and each segment-reduce
kernel's total), in phase
5, three traced calls of each ``segsum``, ``cumsum`` and ``spmm`` case
(device time a call by kernel), and in phase 6 one traced standard batch
of each bucket and each width's tiles and update batches (CUDA kernel
launches and the device's busy share), and in
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
from concurrent.futures import ThreadPoolExecutor
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
                 ("cumsum", "cumsum_cols"), ("spmm", "bucket_spmm_kernel"),
                 ("dense_sweep", "dense_rows"), ("dense_sweep", "dense_sigma"),
                 ("dense_sweep", "dense_modularity_kernel"))


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

    from repro_torch.kernels.flash_attn import attention_pairs

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
    launches of the dense standard run: the segment reduce's and the dense
    half-sweep kernel's."""
    from repro_torch.core import DetectOptions, LouvainConfig, detect
    from repro_torch.kernels.dense_sweep import (dense_half_sweep_cuda,
                                                 dense_modularity_cuda)

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

        dense_half_sweep_cuda.launches = dense_modularity_cuda.launches = 0
        dense, wall, n, _ = timed_path(
            lambda: detect(g_card, options=opts("dense")))
        n_dense = (dense_half_sweep_cuda.launches,
                   dense_modularity_cuda.launches)
        sort, wall_sort, n_sort, _ = timed_path(
            lambda: detect(g_card, options=opts("sort")))
        on_cpu = detect(g_cpu, options=opts("dense"), device="cpu")
        equal = same_detection(dense, on_cpu) and same_detection(dense, sort)
        log(f"  dense {algorithm}/{split}: card dense == CPU dense == card "
            f"sort (labels, stats, Q bits)={equal}  communities="
            f"{dense.n_communities}  disconnected={dense.n_disconnected}  "
            f"sweeps={dense.stats['li_total']}  Q={dense.modularity:.9f}  "
            f"card wall dense={wall} s ({n} segreduce launches, "
            f"{n_dense[0]} dense_half_sweep, {n_dense[1]} dense_modularity)"
            f"  sort={wall_sort} s ({n_sort})")
        if not equal or (promises_connected(algorithm, split)
                         and dense.n_disconnected):
            raise AssertionError(
                f"dense scan mismatch on {DENSE_GRAPH}, {algorithm}/{split}")
        if (algorithm, split) == ("standard", "sp-pj"):
            standard_launches = n, n_dense
    return standard_launches


DENSE_SOURCE = "src/repro_torch/kernels/csrc/dense_sweep.cu"
# the function it replaces: the reference's dense half-sweep, XLA code
DENSE_REPLACES = "src/repro/core/local_move.py:361"
# and the reference's realized modularity, which its sweep loop calls
DENSE_Q_REPLACES = "src/repro/core/local_move.py:124"
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 rate off the tensor cores


def dense_device_us(fn, kernels, calls: int = 20):
    """Device microseconds a call of ``fn()`` spends in the named kernels,
    from ``torch.profiler`` over ``calls`` calls (None if the trace holds
    no device time for them); each kernel's is logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {k: sum(e.self_device_time_total for e in prof.key_averages()
                 if k in e.key) / calls for k in kernels}
    log(f"    device us a call by kernel: {by}")
    us = sum(by.values())
    return us if us > 0 else None


def events_ms(fn, calls: int = 100) -> float:
    """CUDA-event milliseconds a call over ``calls`` back-to-back calls of
    ``fn()`` (after one warm call): a launch's device time where the host
    enqueues faster than the card runs, else the host's time a launch."""
    import torch

    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def host_call_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call of ``fn()`` over ``calls`` calls, the card
    left to run behind them (synchronized before and after)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def fold_chain(n: int) -> int:
    """The dependent adds of ``ops.sum_inorder`` over ``n`` values: a leaf
    chunk's, then one chunk's at each level above."""
    chain, level = min(max(n, 1), DENSE_CHUNK), -(-max(n, 1) // DENSE_CHUNK)
    while level > 1:
        chain += min(level, DENSE_CHUNK)
        level = -(-level // DENSE_CHUNK)
    return chain


DENSE_CHUNK = 1024                # ops.FLAT_CHUNK


def dense_stress_checks() -> int:
    """Phase 3, the dense kernels on the stress cases of
    ``tests/_torch_dense_cases.py`` (a hub row of degree ``nv - 1``, one
    community, all singletons, ``m`` ragged and past 65,536, ``nv = 2``,
    refine's masked weights) and one vertex past ``MAX_NV``: each
    half-sweep variant and the modularity of its result bit for bit equal
    to the plain versions on the card, and to a second launch.  Returns the
    number of checks; raises on a miss."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_dense_cases import dense_cases, past_max_nv_case

    from repro_torch.core.local_move import (_half_sweep_dense,
                                             _half_sweep_dense_plain,
                                             realized_modularity)
    from repro_torch.kernels.dense_sweep import MAX_NV, dense_modularity_cuda

    def t(x):
        return torch.from_numpy(np.asarray(x).copy()).cuda()

    checks, misses = 0, []
    for c in dense_cases() + [past_max_nv_case(MAX_NV)]:
        two_m = torch.tensor(np.float32(c["two_m"]), device="cuda")
        args = (t(c["src"]), t(c["dst"]), t(c["w"]), t(c["C"]), t(c["K"]),
                t(c["Sigma"]), two_m, t(c["movable"]))
        for target, anchored in ((True, True), (False, True),
                                 (False, False)):
            kw = dict(target_ok=t(c["target_ok"]) if target else None,
                      anchored=anchored)
            got = _half_sweep_dense(*args, **kw)
            again = _half_sweep_dense(*args, **kw)
            plain = _half_sweep_dense_plain(*args, **kw)
            ok = all(bits_equal(a, p) and bits_equal(a, b)
                     for a, b, p in zip(got, again, plain))
            q_args = args[:3] + (got[0], got[1], two_m)
            q = dense_modularity_cuda(*q_args)
            ok_q = bits_equal(q, realized_modularity(*q_args)) and \
                bits_equal(q, dense_modularity_cuda(*q_args))
            checks += 1
            if not (ok and ok_q):
                misses.append(f"{c['name']} target={target} "
                              f"anchored={anchored} (sweep {ok}, Q {ok_q})")
        log(f"  dense stress {c['name']}: nv={c['nv']} m={len(c['src'])}: "
            f"kernel == plain == a second launch (every output, Q)="
            f"{not any(x.startswith(c['name'] + ' ') for x in misses)}")
    if misses:
        raise AssertionError("dense kernels differ from their plain "
                             "versions: " + "; ".join(misses))
    return checks


def bits_equal(a, b) -> bool:
    """Tensors equal in shape and bits (float32 as int32)."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def dense_sweep_phase(launches) -> list:
    """Phase 3, the dense scan's kernels (``csrc/dense_sweep.cu``) at their
    full width, ``nv = 1025``, on a seeded sweep state: the half-sweep's
    every output bit for bit against its plain version on the card and on
    a CPU copy, with and without targets and anchoring and on refine's
    masked weights, and the loop's realized modularity the same way; then
    the stress cases (:func:`dense_stress_checks`).  Each kernel's time:
    the wrapper's (CUDA events around the call, host time included, as
    the main path pays it), its device time (``torch.profiler``; else
    events around 100 back-to-back bare launches), the empty launch's
    beside them as the floor, its plain version's, and its bound: bytes,
    operations, and the chain of its longest in-order fold (4 cycles an
    add at the card's top clock).  ``launches`` is their counts in the
    dense standard ``detect()`` of :func:`dense_phase`.  Returns their
    JSON entries."""
    import ctypes

    import numpy as np
    import torch

    from repro_torch.core.local_move import (_half_sweep_dense,
                                             _half_sweep_dense_plain,
                                             realized_modularity)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import dense_sweep as ds

    if min(launches) == 0:
        raise AssertionError("the dense standard detect() launched no "
                             f"dense_sweep kernel: {launches}")
    g = {d: dense_graph(d) for d in ("cuda", "cpu")}
    nv, m = g["cpu"].nv, g["cpu"].m_cap
    rng = np.random.default_rng(11)
    C = rng.integers(0, nv - 1, nv).astype(np.int32)
    C[nv - 1] = nv - 1
    movable = rng.random(nv) < 0.5
    target = rng.random(nv) < 0.5
    part = rng.integers(0, 16, nv).astype(np.int32)    # refine's mask
    cases = []
    for masked in (False, True):
        for t, a in ((True, True), (False, True), (False, False)):
            args = {}
            for d in ("cuda", "cpu"):
                gd = g[d]
                Cd = torch.from_numpy(C).to(d)
                pd = torch.from_numpy(part).to(d)
                w = torch.where(pd[gd.src] == pd[gd.dst], gd.w, 0.0) \
                    if masked else gd.w
                K = ops.segreduce_sorted(gd.w, gd.src, nv, op="sum")
                Sigma = ops.segment_sum_inorder(K, Cd, nv)
                args[d] = ((gd.src, gd.dst, w, Cd, K, Sigma,
                            gd.total_weight_2m(),
                            torch.from_numpy(movable).to(d)),
                           dict(target_ok=torch.from_numpy(target).to(d)
                                if t else None, anchored=a))
            got = _half_sweep_dense(*args["cuda"][0], **args["cuda"][1])
            plain = _half_sweep_dense_plain(*args["cuda"][0],
                                            **args["cuda"][1])
            cpu = _half_sweep_dense(*args["cpu"][0], **args["cpu"][1])
            equal = all(
                same_bits(x, y) and same_bits(x, z)
                if x.dtype == torch.float32 else
                torch.equal(x.cpu(), y.cpu()) and torch.equal(x.cpu(),
                                                              z.cpu())
                for i, (x, y, z) in enumerate(zip(got, plain, cpu))
                if i != 3)          # gain: torch.sum, its tree by device
            name = (f"{'masked' if masked else 'weights'}, "
                    f"{'targets' if t else 'no targets'}, "
                    f"{'anchored' if a else 'all'}")
            log(f"  dense_half_sweep {name}: kernel == plain on the card == "
                f"plain on the CPU (C, Sigma bits, moved, want)={equal}  "
                f"moved={int(got[2].sum())}")
            if not equal:
                raise AssertionError(f"dense_half_sweep {name}")
            cases.append(args["cuda"])
    log(f"  dense stress checks: {dense_stress_checks()} sweeps and "
        f"modularities equal")

    clock_mhz = max_sm_clock_mhz()
    stream = torch.cuda.current_stream().cuda_stream
    noop = _build.bind("dense_sweep", "dense_noop_launch", (ctypes.c_void_p,))
    floor_ms = events_ms(lambda: noop(stream))
    floor_device_us = dense_device_us(lambda: noop(stream), ("dense_noop",))
    floor_wrapper_ms = median_ms(ds.noop_launch)
    floor_host_us = host_call_us(ds.noop_launch)
    log(f"  empty launch: {floor_ms} ms a launch back to back (events), "
        f"device {floor_device_us} us (profiler), {floor_wrapper_ms} ms "
        f"through its Python wrapper ({floor_host_us} us of host a call)")

    (args, kw) = cases[0]
    rows = ds.edge_rows(args[0], nv)
    e_src, e_dst, e_w, e_C, e_K, e_Sigma, two_m, e_mov = args
    # with the gain's sum, as earlier runs timed it, and as the sweep loop
    # calls it (no gain)
    ms = median_ms(lambda: _half_sweep_dense(*args, rows=rows, **kw))
    loop_ms = median_ms(lambda: _half_sweep_dense(*args, rows=rows,
                                                  gain=False, **kw))
    host_us = host_call_us(
        lambda: ds.dense_half_sweep_cuda(rows, *args[1:], **kw))
    plain_ms = median_ms(lambda: _half_sweep_dense_plain(*args, **kw))
    device_us = dense_device_us(
        lambda: ds.dense_half_sweep_cuda(rows, *args[1:], **kw),
        ("dense_rows", "dense_sigma"))
    out = ds.dense_half_sweep_cuda(rows, *args[1:], **kw)
    plan = ds.sweep_plan(nv)
    assert plan["scratch_floats"] == 0
    sweep = _build.bind("dense_sweep", "dense_half_sweep", ds._ARGS)
    ptrs = ([x.data_ptr() for x in (rows[0], rows[1], e_dst, e_w, e_C, e_K,
                                    e_Sigma, two_m, e_mov)]
            + [kw["target_ok"].data_ptr(), int(kw["anchored"]), nv, 1]
            + [out[i].data_ptr() for i in (0, 2, 3, 4, 1)]
            + [None, plan["grid"], plan["rows_smem"], plan["sigma_smem"],
               stream])
    bare_ms = events_ms(lambda: sweep(*ptrs))
    # The work counted is what the kernel needs on this case's edges: the
    # live ones, those of the rows below the ghost row (no output reads a
    # cell of the ghost row, and the kernel skips its padding edges).  Each
    # input read once and each output written once: order, dst, w a live
    # edge; C, K, Sigma, movable, target_ok and row_ptr a vertex; C_new,
    # Sigma_new, best, move, want a vertex.  Operations: Eq. 2 (eight
    # float32 operations) on each cell that holds weight, the only cells
    # whose score is read (W_all > 0 or W_frz > 0), the edge folds (two
    # adds a live edge) and the Sigma recompute (nv adds).  Chain: the
    # longest cell's edges (the rows' folds), then the largest new
    # community (Sigma's), one after the other
    live = e_src < nv - 1
    m_live = int(live.sum())
    held = live & (e_src != e_dst) & (e_w > 0)
    cells = int(torch.unique(e_src[held].long() * nv
                             + e_C[e_dst[held]].long()).numel())
    keys = e_src[live].long() * nv + e_C[e_dst[live].long()].long()
    longest_cell = int(torch.unique(keys, return_counts=True)[1].max())
    largest_comm = int(torch.bincount(out[0].long(), minlength=nv).max())
    chain = longest_cell + largest_comm
    nbytes = (12 * m_live + (4 + 4 + 4 + 1 + 1 + 4) * nv
              + (4 + 4 + 4 + 1 + 1) * nv)
    nops = 8 * cells + 2 * m_live + nv
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / F32_FLOPS_PER_S * 1e3
    chain_ms = chain * FADD_CYCLES / (clock_mhz * 1e6) * 1e3
    bound_ms = max(bytes_ms, ops_ms, chain_ms)
    device_ms = None if device_us is None else device_us / 1e3
    log(f"  dense_half_sweep at nv={nv}, m={m} ({m_live} live edges, "
        f"{cells} cells with weight): host_us={host_us} (the wrapper)  "
        f"ms={ms} (_half_sweep_dense with the gain's sum)  loop_ms="
        f"{loop_ms} (without it, as the sweep loop calls it)  "
        f"device_ms={device_ms} (profiler: "
        f"dense_rows + dense_sigma)  bare_ms={bare_ms} (events, back to "
        f"back)  floor_ms={floor_ms}  plain_ms={plain_ms}  bound_ms="
        f"{bound_ms} (bytes {bytes_ms}, operations {ops_ms}, chain "
        f"{chain_ms}: {longest_cell} adds of the longest cell + "
        f"{largest_comm} of the largest community x {FADD_CYCLES} cycles at "
        f"{clock_mhz:.0f} MHz)  launches in the dense standard detect()="
        f"{launches[0]}")
    sweep_entry = dict(
        name="dense_half_sweep", route="cuda", source=DENSE_SOURCE,
        replaces=DENSE_REPLACES, launches=launches[0], max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if bytes_ms >= max(ops_ms, chain_ms)
        else "operations", library_ms=None, loop_ms=loop_ms,
        host_us=host_us, device_ms=device_ms, bare_ms=bare_ms,
        floor_ms=floor_ms, m_live=m_live,
        chain_bound_ms=chain_ms, chain_adds=chain, sm_clock_mhz=clock_mhz)

    # the sweep loop's realized modularity, kernel vs plain, card and CPU
    q = {}
    for d in ("cuda", "cpu"):
        gd = g[d]
        Cd = torch.from_numpy(C).to(d)
        K = ops.segreduce_sorted(gd.w, gd.src, nv, op="sum")
        Sigma = ops.segment_sum_inorder(K, Cd, nv)
        q[d] = (gd.src, gd.dst, gd.w, Cd, Sigma, gd.total_weight_2m())
    got = ds.dense_modularity_cuda(*q["cuda"])
    plain = realized_modularity(*q["cuda"])
    cpu = realized_modularity(*q["cpu"])
    equal = same_bits(got, plain) and same_bits(got, cpu)
    q_ms = median_ms(lambda: ds.dense_modularity_cuda(*q["cuda"]))
    q_host_us = host_call_us(lambda: ds.dense_modularity_cuda(*q["cuda"]))
    q_plain_ms = median_ms(lambda: realized_modularity(*q["cuda"]))
    # its launcher zeroes the ticket on the stream first: a device memset
    q_device_us = dense_device_us(
        lambda: ds.dense_modularity_cuda(*q["cuda"]),
        ("dense_modularity_kernel", "Memset"))
    qp = ds.modularity_plan(m, nv)
    scratch = torch.empty(qp["scratch_floats"], dtype=torch.float32,
                          device="cuda")
    modularity = _build.bind("dense_sweep", "dense_modularity", ds._Q_ARGS)
    q_ptrs = ([x.data_ptr() for x in q["cuda"]]
              + [None, m, nv, qp["n_int"], qp["blocks"], 1,
                 scratch.data_ptr(), qp["half"], scratch[-1].data_ptr(),
                 stream])
    q_bare_ms = events_ms(lambda: modularity(*q_ptrs))
    if not bits_equal(scratch[-1], got):
        raise AssertionError("a bare dense_modularity launch differs")
    # src, dst, w an edge and C, Sigma a vertex read once; one value
    # written; an add an edge and a multiply and an add a vertex; the
    # chain: the longer of the two trees' in-order folds
    q_bytes_ms = (12 * m + 8 * nv + 4) / HBM_BYTES_PER_S * 1e3
    q_ops_ms = (m + 2 * nv) / F32_FLOPS_PER_S * 1e3
    q_chain = max(fold_chain(m), fold_chain(nv))
    q_chain_ms = q_chain * FADD_CYCLES / (clock_mhz * 1e6) * 1e3
    q_bound_ms = max(q_bytes_ms, q_ops_ms, q_chain_ms)
    q_device_ms = None if q_device_us is None else q_device_us / 1e3
    log(f"  dense_modularity at nv={nv}, m={m}: kernel == plain on the card "
        f"== plain on the CPU (bits)={equal}  Q={float(got)!r}  ms={q_ms}  "
        f"host_us={q_host_us}  "
        f"device_ms={q_device_ms}  bare_ms={q_bare_ms}  floor_ms="
        f"{floor_ms}  plain_ms={q_plain_ms}  bound_ms={q_bound_ms} (bytes "
        f"{q_bytes_ms}, operations {q_ops_ms}, chain {q_chain_ms}: "
        f"{q_chain} adds)  launches in the dense standard detect()="
        f"{launches[1]}")
    if not equal:
        raise AssertionError("dense_modularity differs from its plain "
                             "version")
    q_entry = dict(
        name="dense_modularity", route="cuda", source=DENSE_SOURCE,
        replaces=DENSE_Q_REPLACES, launches=launches[1], max_abs_err=0.0,
        ms=q_ms, plain_ms=q_plain_ms, bound_ms=q_bound_ms,
        bound_by="bytes" if q_bytes_ms >= max(q_ops_ms, q_chain_ms)
        else "operations", library_ms=None, host_us=q_host_us,
        device_ms=q_device_ms,
        bare_ms=q_bare_ms, floor_ms=floor_ms, chain_bound_ms=q_chain_ms,
        chain_adds=q_chain, sm_clock_mhz=clock_mhz)
    tile_timings(sweep_entry, q_entry)
    return [sweep_entry, q_entry]


def tile_timings(sweep_entry, q_entry):
    """Phase 3, the dense kernels with a graph axis on phase 3's family
    (phase 6's large bucket, ``nv = 1025``): held to their batched plain
    versions at ``b = 8``, then each kernel's wrapper time (CUDA events,
    host included) and device time (profiler) at ``b`` 8 and 32, against
    its plain version's, added to the kernels' entries."""
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_tile_cases import tile_state

    from repro_torch.core.local_move import (_half_sweep_dense_plain,
                                             realized_modularity_tile)
    from repro_torch.kernels import dense_sweep as ds

    fam = engine_families()[0][2]
    log(f"  dense kernels at b=8 on phase 3's states: "
        f"{tile_kernel_checks(fam[:8], seed=11)} checks equal to the "
        f"batched plain versions")
    for b in (8, 32):
        _, union, u = tile_state(fam[:b], seed=b)
        src, dst, w, C, K, Sigma, two_m, movable, tok = union
        rows = ds.edge_rows(src, C.shape[0])
        eptr = torch.tensor(u.edge_offsets, dtype=torch.int32,
                            device="cuda")

        def sweep():
            return ds.dense_half_sweep_cuda(rows, dst, w, C, K, Sigma, two_m,
                                            movable, tok, graphs=b)

        def q():
            return ds.dense_modularity_cuda(src, dst, w, C, Sigma, two_m,
                                            edge_counts=u.counts,
                                            edge_ptr=eptr)

        ms, q_ms = median_ms(sweep), median_ms(q)
        dev = dense_device_us(sweep, ("dense_rows", "dense_sigma"))
        q_dev = dense_device_us(q, ("dense_modularity_kernel", "Memset"))
        plain_ms = median_ms(lambda: _half_sweep_dense_plain(
            src, dst, w, C, K, Sigma, two_m, movable, tok, graphs=b,
            gain=False))
        q_plain_ms = median_ms(lambda: realized_modularity_tile(
            src, dst, w, C, Sigma, two_m, u.counts))
        log(f"  tile of b={b} at nv={u.nv} ({src.shape[0]} live edges): "
            f"dense_half_sweep ms={ms} device_ms="
            f"{None if dev is None else dev / 1e3} plain_ms={plain_ms}  "
            f"dense_modularity ms={q_ms} device_ms="
            f"{None if q_dev is None else q_dev / 1e3} plain_ms="
            f"{q_plain_ms}")
        for e, t, d, p in ((sweep_entry, ms, dev, plain_ms),
                           (q_entry, q_ms, q_dev, q_plain_ms)):
            e[f"b{b}_ms"] = t
            e[f"b{b}_device_ms"] = None if d is None else d / 1e3
            e[f"b{b}_plain_ms"] = p


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


SORTSCAN_RMAT = "rmat_graph(scale=12, edge_factor=8, seed=0..31)"
SORTSCAN_SBM = "sbm_graph(1000, 20, 0.06, 0.0005, seed=0..31)"


def sortscan_families():
    """Phase 6's two sortscan workloads, (name, bucket, graphs on the
    card, the tile widths of each tier it runs): R-MAT neighbourhoods
    past the dense scan's 1,025 slots, and sparse road-like SBM patches
    under the card's 0.004 crossover.  To keep the whole run inside its
    time limit, both skip width 1 (the loop route, which the dense
    families check) and the sparse family runs the standard tier alone
    (and its update batches)."""
    from repro_torch.graph import rmat_graph, sbm_graph
    from repro_torch.service import Bucket

    rmat = [rmat_graph(scale=12, edge_factor=8, seed=s, n_cap=4096,
                       m_cap=65536, device="cuda")
            for s in range(ENGINE_BATCH)]
    sparse = [sbm_graph(1000, 20, 0.06, 0.0005, seed=s, n_cap=1024,
                        m_cap=4096, device="cuda")[0]
              for s in range(ENGINE_BATCH)]
    return [(f"{SORTSCAN_RMAT} in Bucket(4096, 65536)",
             Bucket(4096, 65536), rmat,
             {alg: (8, 32) for alg in TILE_WIDTHS}),
            (f"{SORTSCAN_SBM} in Bucket(1024, 4096)", Bucket(1024, 4096),
             sparse, {"standard": (8, 32)})]


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
    """One traced detect batch: :func:`traced`."""
    return traced(lambda: engine.detect_batch(graphs, algorithm=algorithm))


def traced(fn):
    """``fn()`` once under the profiler: ``(wall seconds, CUDA kernel
    launches (runtime launch calls), device busy seconds)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
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
    import torch

    from repro_torch.core import DetectOptions, detect
    from repro_torch.core.portfolio import ALGORITHMS
    from repro_torch.service import BatchedLouvainEngine

    engine = BatchedLouvainEngine(algorithms=ALGORITHMS)
    launches = {}
    standard = {}
    walls = {}
    loops = {}
    fams = [f + (TILE_WIDTHS,) for f in engine_families()] + \
        sortscan_families()
    for name, bucket, graphs, tiers in fams:
        n = len(graphs)
        scan = engine.scan_for(bucket)
        log(f"  {name}: scan={scan}  sub_batch={engine.sub_batch} (auto)  "
            f"live directed edges a graph="
            f"{min(g.num_edges() for g in graphs)}.."
            f"{max(g.num_edges() for g in graphs)}")
        t0 = time.perf_counter()
        n_warm = engine.warm(bucket)
        torch.cuda.synchronize()
        log(f"    warm(bucket): {n_warm} full tiles of filler graphs in "
            f"{time.perf_counter() - t0} s  keys={len(engine.cache_keys())}")
        for alg in tiers:
            (res, n_dense), wall, n_seg, peak = timed_path(
                lambda: dense_counted(
                    lambda: engine.detect_batch(graphs, algorithm=alg)))
            hit = engine.last_detect_info.compile_hit
            route = engine.last_detect_info.route
            opts = DetectOptions(algorithm=alg)
            (dets, n_dense_loop), wall_loop, n_loop, _ = timed_path(
                lambda: dense_counted(
                    lambda: [detect(g, options=opts) for g in graphs]))
            equal = all(same_as_detect(r, d) for r, d in zip(res, dets))
            sweeps = sum(r.sweeps for r in res)
            n_disc = sum(r.n_disconnected for r in res)
            log(f"    detect_batch {alg} ({route}): equal to detect() "
                f"(labels, counts, stats, Q bits)={equal}  key hit={hit}  "
                f"batch wall={wall} s ({n / wall} graphs/s)  loop of "
                f"detect()={wall_loop} s  loop/batch={wall_loop / wall}  "
                f"segreduce launches a batch={n_seg} (loop {n_loop})  dense "
                f"kernel launches={n_dense} (loop {n_dense_loop})  sweeps a "
                f"batch={sweeps}  wall ms a sweep="
                f"{1e3 * wall / max(sweeps, 1)}  disconnected={n_disc}  "
                f"peak device memory={peak:.3f} GiB")
            # the loop route launches what the loop of detect() does; the
            # tile route fewer (LPA and the sortscan launch no dense kernel)
            ok = launches_ok(alg, route, (n_seg, n_dense),
                             (n_loop, n_dense_loop), scan)
            if not equal or not hit or route != "tile" or not ok:
                raise AssertionError(
                    f"engine {alg} on {name} ({route}): equal={equal} key "
                    f"hit={hit} launches {n_seg}/{n_dense} against "
                    f"detect()'s {n_loop}/{n_dense_loop}")
            if alg != "fast" and n_disc:
                raise AssertionError(f"engine {alg}: {n_disc} disconnected")
            launches[f"engine detect_batch {alg}, {name}"] = n_seg
            loops[name, alg] = (dets, wall_loop, n_loop, n_dense_loop)
            if alg == "standard":
                standard[name] = res
                walls[name] = wall
        if profile:
            wall, n_launch, busy = traced_batch(engine, graphs, "standard")
            sweeps = sum(r.sweeps for r in standard[name])
            log(f"    traced detect_batch standard: wall={wall} s  CUDA "
                f"kernel launches={n_launch} ({n_launch / max(sweeps, 1)} a "
                f"sweep)  device busy={busy} s ({100 * busy / wall} %)")
    launches.update(tile_widths(fams, loops, profile))

    launches.update(update_widths(fams, standard, profile))
    return launches, engine, walls


# each family's churn: (remove, add, delete, insert) a graph, scaled to
# its bucket (the two dense families, then the two sortscan ones)
UPDATE_CHURN = ((16, 8, 64, 32), (2, 2, 8, 4), (64, 32, 256, 128),
                (16, 8, 64, 32))
# the update batches' widths (width 1 is the loop route)
UPDATE_WIDTHS = (1, 8, 32)


def same_entries(a, b, ids) -> bool:
    """Two stores' entries of ``ids``: graph, labels, counts, Q bits and
    version."""
    import numpy as np
    import torch

    ok = True
    for gid in ids:
        x, y = a.get(gid), b.get(gid)
        ok &= (np.array_equal(x.C, y.C) and x.q == y.q
               and (x.version, x.n_communities, x.n_disconnected)
               == (y.version, y.n_communities, y.n_disconnected)
               and all(torch.equal(getattr(x.graph, k), getattr(y.graph, k))
                       for k in ("src", "dst", "w", "n_nodes")))
    return ok


def update_widths(fams, standard, profile) -> dict:
    """Phase 6's warm updates: each family's 32 churn items
    (:data:`UPDATE_CHURN`; an item whose churn does not fit the bucket is
    skipped and printed) through ``update_batch`` at each of
    :data:`UPDATE_WIDTHS` (1 the loop route, the others the tile,
    ``core/dynamic.py:warm_update_tile``), each from a fresh store at the
    standard batch's labels, against the same items through a second
    store's immediate ``apply_update``: graph, labels, counts, Q bits and
    version equal, nothing disconnected.  A tile launches fewer segment
    reduces and, on the dense scan, fewer dense kernels than the loop;
    on the sortscan neither launches a dense kernel.  Prints each batch's wall,
    graphs/s, launches, sweeps and affected vertices, and under
    ``--profile`` one traced batch's device busy share.  Returns the
    launches by path."""
    import torch

    from repro_torch.service import BatchedLouvainEngine, ResultStore
    from repro_torch.service.store import CapacityExceeded

    out = {}
    for (name, bucket, graphs, _), churn in zip(fams, UPDATE_CHURN):
        entries = {f"g{i}": e for i, e in enumerate(zip(graphs,
                                                        standard[name]))}

        def store(ids):
            st = ResultStore()
            for gid in ids:
                g, r = entries[gid]
                st.put(gid, g, r.C, n_communities=r.n_communities,
                       n_disconnected=r.n_disconnected, q=r.q)
            return st

        immediate = store(entries)
        upds, skipped = {}, []
        for i, (gid, (g, _)) in enumerate(entries.items()):
            try:
                upd = churn_batch(g, seed=100 + i, remove=churn[0],
                                  add=churn[1], delete=churn[2],
                                  insert=churn[3])[0]
                immediate.prepare_update(gid, upd)  # pure: a capacity test
            except (ValueError, AssertionError, CapacityExceeded) as e:
                skipped.append((100 + i, type(e).__name__))
                continue
            upds[gid] = upd
        ids = list(upds)
        _, wall_imm, n_imm, _ = timed_path(lambda: [
            immediate.apply_update(gid, upds[gid]) for gid in ids])
        log(f"  update_batch, {name}: {len(ids)} churn items (remove, add, "
            f"delete, insert)={churn} a graph, seeds skipped (did not fit "
            f"the bucket)={skipped}  immediate apply_update (prepare "
            f"included)={wall_imm} s  segreduce launches={n_imm}")
        loop = None
        for width in UPDATE_WIDTHS:
            eng = BatchedLouvainEngine(sub_batch=width)
            dense = eng.scan_for(bucket) == "dense"
            eng.warm_updates(bucket)
            batched = store(ids)
            t0 = time.perf_counter()
            plans = [batched.prepare_update(gid, upds[gid]) for gid in ids]
            torch.cuda.synchronize()
            t_prep = time.perf_counter() - t0
            items = [(p.graph, p.C_prev, p.touched) for p in plans]
            (res, n_dense), wall, n_seg, peak = timed_path(
                lambda: dense_counted(lambda: eng.update_batch(items)))
            info = eng.last_update_info
            for p, r in zip(plans, res):
                batched.commit_update(p, C=r.C,
                                      n_communities=r.n_communities,
                                      n_disconnected=r.n_disconnected,
                                      q=r.q)
            equal = same_entries(batched, immediate, ids)
            sweeps = sum(r.iterations for r in res)
            n_disc = sum(r.n_disconnected for r in res)
            route = "loop" if width == 1 else "tile"
            if loop is None:
                loop = (wall, n_seg, n_dense)
            log(f"    update_batch sub_batch={width} ({info.route}, "
                f"{-(-len(ids) // width)} tiles, fill={info.fill}): equal "
                f"to immediate apply_update (graph, labels, counts, Q bits, "
                f"version)={equal}  host prepare={t_prep} s  batch wall="
                f"{wall} s ({len(res) / wall} graphs/s)  loop/batch="
                f"{loop[0] / wall}  segreduce launches a batch={n_seg} (loop "
                f"{loop[1]})  dense kernel launches a batch={n_dense} (loop "
                f"{loop[2]})  sweeps a batch={sweeps}  affected="
                f"{sum(r.n_affected for r in res)}  disconnected={n_disc}  "
                f"peak device memory={peak:.3f} GiB")
            ok = info.route == route and equal and n_disc == 0
            if route == "tile":
                ok &= n_seg < loop[1] and (n_dense < loop[2] if dense
                                           else n_dense == loop[2] == 0)
            if not ok:
                raise AssertionError(
                    f"update_batch sub_batch={width} on {name}: route="
                    f"{info.route} equal={equal} launches {n_seg}/{n_dense} "
                    f"against the loop's {loop[1]}/{loop[2]}, {n_disc} "
                    "disconnected")
            out[f"engine update_batch sub_batch={width}, {name}"] = n_seg
            out[f"engine update_batch sub_batch={width} dense kernels, "
                f"{name}"] = n_dense
            if profile:
                t_wall, n_launch, busy = traced(
                    lambda: eng.update_batch(items))
                log(f"      traced: wall={t_wall} s  CUDA kernel launches="
                    f"{n_launch}  device busy={busy} s "
                    f"({100 * busy / t_wall} %)")
    return out


def dense_counted(fn):
    """``(fn(), dense kernels launched)``: the launches of the three
    kernels of ``csrc/dense_sweep.cu`` that ``fn`` made, counted on the
    host (``dense_sweep.kernel_launches``)."""
    from repro_torch.kernels.dense_sweep import kernel_launches

    before = sum(kernel_launches().values())
    out = fn()
    return out, sum(kernel_launches().values()) - before


# the tile widths phase 6 runs each tier at (width 1 is the loop route,
# which runs what the loop of detect() does)
TILE_WIDTHS = {"standard": (1, 8, 32), "max-quality": (8, 32),
               "fast": (8, 32)}


def launches_ok(alg, route, got, loop, scan) -> bool:
    """A batch's (segment-reduce, dense-kernel) launches against the loop
    of ``detect()``'s: the same on the loop route; on the tile route fewer
    segment reduces, and fewer dense launches for the Louvain tiers on
    the dense scan (LPA, and every tier on the sortscan, launch none
    either way)."""
    if route == "loop":
        return got == loop
    dense_ok = (got[1] == loop[1] == 0 if alg == "fast" or scan == "sort"
                else got[1] < loop[1])
    return got[0] < loop[0] and dense_ok


def tile_widths(fams, loops, profile) -> dict:
    """Phase 6's tiles: each family's batch of 32 through an engine at
    each tier's :data:`TILE_WIDTHS` (the width-1 engine takes the loop
    route, the others the tile), each graph equal to its ``detect()`` on
    the card bit for bit.  Width 1 launches the segment reduce and the
    dense kernels as often as the loop of ``detect()``; the tiles fewer
    (:func:`launches_ok`), and max-quality leaves nothing disconnected.
    Prints each batch's wall, graphs/s, launches and sweeps, and under
    ``--profile`` one traced batch's device busy share; then holds, at
    ``b`` 8 and 32 on the family's states, the dense kernels to their
    batched plain versions (a dense-scan family) or the sortscan's
    half-sweep on the union to each graph's alone (a sortscan family).
    Returns the launches by path."""
    import torch

    from repro_torch.service import BatchedLouvainEngine

    out = {}
    for name, bucket, graphs, tiers in fams:
        n = len(graphs)
        scan = BatchedLouvainEngine().scan_for(bucket)
        for alg, widths in tiers.items():
            dets, wall_loop, n_loop, n_dense_loop = loops[name, alg]
            log(f"  tiles {alg}, {name}: the loop of detect()={wall_loop} s"
                f" ({n / wall_loop} graphs/s)  segreduce launches={n_loop}"
                f"  dense kernel launches={n_dense_loop}")
            for width in widths:
                eng = BatchedLouvainEngine(sub_batch=width,
                                           algorithms=(alg,))
                t0 = time.perf_counter()
                eng.warm(bucket)
                torch.cuda.synchronize()
                t_warm = time.perf_counter() - t0
                (res, n_dense), wall, n_seg, peak = timed_path(
                    lambda: dense_counted(
                        lambda: eng.detect_batch(graphs, algorithm=alg)))
                info = eng.last_detect_info
                equal = all(same_as_detect(r, d) for r, d in zip(res, dets))
                sweeps = sum(r.sweeps for r in res)
                n_disc = sum(r.n_disconnected for r in res)
                log(f"    {alg} sub_batch={width} ({info.route}, "
                    f"{-(-n // width)} tiles, fill={info.fill}): equal to "
                    f"detect() (labels, counts, stats, Q bits)={equal}  "
                    f"batch wall={wall} s ({n / wall} graphs/s)  "
                    f"loop/batch={wall_loop / wall}  segreduce launches a "
                    f"batch={n_seg} (loop {n_loop})  dense kernel launches "
                    f"a batch={n_dense} (loop {n_dense_loop})  sweeps or "
                    f"rounds (summed over graphs)={sweeps}  disconnected="
                    f"{n_disc}  warm={t_warm} s  peak device memory="
                    f"{peak:.3f} GiB")
                route = "loop" if width == 1 else "tile"
                ok = info.route == route and launches_ok(
                    alg, route, (n_seg, n_dense), (n_loop, n_dense_loop),
                    scan)
                if alg == "max-quality":
                    ok &= n_disc == 0
                if not equal or not ok:
                    raise AssertionError(
                        f"{alg} tiles of {width} on {name}: equal={equal} "
                        f"route={info.route} launches {n_seg}/{n_dense} "
                        f"against the loop's {n_loop}/{n_dense_loop}, "
                        f"{n_disc} disconnected")
                out[f"engine {alg} sub_batch={width}, {name}"] = n_seg
                out[f"engine {alg} sub_batch={width} dense kernels, "
                    f"{name}"] = n_dense
                if profile:
                    t_wall, n_launch, busy = traced_batch(eng, graphs, alg)
                    log(f"      traced: wall={t_wall} s  CUDA kernel "
                        f"launches={n_launch}  device busy={busy} s "
                        f"({100 * busy / t_wall} %)")
        for width in TILE_WIDTHS["standard"][1:]:
            if scan == "dense":
                log(f"    dense kernels at b={width} on this family's "
                    f"states: {tile_kernel_checks(graphs[:width], seed=width)}"
                    f" checks equal")
            else:
                log(f"    sortscan half-sweep on a union of b={width} on "
                    f"this family's states: "
                    f"{sortscan_tile_checks(graphs[:width], seed=width)} "
                    f"checks equal to each graph's alone")
    return out


def sortscan_tile_checks(graphs, seed) -> int:
    """The sortscan's half-sweep on the union of ``graphs`` (``b =
    len(graphs)``, B.1 at the union's shapes) on a seeded state
    (``tests/_torch_tile_cases.py``), a sweep's and a refinement's, with
    and without targets and anchoring: each graph's ``C_new``, Sigma,
    ``move`` and ``want`` bit for bit against its half-sweep alone on the
    card.  Returns the number of checks; raises on a miss."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_tile_cases import tile_state

    from repro_torch.core.local_move import _half_sweep

    checks, misses = 0, []
    for refine in (False, True):
        lone, union, u = tile_state(graphs, seed=seed, refine=refine)
        nv = u.nv
        for target, anchored in ((True, True), (False, True),
                                 (False, False)):
            got = _half_sweep(*union[:8], union[8] if target else None,
                              anchored, gain=False, graphs=u.b)
            ok = True
            for g, a in enumerate(lone):
                sl = slice(g * nv, (g + 1) * nv)
                alone = _half_sweep(*a[:8], a[8] if target else None,
                                    anchored, gain=False)
                ok &= bits_equal(got[0][sl] - g * nv, alone[0]) and all(
                    bits_equal(got[i][sl], alone[i]) for i in (1, 2, 4))
            checks += 1
            if not ok:
                misses.append(f"refine={refine} target={target} "
                              f"anchored={anchored}")
    if misses:
        raise AssertionError(f"the sortscan half-sweep on a union of "
                             f"{len(graphs)} differs from the lone one: "
                             + "; ".join(misses))
    return checks


def tile_kernel_checks(graphs, seed) -> int:
    """The dense kernels with a graph axis (``b = len(graphs)``, one
    launch each for the tile) on a seeded state of ``graphs``
    (``tests/_torch_tile_cases.py``), a sweep's and a refinement's (cross-
    community weights zeroed, singletons): every output of the half-sweep
    (with and without targets and anchoring) and the modularity bit for bit
    against the batched plain versions on the card, and each graph's
    slice against the ``b = 1`` launch on that graph alone.  Returns the
    number of checks; raises on a miss."""
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_tile_cases import tile_state

    from repro_torch.core.local_move import (_half_sweep_dense,
                                             _half_sweep_dense_plain,
                                             realized_modularity_tile)
    from repro_torch.kernels.dense_sweep import dense_modularity_cuda

    checks, misses = 0, []
    cases = [(refine, target, anchored) for refine in (False, True)
             for target, anchored in ((True, True), (False, True),
                                      (False, False))]
    for refine, target, anchored in cases:
        lone, union, u = tile_state(graphs, seed=seed, refine=refine)
        b, nv = u.b, u.nv
        src, dst, w, C, K, Sigma, two_m, movable, tok = union
        eptr = torch.tensor(u.edge_offsets, dtype=torch.int32,
                            device="cuda")
        kw = dict(target_ok=tok if target else None, anchored=anchored)
        got = _half_sweep_dense(src, dst, w, C, K, Sigma, two_m, movable,
                                graphs=b, **kw)
        plain = _half_sweep_dense_plain(src, dst, w, C, K, Sigma, two_m,
                                        movable, graphs=b, **kw)
        ok = all(bits_equal(x, y) for i, (x, y) in enumerate(zip(got, plain))
                 if i != 3)          # gain: torch.sum, its tree by device
        q = dense_modularity_cuda(src, dst, w, got[0], got[1], two_m,
                                  edge_counts=u.counts, edge_ptr=eptr)
        ok_q = bits_equal(q, realized_modularity_tile(
            src, dst, w, got[0], got[1], two_m, u.counts))
        for g, a in enumerate(lone):
            sl = slice(g * nv, (g + 1) * nv)
            alone = _half_sweep_dense(*a[:8], target_ok=a[8] if target
                                      else None, anchored=anchored)
            ok &= bits_equal(got[0][sl] - g * nv, alone[0]) and all(
                bits_equal(got[i][sl], alone[i]) for i in (1, 2, 4))
            ok_q &= bits_equal(q[g], dense_modularity_cuda(
                a[0], a[1], a[2], alone[0], alone[1], a[6]))
        checks += 1
        if not (ok and ok_q):
            misses.append(f"refine={refine} target={target} anchored="
                          f"{anchored} (sweep {ok}, Q {ok_q})")
    if misses:
        raise AssertionError(f"dense kernels at b={b} differ from their "
                             "batched plain versions: " + "; ".join(misses))
    return checks


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
    info8 = svc8.engine.last_update_info
    gids = svc.store.graph_ids()
    same = (sorted(gids) == sorted(svc8.store.graph_ids())
            and all(same_entry(svc.result(g), svc8.result(g))
                    for g in gids)
            and all(same_entry(a.result(), b.result())
                    for a, b in zip(dets, dets8)))
    log(f"  8.1 the same traffic, update_batch_size=8: {rep8['n_update']} "
        f"updates in {rep8['n_update_batches']} batches, in {t_run8} s "
        f"(with the last sync {wall8} s)  every entry equal to "
        f"update_batch_size=1's={same}  segreduce launches={n8}  last "
        f"update batch: route={getattr(info8, 'route', None)} "
        f"n={getattr(info8, 'n', None)}")
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


# ---------------------------------------------------------------------------
# phase 9: the sharded single-graph path on the card
# ---------------------------------------------------------------------------

def log_ranks(mesh, *, per_pass: bool = False) -> list[int]:
    """Print each rank's numbers over the calls in ``mesh.reports`` (its
    B.1 launches, all-reduce calls and bytes, graph transfer, wall, passes
    and sweeps, host partition and pass seconds) and return the launches
    by rank; raise where a rank launched B.1 no time."""
    calls = list(mesh.reports)
    launches = []
    for r in range(mesh.size):
        mine = [c[r] for c in calls]
        passes = [p for c in mine for p in c["passes"]]
        n = sum(c["segreduce_launches"] for c in mine)
        launches.append(n)
        part = [p["t1"] - p["t0"] for p in passes]
        run = [p["t2"] - p["t1"] for p in passes]
        log(f"    rank {r} ({mine[0]['device']}): segreduce launches={n}  "
            f"all-reduce calls={sum(c['all_reduce_calls'] for c in mine)} "
            f"bytes={sum(c['all_reduce_bytes'] for c in mine)}  transfer s="
            f"{sum(c['transfer_s'] for c in mine)}  rank wall s="
            f"{sum(c['wall_s'] for c in mine)}  calls={len(mine)}  passes="
            f"{len(passes)}  sweeps={sum(p['li'] for p in passes)}  "
            f"partition s={sum(part)}  pass s={sum(run)}")
        if per_pass:
            log(f"      per pass: partition s={part}  pass s={run}  "
                f"live edges={[p['m_total'] for p in passes]}  this rank's="
                f"{[p['m_rank'] for p in passes]}")
    if not calls or min(launches) == 0:
        raise AssertionError(f"a rank launched no segreduce kernel: "
                             f"{launches}")
    return launches


def sharded_run(mesh, fn, *, per_pass=False):
    """``fn()`` once, with the mesh's reports cleared just before (each
    rank sets its counts to 0 at the start of each job): ``(result, wall
    seconds, launches by rank)``."""
    import torch

    mesh.reports.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, log_ranks(mesh, per_pass=per_pass)


def same_louvain(a, b) -> bool:
    """Equal labels and equal single-device stats (the sharded driver's
    own keys aside)."""
    import torch

    (Ca, sa), (Cb, sb) = a, b
    return torch.equal(Ca.cpu(), Cb.cpu()) and all(
        sa[k] == sb[k] for k in sb)


def sharded_full_size(mesh, g, standard, label) -> list[int]:
    """9.1: ``louvain_sharded`` standard at full size: phase 4's labels,
    stats and Q bits, 0 disconnected."""
    from repro_torch.core import LouvainConfig, disconnected_communities
    from repro_torch.core.distributed import louvain_sharded
    from repro_torch.core.modularity import modularity
    from repro_torch.graph.container import strip_padding
    from repro_torch.telemetry.sinks import InMemorySink, Telemetry

    tel = Telemetry()
    mem = tel.register(InMemorySink())
    log(f"  9.1 louvain_sharded standard, {label}")
    (C, st), wall, launches = sharded_run(
        mesh, lambda: louvain_sharded(g, LouvainConfig(), mesh=mesh,
                                      telemetry=tel), per_pass=True)
    live = strip_padding(g.src, g.dst, g.w, g.ghost)
    q = float(modularity(*live, C))
    n_dis = int(disconnected_communities(*live, C, g.n_nodes)[
        "n_disconnected"])
    equal = same_louvain((C, st), (standard.labels, standard.stats))
    ghosts = {dict(lk)["shard"]: v for (n, lk), v in mem.gauges.items()
              if n == "sharded_ghost_vertices"}
    log(f"    wall={wall} s  passes={st['passes']}  sweeps(li_total)="
        f"{st['li_total']}  communities={st['n_communities']}  "
        f"disconnected={n_dis}  Q={q!r}  m_shard={st['m_shard']}  "
        f"labels and stats == phase 4's detect()={equal}  Q bits == phase "
        f"4's={q == standard.modularity}  halo-byte counter="
        f"{mem.counter_total('sharded_halo_bytes')}  ghosts by shard "
        f"(last pass)={ghosts}  ghost_vertices={st['ghost_vertices']}")
    if not equal or q != standard.modularity or n_dis != 0 or \
            st["n_communities"] != standard.n_communities:
        raise AssertionError(f"9.1 ({label}): the sharded run differs from "
                             "phase 4's detect()")
    return launches


# the split policies of the reference's sharded parity test (one of each
# family: none, split in the slot by LP and by pointer jumping, split last,
# refine); every policy runs on CPU ranks in tests/test_torch_sharded.py
SHARDED_SPLITS = ("none", "sp-pj", "sp-lp", "sl-pj", "refine")


def sharded_small(meshes) -> dict:
    """9.2: ``detect()`` with a mesh for standard and max-quality, and
    ``louvain_sharded`` for each of :data:`SHARDED_SPLITS`, on phase 3's
    two graphs with 2 and 4 ranks sharing the card: each equal to the
    card's single-device bits.  Returns the B.1 launches by rank summed
    over the calls, by mesh size."""
    import torch

    from repro_torch.core import (DetectOptions, LouvainConfig, detect,
                                  louvain_impl)
    from repro_torch.core.distributed import louvain_sharded
    from repro_torch.graph import rmat_graph, sbm_graph
    from repro_torch.telemetry.sinks import InMemorySink, Telemetry

    graphs = {
        "rmat_graph(scale=12, edge_factor=8, seed=1)":
            rmat_graph(scale=12, edge_factor=8, seed=1, device="cuda"),
        "sbm_graph(2048, 24, 0.12, 0.002, seed=2)":
            sbm_graph(2048, 24, 0.12, 0.002, seed=2, device="cuda")[0],
    }
    launches = {mesh.size: [0] * mesh.size for mesh in meshes}

    def add(mesh, ns):
        launches[mesh.size] = [a + b for a, b in zip(launches[mesh.size], ns)]

    for name, g in graphs.items():
        single = {a: detect(g, options=DetectOptions(algorithm=a))
                  for a in ("standard", "max-quality")}
        single_split = {s: louvain_impl(g, LouvainConfig(split=s))
                        for s in SHARDED_SPLITS}
        for mesh in meshes:
            log(f"  9.2 {name}, {mesh.size} ranks on {set(mesh.devices)} "
                f"({mesh.backend})")
            for a, want in single.items():
                got, wall, n = sharded_run(mesh, lambda: detect(
                    g, options=DetectOptions(algorithm=a, mesh=mesh)))
                equal = torch.equal(got.labels, want.labels) and all(
                    got.stats[k] == v for k, v in want.stats.items())
                log(f"    detect {a}: wall={wall} s  == single-device "
                    f"(labels, stats)={equal}  Q bits equal="
                    f"{got.modularity == want.modularity}  communities="
                    f"{got.n_communities}  disconnected="
                    f"{got.n_disconnected}")
                if not equal or got.modularity != want.modularity or \
                        got.n_disconnected != want.n_disconnected:
                    raise AssertionError(f"9.2 {name} detect {a}, "
                                         f"{mesh.size} ranks")
                add(mesh, n)
            for split, want in single_split.items():
                tel = Telemetry()
                mem = tel.register(InMemorySink())
                got, wall, n = sharded_run(mesh, lambda: louvain_sharded(
                    g, LouvainConfig(split=split), mesh=mesh, telemetry=tel))
                equal = same_louvain(got, want)
                log(f"    louvain_sharded {split}: wall={wall} s  == "
                    f"single-device (labels, stats)={equal}  communities="
                    f"{got[1]['n_communities']}  halo-byte counter="
                    f"{mem.counter_total('sharded_halo_bytes')}")
                if not equal:
                    raise AssertionError(f"9.2 {name} {split}, "
                                         f"{mesh.size} ranks")
                add(mesh, n)
    return launches


def sharded_engine(mesh) -> list[int]:
    """9.3: the engine's ``detect_sharded`` equal to its ``detect_one`` on
    phase 3's SBM."""
    from repro_torch.core import DetectOptions
    from repro_torch.graph import sbm_graph
    from repro_torch.service.engine import BatchedLouvainEngine
    from repro_torch.telemetry.sinks import InMemorySink, Telemetry

    g = sbm_graph(2048, 24, 0.12, 0.002, seed=2, device="cuda")[0]
    tel = Telemetry()
    mem = tel.register(InMemorySink())
    eng = BatchedLouvainEngine(options=DetectOptions(mesh=mesh),
                               telemetry=tel)
    log("  9.3 BatchedLouvainEngine.detect_sharded, "
        "sbm_graph(2048, 24, 0.12, 0.002, seed=2)")
    got, wall, launches = sharded_run(mesh, lambda: eng.detect_sharded(g))
    want = eng.detect_one(g)
    equal = (got.C == want.C).all() and all(
        getattr(got, k) == getattr(want, k) for k in (
            "n_communities", "n_disconnected", "fraction", "passes", "q",
            "sweeps", "split_moved"))
    log(f"    wall={wall} s  == detect_one={bool(equal)}  communities="
        f"{got.n_communities}  disconnected={got.n_disconnected}  q="
        f"{got.q!r}  halo-byte counter="
        f"{mem.counter_total('sharded_halo_bytes')}")
    if not equal:
        raise AssertionError("9.3: detect_sharded != detect_one")
    return launches


def sharded_phase(g, standard) -> dict:
    """Phase 9: the sharded path on the card (``launch/mesh.py``,
    ``core/distributed.py``), two and four ranks sharing ``cuda:0`` over
    gloo.  Returns the B.1 launches by path, a list by rank."""
    import torch

    from repro_torch.launch import make_host_mesh, make_mesh

    mesh2 = make_mesh(("cuda:0", "cuda:0"))
    mesh4 = make_mesh(("cuda:0",) * 4)
    launches = {}
    try:
        # both meshes' workers start at once
        with ThreadPoolExecutor(2) as pool:
            for f in [pool.submit(m.start) for m in (mesh2, mesh4)]:
                f.result()
        for mesh in (mesh2, mesh4):
            log(f"  mesh {mesh.devices} ({mesh.backend}): workers started in "
                f"{mesh.startup_seconds} s")
        t0 = time.perf_counter()
        launches["louvain_sharded standard, 2 ranks on one card"] = \
            sharded_full_size(mesh2, g, standard, "2 ranks on cuda:0 (gloo)")
        log(f"  step 9.1: {time.perf_counter() - t0} s")
        t0 = time.perf_counter()
        for size, ns in sharded_small((mesh2, mesh4)).items():
            launches[f"phase 3's graphs sharded (detect standard and "
                     f"max-quality, louvain_sharded with five split "
                     f"policies), {size} ranks"] = ns
        log(f"  step 9.2: {time.perf_counter() - t0} s")
        t0 = time.perf_counter()
        launches["detect_sharded, 2 ranks"] = sharded_engine(mesh2)
        log(f"  step 9.3: {time.perf_counter() - t0} s")
    finally:
        mesh2.close()
        mesh4.close()
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        try:
            make_host_mesh(2)
        except ValueError as e:
            log(f"  9.4 make_host_mesh(2) on {n_cards} card raises: {e}")
        else:
            raise AssertionError("9.4: make_host_mesh(2) on one card")
        log("  9.4 nccl: not run (1 card)")
    else:
        nccl = make_host_mesh(2)
        try:
            nccl.start()
            log(f"  9.4 mesh {nccl.devices} ({nccl.backend}): workers "
                f"started in {nccl.startup_seconds} s")
            launches["louvain_sharded standard, nccl"] = sharded_full_size(
                nccl, g, standard, "2 ranks, one a card (nccl)")
        finally:
            nccl.close()
    return launches


# ---------------------------------------------------------------------------
# phase 10: the launch CLI, the examples and the approximate harness, on
# the card
# ---------------------------------------------------------------------------

CLI_MODES = ((), ("--async",), ("--churn",), ("--replay",), ("--stream",),
             ("--sharded",), ("--chaos",), ("--tiers",))
EXAMPLES = ("torch_quickstart", "torch_community_service",
            "torch_dynamic_updates", "torch_telemetry_sinks",
            "torch_community_timeline", "torch_chaos_replay")


def cli_step(failures: list) -> dict:
    """10.1: each of the CLI's eight drivers in process with ``--smoke
    --device cuda``; every smoke assertion must hold.  A driver that fails
    is appended to ``failures`` and the next one runs.  Returns the B.1
    launches by driver (the ``--sharded`` ranks' apart)."""
    import traceback

    from repro_torch.launch import serve_communities as sc

    launches = {}
    for mode in CLI_MODES:
        name = " ".join(mode) or "(default sync pump)"
        try:
            rep, wall, n, peak = timed_path(
                lambda: sc.main([*mode, "--smoke", "--device", "cuda"]))
        except Exception as e:    # noqa: BLE001 (reported, fails phase 10)
            log(f"  10.1 serve_communities {name} --smoke: FAILED: {e!r}")
            log(traceback.format_exc())
            failures.append(f"10.1 {name}: {e!r}")
            continue
        ranks = (f"  ranks' segreduce launches="
                 f"{rep['rank_segreduce_launches']}"
                 if mode == ("--sharded",) else "")
        log(f"  10.1 serve_communities {name} --smoke: wall={wall} s  "
            f"segreduce launches={n}{ranks}  peak device memory="
            f"{peak:.2f} GiB")
        launches[f"serve_communities {name} --smoke"] = n
        if mode == ("--sharded",):
            if min(rep["rank_segreduce_launches"]) == 0:
                raise AssertionError("10.1 --sharded: a rank launched no "
                                     "segreduce kernel")
            launches["serve_communities --sharded --smoke, ranks"] = \
                rep["rank_segreduce_launches"]
    return launches


def examples_step() -> dict:
    """10.2: each ``examples/torch_*.py`` on the card (its own asserts)."""
    import importlib.util

    launches = {}
    for name in EXAMPLES:
        path = ROOT / "examples" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _, wall, n, peak = timed_path(lambda: mod.main(["--device", "cuda"]))
        log(f"  10.2 examples/{name}.py: wall={wall} s  segreduce "
            f"launches={n}  peak device memory={peak:.2f} GiB")
        launches[f"examples/{name}.py"] = n
    return launches


def scatter_sweep_step(g) -> dict:
    """10.3: ``local_move`` from singletons on the full-size graph, fused
    (``seg_impl='auto'``) and unfused (``'scatter'``), in the order auto,
    scatter, scatter, auto: C and Sigma the same bits, ``l_i`` equal; each
    run's wall and launches, and the reference's paired sweep ratio."""
    import torch

    from repro_torch.core import local_move
    from repro_torch.graph.container import strip_padding
    from repro_torch.kernels import ops

    src, dst, w = strip_padding(g.src, g.dst, g.w, g.ghost)
    K = ops.segreduce_sorted(w, src, g.nv, op="sum")
    two_m = g.total_weight_2m()
    ids = torch.arange(g.nv, dtype=torch.int32, device="cuda")
    runs = {"auto": [], "scatter": []}
    out = {}
    for impl in ("auto", "scatter", "scatter", "auto"):
        (C, Sigma, li), wall, n, peak = timed_path(lambda: local_move(
            src, dst, w, ids, K, K, two_m, tau=1e-2, seg_impl=impl))
        runs[impl].append((wall, n))
        log(f"  10.3 local_move seg_impl={impl!r}: wall={wall} s  l_i={li}"
            f"  segreduce launches={n}  peak device memory={peak:.2f} GiB")
        if impl in out:
            continue
        out[impl] = (C, Sigma, li)
    (Ca, Sa, la), (Cs, Ss, ls) = out["auto"], out["scatter"]
    equal = torch.equal(Ca, Cs) and same_bits(Sa, Ss) and la == ls
    ratio = (statistics.median(t for t, _ in runs["scatter"])
             / statistics.median(t for t, _ in runs["auto"]))
    log(f"    scatter == auto (C, Sigma bits, l_i)={equal}  scatter / auto "
        f"wall (median of 2)={ratio}")
    if not equal:
        raise AssertionError("10.3: the scatter sweep differs from the "
                             "fused one")
    return {"local_move seg_impl='auto', full size": runs["auto"][0][1],
            "local_move seg_impl='scatter', full size":
                runs["scatter"][0][1]}


def harness_run(mesh, g):
    """``run_louvain_multidevice`` once on ``mesh`` with the rank reports
    cleared: ``(labels, stats, wall, caller launches, rank launches)``."""
    from repro_torch.core.distributed import run_louvain_multidevice

    mesh.reports.clear()
    (C, st), wall, n, _ = timed_path(
        lambda: run_louvain_multidevice(g, mesh))
    ranks = [sum(c[r]["segreduce_launches"] for c in mesh.reports)
             for r in range(mesh.size)]
    if min(ranks) == 0:
        raise AssertionError(f"a rank launched no segreduce kernel: {ranks}")
    return C, st, wall, n, ranks


def harness_step(g) -> dict:
    """10.4: the approximate harness on 2 ranks sharing ``cuda:0`` (gloo):
    on phase 3's R-MAT its labels and stats equal a 2-rank CPU mesh's;
    then once at full size, its wall, communities, Q and disconnected
    count (not phase 4's: ROADMAP C.4)."""
    import torch

    from repro_torch.core import disconnected_communities
    from repro_torch.core.distributed import run_louvain_multidevice
    from repro_torch.core.modularity import modularity
    from repro_torch.graph import rmat_graph
    from repro_torch.graph.container import strip_padding
    from repro_torch.launch import make_host_mesh, make_mesh

    card = make_mesh(("cuda:0", "cuda:0"))
    cpu = make_host_mesh(2, device="cpu")
    launches = {}
    try:
        small = "rmat_graph(scale=12, edge_factor=8, seed=1)"
        gs = rmat_graph(scale=12, edge_factor=8, seed=1, device="cuda")
        C, st, wall, n, ranks = harness_run(card, gs)
        Cc, stc = run_louvain_multidevice(gs.to("cpu"), cpu)
        equal = torch.equal(C.cpu(), Cc) and st == stc
        log(f"  10.4 run_louvain_multidevice {small}, 2 ranks on cuda:0 "
            f"(gloo): wall={wall} s  communities={st['n_communities']}  "
            f"first pass l_i={st['first_pass_li']} communities="
            f"{st['first_pass_comms']}  == 2 CPU ranks (labels, stats)="
            f"{equal}  caller's segreduce launches={n}  ranks'={ranks}")
        if not equal:
            raise AssertionError("10.4: the card harness differs from CPU "
                                 "ranks")
        launches[f"run_louvain_multidevice {small}, caller"] = n
        launches[f"run_louvain_multidevice {small}, ranks"] = ranks
        C, st, wall, n, ranks = harness_run(card, g)
        live = strip_padding(g.src, g.dst, g.w, g.ghost)
        q = float(modularity(*live, C))
        n_dis = int(disconnected_communities(*live, C, g.n_nodes)[
            "n_disconnected"])
        log(f"  10.4 run_louvain_multidevice full size, 2 ranks on cuda:0: "
            f"wall={wall} s  communities={st['n_communities']}  Q={q!r}  "
            f"disconnected={n_dis}  passes after the first={st['passes']}  "
            f"first pass l_i={st['first_pass_li']} communities="
            f"{st['first_pass_comms']}  caller's segreduce launches={n}  "
            f"ranks'={ranks}")
        launches["run_louvain_multidevice full size, caller"] = n
        launches["run_louvain_multidevice full size, ranks"] = ranks
    finally:
        card.close()
        cpu.close()
    return launches


def launch_phase(g) -> dict:
    """Phase 10: the CLI's drivers, the examples, the scatter sweep and
    the approximate harness on the card.  Every step runs, and the phase
    fails at its end if any of them failed.  Returns the B.1 launches by
    path."""
    import traceback

    launches, failures = {}, []
    for step, fn in (("10.1", lambda: cli_step(failures)),
                     ("10.2", examples_step),
                     ("10.3", lambda: scatter_sweep_step(g)),
                     ("10.4", lambda: harness_step(g))):
        t0 = time.perf_counter()
        try:
            launches.update(fn())
        except Exception as e:    # noqa: BLE001 (reported, fails phase 10)
            log(f"  step {step}: FAILED: {e!r}")
            log(traceback.format_exc())
            failures.append(f"{step}: {e!r}")
        log(f"  step {step}: {time.perf_counter() - t0} s")
    if failures:
        raise AssertionError("phase 10: " + "; ".join(failures))
    return launches


# phase 11: the models on the card
# bf16 logits after 22 layers: two bf16 routes of one float32 function
# differ by up to 0.09 at logits of rms 1.0 (chunks of 512 vs 1,024 alone:
# 0.086), float32 routes by 1e-5; rtol = atol
FLASH_BF16_TOL = 1e-1
DECODE_TOL = 2e-2          # the reference's test_decode_matches_forward (f32)
SMOKE_TOL = 1e-4           # float32 smoke forward, card vs CPU
LM_SMOKES = ("mixtral-8x7b", "mixtral-8x22b", "command-r-35b",
             "smollm-360m", "tinyllama-1.1b")
GNN_ARCHS = ("gcn-cora", "gat-cora", "gatedgcn", "nequip")


def err_over_tol(got, want, tol: float) -> float:
    """The largest ``|got - want| / (tol + tol * |want|)``: at most 1 where
    every element lies within ``rtol = atol = tol`` (inf on a NaN)."""
    import torch

    got, want = got.double(), want.double()
    r = (got - want).abs() / (tol + tol * want.abs())
    return float(torch.where(torch.isnan(r), float("inf"), r).max())


def model_run(fn):
    """``fn()`` once on the card with B.5's launch counts set to 0 just
    before: ``(result, wall s, flash launches, tensor-core launches, peak
    device GiB)``."""
    import torch

    from repro_torch.kernels.flash_attn import flash_attention_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    flash_attention_cuda.tensor_core_launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, wall, flash_attention_cuda.launches,
            flash_attention_cuda.tensor_core_launches,
            torch.cuda.max_memory_allocated() / 2**30)


def free_card():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def rms(x) -> float:
    return float(x.double().pow(2).mean().sqrt())


def tinyllama_step(card: str) -> dict:
    """11a: TinyLlama-1.1B at its published config in bf16: a flash
    prefill at 4 x 2048 (B.5 launched, through the tensor cores), its last
    logits against the chunked route's within ``FLASH_BF16_TOL`` and, both
    against the float32 forward, flash no further from it than 1.25x the
    chunked route; then decode against the forward at the same position
    (float32 at the reference test's ``DECODE_TOL``, bf16 at
    ``FLASH_BF16_TOL``) and ``generate`` (16-token prompt, 32 greedy
    tokens) in bf16, whose first token is the argmax of those logits."""
    import dataclasses

    import torch

    from repro_torch.configs import get_spec
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T

    base = get_spec("tinyllama-1.1b").config
    flash = dataclasses.replace(base, attn_impl="flash")
    f32 = dataclasses.replace(base, compute_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = T.init_params(gen, base, device="cuda")
    toks = torch.randint(0, base.vocab, (4, 2048), generator=gen,
                         device="cuda", dtype=torch.int32)
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        lf, wall, n, n_tc, peak = model_run(
            lambda: T.forward(params, toks, flash)[:, -1])
        lc, wall_c, n_c, _, peak_c = model_run(
            lambda: T.forward(params, toks, base)[:, -1])
        lt = T.forward(params, toks, f32)[:, -1]
    r = err_over_tol(lf, lc, FLASH_BF16_TOL)
    dev_f, dev_c = rms(lf - lt), rms(lc - lt)
    log(f"  11a TinyLlama-1.1B ({base.n_layers}L d{base.d_model} "
        f"{base.n_heads}H kv{base.n_kv_heads} vocab {base.vocab}, bf16) "
        f"prefill 4 x 2048, flash: wall={wall} s  tokens/s={4 * 2048 / wall}"
        f"  B.5 launches={n} (tensor cores {n_tc})  peak device memory="
        f"{peak:.3f} GiB  [{card}]")
    log(f"    chunked route: wall={wall_c} s  peak={peak_c:.3f} GiB  B.5 "
        f"launches={n_c}; last-position logits flash vs chunked: max "
        f"err/tol={r} (rtol = atol = {FLASH_BF16_TOL}), max abs diff="
        f"{float((lf - lc).abs().max())}; vs the float32 forward (logits "
        f"rms {rms(lt)}): rms deviation flash={dev_f} chunked={dev_c}, max "
        f"flash={float((lf - lt).abs().max())} chunked="
        f"{float((lc - lt).abs().max())}  [{card}]")
    if n == 0 or n_tc != n or n_c != 0:
        raise AssertionError(f"11a: flash launches {n} (tensor cores "
                             f"{n_tc}), chunked {n_c}")
    if not (torch.isfinite(lf).all() and r <= 1.0 and dev_f <= 1.25 * dev_c):
        raise AssertionError(f"11a: flash prefill logits off: err/tol {r}, "
                             f"deviation {dev_f} vs {dev_c}")
    del lf, lc, lt
    prompt = toks[:, :16]
    decoded = {}
    with torch.no_grad():
        for cfg, tol in ((f32, DECODE_TOL), (flash, FLASH_BF16_TOL)):
            want = T.forward(params, prompt, cfg)[:, -1]
            cache = T.init_cache(cfg, 4, 48, device="cuda")
            cache["t"].fill_(0)
            for i in range(16):
                got, cache = T.decode_step(params, cache, prompt[:, i], cfg)
            name = str(cfg.compute_dtype).split(".")[-1]
            decoded[name] = (got, err_over_tol(got, want, tol), tol,
                             float((got - want).abs().max()))
    out, wall_g, n_g, _, peak_g = model_run(
        lambda: generate(flash, params, prompt, 32, device="cuda"))
    got = decoded["bfloat16"][0]
    same_first = torch.equal(out[:, 16], got.argmax(-1).to(torch.int32))
    log(f"  11a generate bf16 4 x (16 prompt + 32 greedy): wall={wall_g} s  "
        f"tokens/s={4 * 48 / wall_g}  peak device memory={peak_g:.3f} GiB  "
        f"B.5 launches={n_g}; first token = argmax of the bf16 decode "
        f"logits: {same_first}  [{card}]")
    for name, (_, rd, tol, diff) in decoded.items():
        log(f"    decode after the 16-token prompt vs forward at position "
            f"15, {name}: max err/tol={rd} (rtol = atol = {tol}), max abs "
            f"diff={diff}  [{card}]")
    if not (same_first and out.shape == (4, 48)
            and all(v[1] <= 1.0 for v in decoded.values())):
        raise AssertionError(f"11a: decode differs from forward: "
                             f"{ {k: v[1] for k, v in decoded.items()} }")
    del params, out, decoded
    free_card()
    return {"TinyLlama-1.1B prefill 4x2048 flash (phase 11a)": n,
            "TinyLlama-1.1B generate (decode path, phase 11a)": n_g}


def mixtral_step(card: str) -> dict:
    """11b: Mixtral-8x7B at full width, 2 of its 32 layers: a flash
    prefill of 8,192 tokens over its 4,096-token window with
    ``moe_dropless``, checked against the chunked route, then 8 greedy
    decode tokens from the prefilled rolling cache."""
    import dataclasses

    import torch

    from repro_torch.configs import get_spec
    from repro_torch.models import transformer as T

    full = get_spec("mixtral-8x7b").config
    cfg = dataclasses.replace(full, n_layers=2, moe_dropless=True,
                              attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(12)
    params = T.init_params(gen, cfg, device="cuda")
    toks = torch.randint(0, cfg.vocab, (1, 8192), generator=gen,
                         device="cuda", dtype=torch.int32)

    def serve():
        logits, cache = T.prefill(params, toks, cfg, 8192 + 8)
        tok, out = logits[:, -1].argmax(-1), []
        with torch.no_grad():
            for _ in range(8):
                out.append(tok)
                lg, cache = T.decode_step(params, cache, tok, cfg)
                tok = lg.argmax(-1)
        return logits[:, -1], torch.stack(out, 1), lg

    (last, new, lg), wall, n, n_tc, peak = model_run(serve)
    with torch.no_grad():
        lc = T.forward(params, toks, dataclasses.replace(
            cfg, attn_impl="chunked"))[:, -1]
    r = err_over_tol(last, lc, FLASH_BF16_TOL)
    log(f"  11b Mixtral-8x7B at full width, depth cut to {cfg.n_layers} of "
        f"{full.n_layers} layers (the whole model does not fit one card), "
        f"bf16, window {cfg.sliding_window}, dropless: prefill 1 x 8192 + 8 "
        f"decode tokens: wall={wall} s  tokens/s={8200 / wall}  B.5 "
        f"launches={n} (tensor cores {n_tc})  peak device memory="
        f"{peak:.3f} GiB; last logits flash vs chunked: max err/tol={r} "
        f"(rtol = atol = {FLASH_BF16_TOL})  [{card}]")
    if n == 0 or n_tc != n or r > 1.0 or not torch.isfinite(lg).all() \
            or new.shape != (1, 8):
        raise AssertionError(f"11b: launches {n}/{n_tc}, err/tol {r}")
    del params, last, lc, lg
    free_card()
    return {"Mixtral-8x7B 2-layer prefill 8192 flash (phase 11b)": n}


def training_step(card: str) -> None:
    """11c: training at full width: smollm-360m (5 steps, 4 x 1024, remat),
    BST (5 steps at batch 65,536, 4M items) and the four GNNs at Cora's
    shape (5 steps each); every loss and gradient norm finite."""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.launch.train import train_gnn, train_lm, train_recsys

    runs = [
        ("smollm-360m train_lm 5 steps, batch 4 x 1024, remat",
         lambda on: train_lm(get_spec("smollm-360m").config, 5, 4, 1024,
                             None, False, log_every=1000, device="cuda",
                             on_step=on)),
        ("bst train_recsys 5 steps, batch 65536",
         lambda on: train_recsys(get_spec("bst").config, 5, 65536, None,
                                 False, log_every=1000, device="cuda",
                                 on_step=on)),
    ] + [(f"{a} train_gnn 5 steps, full config on Cora's shape",
          lambda on, a=a: train_gnn(get_spec(a), 5, None, False,
                                    log_every=1000, full=True,
                                    device="cuda", on_step=on))
         for a in GNN_ARCHS]
    bad = []
    for name, run in runs:
        seen, stamps = [], [time.perf_counter()]

        def on(i, m):       # each step ends in a host read of its loss
            stamps.append(time.perf_counter())
            seen.append(m)

        _, wall, _, _, peak = model_run(lambda: run(on))
        losses = [m["loss"] for m in seen]
        norms = [m["grad_norm"] for m in seen]
        ok = len(seen) == 5 and all(
            torch.isfinite(torch.tensor(losses + norms)))
        log(f"  11c {name}: wall={wall} s (set-up and step 1: "
            f"{stamps[1] - stamps[0]} s, steps 2-5: "
            f"{(stamps[-1] - stamps[1]) / 4} s a step)  peak device memory="
            f"{peak:.3f} GiB  losses={losses}  grad norms={norms}  "
            f"finite={ok}  [{card}]")
        if not ok:
            bad.append(name)
        free_card()
    if bad:
        raise AssertionError(f"11c: non-finite training: {bad}")


def smoke_vs_cpu_step(card: str) -> dict:
    """11d: each LM smoke config's forward (float32) on the card with
    flash against the CPU's plain route, within ``SMOKE_TOL``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_spec
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}
    for arch in LM_SMOKES:
        cfg = dataclasses.replace(get_spec(arch).smoke, attn_impl="flash")
        gen = torch.Generator().manual_seed(13)
        params = T.init_params(gen, cfg, device="cpu")
        toks = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                             dtype=torch.int32)
        card_params = tree_map(lambda x: x.cuda(), params)
        with torch.no_grad():
            got, wall, n, _, _ = model_run(
                lambda: T.forward(card_params, toks.cuda(), cfg))
            want = T.forward(params, toks, cfg)
        r = err_over_tol(got.cpu(), want, SMOKE_TOL)
        log(f"  11d {arch} smoke forward (2 x 64, f32): card flash vs CPU "
            f"plain: max err/tol={r} (rtol = atol = {SMOKE_TOL})  B.5 "
            f"launches={n}  wall={wall} s  [{card}]")
        if n == 0 or r > 1.0:
            raise AssertionError(f"11d {arch}: launches {n}, err/tol {r}")
        launches[f"{arch} smoke forward flash (phase 11d)"] = n
    return launches


def models_phase(card: str) -> dict:
    """Phase 11: the models, the optimiser and the trainers on the card.
    Every step runs, and the phase fails at its end if any failed.
    Returns B.5's launches by path."""
    import traceback

    launches, failures = {}, []
    for step, fn in (("11a", tinyllama_step), ("11b", mixtral_step),
                     ("11c", training_step), ("11d", smoke_vs_cpu_step)):
        t0 = time.perf_counter()
        try:
            launches.update(fn(card) or {})
        except Exception as e:    # noqa: BLE001 (reported, fails phase 11)
            log(f"  step {step}: FAILED: {e!r}")
            log(traceback.format_exc())
            failures.append(f"{step}: {e!r}")
        free_card()
        log(f"  step {step}: {time.perf_counter() - t0} s")
    if failures:
        raise AssertionError("phase 11: " + "; ".join(failures))
    return launches

# ---------------------------------------------------------------------------
# phase 12: the sharding rules, the step builder, the dry run and the
# roofline
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k"),
                ("tinyllama-1.1b", "prefill_32k"),
                ("tinyllama-1.1b", "decode_32k"),
                ("mixtral-8x7b", "train_4k"),
                ("gcn-cora", "full_graph_sm"),
                ("gat-cora", "minibatch_lg"),
                ("bst", "train_batch"))
DRYRUN_LM_LAYERS = 2
SMOLLM_BATCH = 2            # train_4k's 256 x 4096 cut to fit one card
BOUND_SLACK = 1.05          # a step may beat its bound by this much
WARMUP_STEPS, TIMED_STEPS = 2, 5
# a step slower: 1 warm-up, 1 timed (smollm's steps take 11–16 s, and
# the whole script must end well inside its 1,200 s)
SLOW_STEP_S, SLOW_TIMED_STEPS = 2.0, 1


def dryrun_step(card: str) -> list:
    """12a: the dry run's cells on both production meshes over fake ranks
    (LM depth cut to ``DRYRUN_LM_LAYERS``); records under
    ``experiments/dryrun_torch``.  Returns the records."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.roofline.hw import HW

    log(f"  12a H100 table (repro_torch.roofline.hw): {HW.name} at "
        f"{HW.power_limit_w} W: peak bf16 {HW.peak_flops_bf16:.4g} FLOP/s, "
        f"HBM {HW.hbm_bw:.4g} B/s ({HW.hbm_bytes / 1e9:.0f} GB), collective "
        f"{HW.coll_bw:.4g} B/s (NDR port; NVLink {HW.nvlink_bw:.4g} B/s in "
        f"a node)  [measured card: {card}]")
    recs = []
    for arch, shape in DRYRUN_CELLS:
        spec = get_spec(arch)
        if spec.family == "lm":
            spec = dataclasses.replace(spec, config=dataclasses.replace(
                spec.config, n_layers=DRYRUN_LM_LAYERS))
        for multi_pod in (False, True):
            t0 = time.perf_counter()
            rec = run_cell(arch, shape, multi_pod, spec=spec)
            if rec["status"] != "ok":
                raise AssertionError(f"12a {arch} x {shape}: {rec}")
            log(f"    {arch} x {shape} x {rec['mesh']}"
                f"{' (' + str(DRYRUN_LM_LAYERS) + ' layers)' if spec.family == 'lm' else ''}"
                f": flops/dev={rec['hlo_flops']:.4g} bytes/dev="
                f"{rec['hlo_bytes']:.4g} coll/dev={rec['collective_bytes']:.4g}"
                f" {rec['collective_ops']} peak/dev="
                f"{rec['bytes_per_device']['peak'] / 1e9:.3f} GB bound="
                f"{rec['step_time_bound']:.4g} s ({rec['bottleneck']}) "
                f"gathered ops={sorted(rec.get('gathered_ops', {}))} "
                f"wall={time.perf_counter() - t0:.2f} s")
            recs.append(rec)
    return recs


def roofline_cells():
    """12b's cells: ``(label, spec, shape)`` cut to one card."""
    import dataclasses

    from repro_torch.configs import get_spec

    def cut(arch, shape, config=None, **shape_kw):
        spec = get_spec(arch)
        shapes = dict(spec.shapes)
        shapes[shape] = dict(shapes[shape], **shape_kw)
        return dataclasses.replace(spec, shapes=shapes,
                                   config=config or spec.config)

    tl = get_spec("tinyllama-1.1b").config
    return [
        ("TinyLlama-1.1B prefill_32k flash, batch 1 (of 32)",
         cut("tinyllama-1.1b", "prefill_32k",
             dataclasses.replace(tl, attn_impl="flash"), global_batch=1),
         "prefill_32k"),
        (f"smollm-360m train_4k, batch {SMOLLM_BATCH} (of 256)",
         cut("smollm-360m", "train_4k", global_batch=SMOLLM_BATCH),
         "train_4k"),
        ("gcn-cora full_graph_sm", cut("gcn-cora", "full_graph_sm"),
         "full_graph_sm"),
        ("bst serve_p99 (batch 512)", cut("bst", "serve_p99"), "serve_p99"),
    ]


def prefill_against_plain(spec, shape, mesh, dargs, got, card) -> list:
    """12b's flash prefill held to its plain routes on the card, phase
    11a's checks at 1 x 32,768: the same plan with ``attn_impl='chunked'``
    on the same inputs (the shards of ``dargs`` as plain tensors) gives
    last logits within ``FLASH_BF16_TOL`` of flash's, and against that plan in float32 flash's rms deviation is at
    most 1.25x the chunked route's.  Then B.5 alone at one layer's shape
    (random bfloat16 ``[1, S, Hq, Dh]`` q and ``[1, S, Hkv, Dh]`` k, v)
    against its plain version at phase 5's tolerance
    (:func:`check_case`).  Returns the failures."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.flash_attn import flash_attention_cuda
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import tree_map

    # the same tensors as plain ones (a (1, 1) mesh's shards are whole):
    # the plain routes need no DTensor dispatch, some 10 ops a block
    local = tree_map(lambda x: x.to_local() if isinstance(x, DTensor)
                     else x, dargs)

    def last_logits(**cfg_kw):
        cfg = dataclasses.replace(spec.config, **cfg_kw)
        plan = build_cell(dataclasses.replace(spec, config=cfg), shape, mesh)
        return plan.step_fn(*local)

    bad = []
    lf = got.full_tensor()
    t0 = time.perf_counter()
    lc = last_logits(attn_impl="chunked")
    wall_c = time.perf_counter() - t0
    lt = last_logits(attn_impl="chunked", compute_dtype=torch.float32)
    r = err_over_tol(lf, lc, FLASH_BF16_TOL)
    dev_f, dev_c = rms(lf - lt), rms(lc - lt)
    log(f"    prefill last logits flash vs chunked (same plan, same inputs; "
        f"chunked step {wall_c} s): max err/tol={r} (rtol = atol = "
        f"{FLASH_BF16_TOL}), max abs diff={float((lf - lc).abs().max())}; "
        f"vs float32 chunked (logits rms {rms(lt)}): rms deviation flash="
        f"{dev_f} chunked={dev_c}  [{card}]")
    if not (torch.isfinite(lf).all() and r <= 1.0 and dev_f <= 1.25 * dev_c):
        bad.append(f"prefill logits off: err/tol {r}, deviation {dev_f} "
                   f"vs {dev_c}")
    del lf, lc, lt, local
    free_card()
    cfg = spec.config
    S = spec.shapes[shape]["seq_len"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn((1, S, h, cfg.d_head), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    kw = dict(causal=True, window=cfg.sliding_window)
    out = flash_attention_cuda(q, k, v, **kw)
    name = (f"B.5 at one layer's shape q [1, {S}, {cfg.n_heads}, "
            f"{cfg.d_head}], k, v [1, {S}, {cfg.n_kv_heads}, {cfg.d_head}]")
    try:
        err, stated, _ = check_case("flash_attention", name,
                                    flash_attention_cuda, (q, k, v), kw, out)
        log(f"    {name}: max_abs_err={err} ({stated})  [{card}]")
    except AssertionError as e:
        bad.append(str(e))
    del q, k, v, out
    free_card()
    return bad


def roofline_step(card: str) -> dict:
    """12b: each cell traced on a ``(1, 1)`` mesh on ``cuda:0``, then run
    on that mesh: measured s a step against the traced bound.  Returns
    B.5's launches by path."""
    import math

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels.flash_attn import flash_attention_cuda
    from repro_torch.launch.dryrun import trace_plan
    from repro_torch.launch.steps import (
        build_cell, concrete_args, distribute_args,
    )
    from repro_torch.roofline.hw import HW
    from repro_torch.tree import tree_leaves

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    launches, bad = {}, []
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        for label, spec, shape in roofline_cells():
            plan = build_cell(spec, shape, mesh)
            t0 = time.perf_counter()
            rec = trace_plan(plan, mesh, 1)
            t_trace = time.perf_counter() - t0
            gen = torch.Generator(device="cuda").manual_seed(12)
            args = concrete_args(plan, gen, "cuda")
            real_bytes = sum(x.numel() * x.element_size()
                             for x in tree_leaves(args))
            dargs = distribute_args(args, plan.in_shardings, mesh)
            del args
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

            def step():
                with implicit_replication():
                    return plan.step_fn(*dargs)

            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            slow = time.perf_counter() - t0 > SLOW_STEP_S
            for _ in range(WARMUP_STEPS - 1 if not slow else 0):
                step()
            n_timed = SLOW_TIMED_STEPS if slow else TIMED_STEPS
            times, n_flash = [], []
            for _ in range(n_timed):
                out = None     # the last step's output is not live now
                flash_attention_cuda.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                n_flash.append(flash_attention_cuda.launches)
            s = statistics.median(times)
            peak_real = torch.cuda.max_memory_allocated()
            finite = all(bool(torch.isfinite(x.full_tensor()
                                             if hasattr(x, "full_tensor")
                                             else x).all())
                         for x in tree_leaves(out)
                         if x.is_floating_point())
            frac = (plan.model_flops / HW.peak_flops_bf16) / s
            bound = rec["step_time_bound"]
            bpd = rec["bytes_per_device"]
            log(f"  12b {label}: measured {s} s a step (median of "
                f"{n_timed}: {times}); traced bound {bound} s "
                f"({rec['bottleneck']}: compute {rec['t_compute']} s, "
                f"memory {rec['t_memory']} s, collective "
                f"{rec['t_collective']} s); bound/measured={bound / s}; "
                f"roofline fraction (model_flops {plan.model_flops:.6g} / "
                f"peak) / s = {frac}; traced peak "
                f"{bpd['peak'] / 2**30:.3f} GiB vs max_memory_allocated "
                f"{peak_real / 2**30:.3f} GiB; traced argument bytes "
                f"{bpd['argument']} vs real {real_bytes}; B.5 launches a "
                f"step {n_flash}; finite outputs {finite}; trace "
                f"{t_trace:.2f} s  [{card}]")
            if bpd["argument"] != real_bytes:
                bad.append(f"{label}: argument bytes {bpd['argument']} != "
                           f"{real_bytes}")
            if s * BOUND_SLACK < bound or frac > BOUND_SLACK:
                bad.append(f"{label}: {s} s beats its bound {bound} s "
                           f"(fraction {frac})")
            if not finite:
                bad.append(f"{label}: non-finite outputs")
            if "prefill" in shape:
                n_layers = spec.config.n_layers
                if any(n != n_layers for n in n_flash):
                    bad.append(f"{label}: B.5 launches {n_flash}, want "
                               f"{n_layers} a step")
                bad.extend(f"{label}: {b}" for b in prefill_against_plain(
                    spec, shape, mesh, dargs, out, card))
                launches[f"TinyLlama-1.1B prefill 1x32768 flash, "
                         f"step builder on a (1, 1) mesh (phase 12b)"] = \
                    n_flash[0]
            del dargs, out
            free_card()
            if math.isnan(s):
                bad.append(f"{label}: no time")
    finally:
        dist.destroy_process_group()
    if bad:
        raise AssertionError("12b: " + "; ".join(bad))
    return launches


def launch_layer_phase(card: str) -> dict:
    """Phase 12: 12a then 12b; each runs, and the phase fails at its end
    if either failed.  Returns B.5's launches by path."""
    import traceback

    launches, failures = {}, []
    for step, fn in (("12a", dryrun_step), ("12b", roofline_step)):
        t0 = time.perf_counter()
        try:
            got = fn(card)
            if isinstance(got, dict):
                launches.update(got)
        except Exception as e:    # noqa: BLE001 (reported, fails phase 12)
            log(f"  step {step}: FAILED: {e!r}")
            log(traceback.format_exc())
            failures.append(f"{step}: {e!r}")
        free_card()
        log(f"  step {step}: {time.perf_counter() - t0} s")
    if failures:
        raise AssertionError("phase 12: " + "; ".join(failures))
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
    ap.add_argument("--dense", action="store_true",
                    help="run phase 1 and phase 3's dense scan only (its "
                    "detect() runs, its kernels against their plain "
                    "versions and their times), and print no result")
    ap.add_argument("--phase12", action="store_true",
                    help="run phase 1 and phase 12 only, and print no "
                    "result (a quick check of the launch layer)")
    ap.add_argument("--engine", action="store_true",
                    help="run phase 1, phase 3's dense scan and phase 6 "
                    "only (the engine's tiles), and print no result")
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

    if args.dense:
        log("phase 3: the dense scan, on the card")
        t0 = time.perf_counter()
        dense_sweep_phase(dense_phase()[1])
        log(f"  phase 3 (dense): {time.perf_counter() - t0} s")
        log(f"chip_smoke --dense total: {time.perf_counter() - t_start} s")
        return 0

    if args.engine:
        log("phase 3: the dense scan, on the card")
        dense_sweep_phase(dense_phase()[1])
        log("phase 6: the batched engine and the store, on the card")
        t0 = time.perf_counter()
        engine_phase(profile=args.profile)
        log(f"  phase 6: {time.perf_counter() - t0} s")
        log(f"chip_smoke --engine total: {time.perf_counter() - t_start} s")
        return 0

    if args.phase12:
        log("phase 12: the step builder, the dry run and the roofline, on "
            "the card")
        t0 = time.perf_counter()
        launch_layer_phase(card)
        log(f"  phase 12: {time.perf_counter() - t0} s")
        log(f"chip_smoke --phase12 total: {time.perf_counter() - t_start} s")
        return 0

    t0 = time.perf_counter()
    g = rmat_graph(scale=args.scale, edge_factor=16, seed=1, device="cuda")
    log(f"  graph rmat_graph(scale={args.scale}, edge_factor=16, seed=1): "
        f"n_cap={g.n_cap} m_cap={g.m_cap}, built on the host in "
        f"{time.perf_counter() - t0:.1f} s")

    log("phase 2: kernel vs plain, on the card")
    entry = kernel_phase(g)

    log("phase 3: end to end, small, card vs CPU")
    small_phase()
    dense_launches, dense_sweep_launches = dense_phase()
    dense_entries = dense_sweep_phase(dense_sweep_launches)
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
    for e in dense_entries:    # all three dense kernels, a batch by width
        e["engine_dense_launches_by_width"] = {
            k: n for k, n in engine_launches.items() if "dense kernels" in k}

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

    log("phase 9: the sharded path, on the card")
    t0 = time.perf_counter()
    by_path.update(sharded_phase(g, res))
    log(f"  phase 9: {time.perf_counter() - t0} s")

    log("phase 10: launch, examples and the harness, on the card")
    t0 = time.perf_counter()
    by_path.update(launch_phase(g))
    log(f"  phase 10: {time.perf_counter() - t0} s")

    log("phase 11: the models, the optimiser and the trainers, on the card")
    del g
    free_card()
    t0 = time.perf_counter()
    flash_paths = models_phase(card)
    log(f"  phase 11: {time.perf_counter() - t0} s")

    log("phase 12: the step builder, the dry run and the roofline, on the "
        "card")
    t0 = time.perf_counter()
    flash_paths.update(launch_layer_phase(card))
    log(f"  phase 12: {time.perf_counter() - t0} s")

    entry["launches"] = launches
    entry["launches_by_path"] = by_path
    for e in api_entries:      # B.5's main path: the TinyLlama prefill
        if e["name"] == "flash_attention":
            flash_paths["kernel API, phase 5"] = e["launches"]
            e["launches"] = flash_paths[
                "TinyLlama-1.1B prefill 4x2048 flash (phase 11a)"]
            e["launches_by_path"] = flash_paths
    log(json.dumps({"kernels": [entry] + api_entries + dense_entries}))
    log(f"chip_smoke total: {time.perf_counter() - t_start} s")
    log(card)
    # the run uses one card, whatever else the machine holds
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
