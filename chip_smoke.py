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
   in-order fold.  Exactness is required bit for bit.  f32 sums are held
   against the plain version run on a CPU copy of the same inputs, because
   on CUDA the plain version's ``index_add_`` is atomic and folds in no
   fixed order; max/min and int32 results are held against the plain
   version on the card.  Prints each case's median time, byte bound, the
   plain version's time and the library call's (``index_add_`` /
   ``scatter_reduce_``), which the port never calls.
3. End to end, small: ``detect()`` on the card and on the CPU give equal
   labels and zero disconnected communities.
4. End to end, full size: ``detect()`` with default options on
   ``rmat_graph(scale=21, edge_factor=16, seed=1)`` (about 2.1M vertices
   and 63.5M directed edges, the scale of com-LiveJournal), with zero
   disconnected communities, a modularity in (0, 1), and the segment-reduce
   kernel launched on the way (its count is reset just before the run).

``--profile`` adds a traced run of phase 4 (device time by kernel, the
device's busy share).  The second-to-last lines are one JSON object for
the kernels (``kernels``) and the card line; the last line is the result
object.
"""
from __future__ import annotations

import argparse
import json
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
    each bracketed by CUDA events."""
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
    return statistics.median(times)


def max_abs_err(got, want) -> float:
    import torch

    """0.0 exactly when ``got`` equals ``want`` element for element."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    same = got == want
    if bool(same.all()):
        return 0.0
    diff = (got.double() - want.double()).abs()
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


def kernel_phase(g) -> dict:
    """Phase 2.  Returns the kernel's JSON entry (launches filled later)."""
    import torch

    from repro_torch.kernels import ops, ref

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
    # (name, values, ids, nseg, op): each (op, dtype, D) the main path runs
    cases = [
        ("sum f32 D=2 (pass A run sums)", f32(2), rid, m, "sum"),
        ("sum f32 D=1 (K by src)", f32(1), src, g.nv, "sum"),
        ("max f32 D=2 (pass B by src)", dq, src, g.nv, "max"),
        ("min i32 D=1 (argmax, split)", cmin, src, g.nv, "min"),
        ("max i32 D=1 (pruning wake-up)", i32(0, 2), src, g.nv, "max"),
        ("sum i32 D=1 (detector pieces)", i32(0, 2), rid, m, "sum"),
        ("sum i32 D=2 (aggregate run fields)", i32(0, g.nv).repeat(1, 2),
         rid, m, "sum"),
    ]
    variants, worst = [], 0.0
    for name, v, ids, nseg, op in cases:
        got = ops.segreduce_sorted(v, ids, nseg, op=op)
        torch.cuda.synchronize()
        if op == "sum" and v.dtype == torch.float32:
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
        variants.append(dict(case=name, rows=m, segments=nseg,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, library_ms=library_ms))
        log(f"  {name:38s} exact  ms={ms:.4f}  bound_ms={bound_ms:.4f}  "
            f"plain_ms={plain_ms:.4f}  library_ms={library_ms:.4f}")
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
    log(events.table(sort_by="self_device_time_total", row_limit=15,
                     max_name_column_width=70))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=21,
                    help="R-MAT scale of the full-size graph (default 21)")
    ap.add_argument("--profile", action="store_true",
                    help="after phase 4, run detect() once more under "
                    "torch.profiler and print device time by kernel")
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

    entry["launches"] = launches
    log(json.dumps({"kernels": [entry]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
