#!/usr/bin/env python
"""Fit the port's dense-vs-sortscan crossover density on a card.

``repro_torch.service.buckets.choose_scan`` takes the dense ``[nv, nv]``
community-matrix scan or the sortscan for a graph of ``nv`` node slots and
``m_cap`` edge slots.  Between ``dense_small_nv`` and ``dense_max_nv`` it
compares ``m_cap / nv**2`` with a crossover density.  This script measures
that crossover: on the grid of (nv, m_cap) shapes of the reference's
``scripts/calibrate_dense_scan.py`` it times the port's ``louvain_impl``
under both scans on SBM graphs at about 60 % of the edge capacity, and fits
the threshold that misclassifies the fewest measured shapes (ties: the one
that loses the least time over them; see :func:`fit_threshold`).  Both
scans give the same labels, which the script checks on every shape.

Each time is the least of 9 calls (2 with ``--quick``) after one warm-up
of each scan, the two scans' calls interleaved, on the host clock with the
device synchronized.  The output is the entry of the
device type (``"cuda"`` by default) in ``--out`` (default
``src/repro_torch/service/dense_scan_calib.json``), with the card's name and
power limit as ``nvidia-smi`` prints them; other entries are kept.

Usage:
  PYTHONPATH=src python scripts/torch_calibrate_dense_scan.py [--quick]
      [--out PATH] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import LouvainConfig, louvain_impl  # noqa: E402
from repro_torch.graph import sbm_graph  # noqa: E402
from repro_torch.service.buckets import CALIB_FILE  # noqa: E402

CFG = LouvainConfig()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _time(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def _bench_pair(fa, fb, device, repeats):
    """Least host-clock seconds of ``fa`` and of ``fb``, their calls
    interleaved so that a drift of the host hits both alike."""
    fa(), fb()   # warm-up (kernel build on the first call)
    ta, tb = [], []
    for _ in range(repeats):
        ta.append(_time(fa, device))
        tb.append(_time(fb, device))
    return float(np.min(ta)), float(np.min(tb))


def _graph(n_cap, m_cap, device):
    """The reference script's SBM at about 60 % of ``m_cap``, or ``None``
    where its edges do not fit."""
    target_edges = max(int(0.6 * m_cap) // 2, n_cap)
    p = min(target_edges / (n_cap * (n_cap - 1) / 2), 0.9)
    kw = dict(n_nodes=n_cap, n_blocks=max(n_cap // 32, 2),
              p_in=min(4 * p, 0.9), p_out=p / 4, seed=0)
    if sbm_graph(**kw, device="cpu")[0].m_cap > m_cap:
        return None
    return sbm_graph(**kw, n_cap=n_cap, m_cap=m_cap, device=device)[0]


def measure(nv_rungs, densities, repeats, device):
    """Times (dense, sort) per shape: one measurement row each."""
    rows = []
    for n_cap in nv_rungs:
        nv = n_cap + 1
        for dens in densities:
            m_cap = int(dens * nv * nv)
            g = _graph(n_cap, m_cap, device)
            if g is None:
                continue
            C_dense, _ = louvain_impl(g, CFG, scan="dense")
            C_sort, _ = louvain_impl(g, CFG, scan="sort")
            if not torch.equal(C_dense, C_sort):
                raise AssertionError(f"scans differ at n_cap={n_cap} "
                                     f"m_cap={m_cap}")
            t_dense, t_sort = _bench_pair(
                lambda: louvain_impl(g, CFG, scan="dense"),
                lambda: louvain_impl(g, CFG, scan="sort"), device, repeats)
            rows.append(dict(n_cap=n_cap, m_cap=m_cap,
                             density=round(m_cap / nv / nv, 5),
                             t_dense_ms=round(t_dense * 1e3, 3),
                             t_sort_ms=round(t_sort * 1e3, 3),
                             dense_wins=t_dense < t_sort))
            print(f"  nv={nv:5d} m_cap={m_cap:6d} density={dens:.4f}  "
                  f"dense {t_dense * 1e3:9.3f} ms  sort {t_sort * 1e3:9.3f} "
                  f"ms  -> {'dense' if t_dense < t_sort else 'sort'}",
                  flush=True)
    return rows


def fit_threshold(rows, fallback=0.02) -> float:
    """The crossover density that agrees best with the measured rows.

    ``choose_scan`` takes the dense scan where ``density >= threshold``.
    Each measured density (and one above them all) is a candidate; the
    one that misclassifies the fewest rows wins, and among those the one
    whose misclassified rows lose the least summed time, then the lowest.
    No rows: ``fallback``.
    """
    if not rows:
        return fallback
    cands = sorted({r["density"] for r in rows})
    cands.append(cands[-1] * 2.0)

    def cost(t):
        wrong = [r for r in rows if (r["density"] >= t) != r["dense_wins"]]
        lost = sum(abs(r["t_dense_ms"] - r["t_sort_ms"]) for r in wrong)
        return len(wrong), lost, t

    return float(min(cands, key=cost))


def card_line(device) -> str:
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="two shapes, two repeats (a rehearsal); writes "
                    "dense_scan_calib.quick.json unless --out is given")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.quick:
        nv_rungs, densities, repeats = [256], [0.008, 0.03], 2
        out = args.out or pathlib.Path("dense_scan_calib.quick.json")
    else:
        nv_rungs = [192, 256, 512, 1024]
        densities = [0.004, 0.008, 0.016, 0.031, 0.062, 0.125]
        repeats = 9
        out = args.out or CALIB_FILE
    card = card_line(device)
    print(f"calibrating the dense/sort crossover on {device.type}: {card}",
          flush=True)
    rows = measure(nv_rungs, densities, repeats, device)
    thr = fit_threshold(rows)
    print(f"fitted dense_min_density = {thr:.5f}")
    data = {}
    if out.exists():
        data = json.loads(out.read_text())
    data[device.type] = dict(
        dense_min_density=round(thr, 5), fitted_from=f"{len(rows)} shapes",
        card=card, torch=torch.__version__, measurements=rows)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(data, indent=2) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
