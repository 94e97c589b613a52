"""Multi-pod dry run: trace every (arch x shape x mesh) cell once, on fake
ranks (port of ``repro/launch/dryrun.py``).

This proves the distribution config is coherent without hardware: one
process opens a ``fake`` process group of 256 or 512 ranks
(:func:`repro_torch.launch.mesh.fake_process_group`), builds the
production ``DeviceMesh`` over it, and runs each cell's step once on
DTensors of the plan's shardings whose local shards are fake tensors
(``FakeTensorMode``: no memory, no kernel, no card; :data:`TRACE_DEVICE`).  Every collective a
redistribution issues returns at once.  :class:`~repro_torch.roofline.
analyze.StepTracer` watches rank 0's local ops, and the record holds the
per-device flops, bytes and collective bytes, the argument, output and
peak bytes a device, and the H100 roofline terms and bottleneck
(:mod:`repro_torch.roofline`).

The reference compiles with XLA and corrects its LM records by depth
extrapolation, because XLA's cost analysis counts a ``lax.scan`` body
once.  The port's forward loops over its layers in Python, so the trace
sees every layer and needs no correction.

``louvain`` cells (``--include-graph``) are not traced: their pass is a
host loop over spawned ranks whose sweeps depend on the data.  Their
record (``status='analytic'``) holds the reference's analytic
``model_flops`` and the per-rank argument bytes of the plan's edge shards.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape prefill_32k
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --all --mesh single --include-graph

Records land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.
Exit code 1 when any cell fails.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_spec
from repro_torch.launch.mesh import (
    MULTIPOD_SHAPE, POD_SHAPE, fake_process_group, make_production_mesh,
)
from repro_torch.launch.steps import build_cell, fake_dtensor
from repro_torch.roofline.analyze import StepTracer, analyze_trace
from repro_torch.roofline.hw import HW
from repro_torch.tree import tree_leaves, tree_map

# The device of the fake shards, on every host.  A fake tensor holds no
# memory and runs nothing, so the counts do not depend on it: the one op
# that routes by device, B.5 (``ops.flash_attention``), takes any fake
# tensor to its registered op.  The CPU is the device on which a CPU-only
# PyTorch, too, traces every step (its autograd asks a CUDA tensor for a
# device guard it lacks).
TRACE_DEVICE = "cpu"

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    n = 0
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x._local_tensor
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
    return n


def trace_plan(plan, mesh, chips: int) -> dict:
    """Run ``plan.step_fn`` once on fake DTensors of its shardings' specs
    on ``mesh`` (a ``DeviceMesh`` over an open process group, with the
    plan's axis names; the fake shards live on its device type) and return
    the roofline record of what one device did."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import dtensor_rules
    from repro_torch.models import transformer

    dtensor_rules.register()
    tracer = StepTracer()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tree_map(lambda s, sh: fake_dtensor(s, sh, mesh),
                        plan.args, plan.in_shardings)
        arg_bytes = tracer.track(args)
        with tracer.watching(), implicit_replication(), \
                tracer.replaying(transformer, "_kv_step"):
            out = plan.step_fn(*args)
        out_bytes = _local_bytes(out)
    return analyze_trace(tracer, chips, model_flops=plan.model_flops,
                         argument_bytes=arg_bytes, output_bytes=out_bytes)


def run_cell(arch: str, shape: str, multi_pod: bool, *, out_dir: str = OUT_DIR,
             verbose: bool = True, spec=None) -> dict:
    """One cell on its production mesh, over a fake group opened and
    closed here; ``spec`` overrides the registry's (a cut config)."""
    mesh_name = "multipod" if multi_pod else "pod"
    spec = spec or get_spec(arch)
    if shape in spec.skip_shapes:
        rec = dict(arch=arch, shape=shape, mesh=mesh_name, status="skipped",
                   reason=spec.skip_shapes[shape])
        _save(rec, out_dir, arch, shape, mesh_name)
        if verbose:
            print(f"[skip] {arch} x {shape}: {spec.skip_shapes[shape]}")
        return rec

    chips = math.prod(MULTIPOD_SHAPE if multi_pod else POD_SHAPE)
    with fake_process_group(chips):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=TRACE_DEVICE)
        t0 = time.time()
        plan = build_cell(spec, shape, mesh)
        t_build = time.time() - t0
        t0 = time.time()
        if spec.family == "graph":
            rec = _analytic_record(plan, chips)
        else:
            rec = trace_plan(plan, mesh, chips)
        t_trace = time.time() - t0
    rec.update(
        arch=arch, shape=shape, mesh=mesh_name,
        status="analytic" if spec.family == "graph" else "ok",
        step=plan.step_name, build_s=round(t_build, 2),
        trace_s=round(t_trace, 2), notes=plan.notes,
        hw=dict(name=HW.name, power_limit_w=HW.power_limit_w),
    )
    bpd = rec.get("bytes_per_device", {})
    rec["fits_hbm"] = bpd.get("peak", 0) <= HW.hbm_bytes
    _save(rec, out_dir, arch, shape, mesh_name)
    if verbose:
        if rec["status"] == "analytic":
            print(f"[analytic] {arch} x {shape} x {mesh_name}: model_flops="
                  f"{rec['model_flops']:.3e} | args/rank="
                  f"{bpd['argument'] / 1e9:.2f}GB")
        else:
            gb = rec.get("gathered_bytes")
            print(
                f"[ok] {arch} x {shape} x {mesh_name}: "
                f"comp={rec['t_compute']:.2e}s mem={rec['t_memory']:.2e}s "
                f"coll={rec['t_collective']:.2e}s -> {rec['bottleneck']} "
                f"| peak/dev={bpd.get('peak', 0) / 1e9:.2f}GB "
                + (f"| gathered: coll={gb['collective'] / 1e9:.2f}GB "
                   f"peak={gb['peak'] / 1e9:.2f}GB " if gb else "")
                + f"| trace {t_trace:.0f}s"
            )
    return rec


def _analytic_record(plan, chips: int) -> dict:
    """A louvain cell's record: analytic flops and the per-rank argument
    bytes (one edge shard of src, dst and w, two vertex bounds, 2m and the
    vertex count)."""
    per_rank = sum(math.prod(s.shape[1:]) * s.itemsize if s.shape else
                   s.itemsize for s in plan.args)
    return dict(chips=chips, model_flops=float(plan.model_flops),
                n_shards=plan.extra["n_shards"], nv=plan.extra["nv"],
                m_shard=plan.extra["m_shard"],
                bytes_per_device=dict(argument=int(per_rank)))


def _save(rec: dict, out_dir: str, arch: str, shape: str, mesh_name: str):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-graph", action="store_true",
                    help="also run the paper's own louvain cells")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)

    meshes = dict(single=[False], multi=[True], both=[False, True])[args.mesh]
    cells = []
    if args.all:
        archs = [a for a in ARCH_IDS if args.include_graph or a != "louvain"]
        for a in archs:
            spec = get_spec(a)
            for s in spec.shapes:
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failures = []
    for a, s in cells:
        for mp in meshes:
            try:
                run_cell(a, s, mp, out_dir=args.out_dir)
            except Exception as e:  # record failures, keep sweeping
                mesh_name = "multipod" if mp else "pod"
                rec = dict(arch=a, shape=s, mesh=mesh_name, status="error",
                           error=f"{type(e).__name__}: {e}",
                           traceback=traceback.format_exc()[-4000:])
                _save(rec, args.out_dir, a, s, mesh_name)
                failures.append((a, s, mesh_name, str(e)[:200]))
                print(f"[FAIL] {a} x {s} x {mesh_name}: {e}")
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
