"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, at smoke
widths and small shapes: each cell's step traced once on DTensors of its
shardings over a ``fake`` process group of 8 ranks, as ``(4, 2)`` ``(data,
model)`` and ``(2, 2, 2)`` ``(pod, data, model)`` meshes; the B.5 op's
flops against :func:`attention_pairs`; flops linear in depth (the layers
loop in Python, so the trace sees each); and one step per family on one
CPU device against the reference's ``plan.step_fn`` on the same numpy
inputs, within the model tests' tolerances (float32: losses and logits
1e-4, gradients and moments ``rtol`` 1e-3 / ``atol`` 1e-5).

Each trace opens and destroys its own fake group (the group is
process-global, and files run side by side in worker processes).  Traces
run on fake CPU tensors, as the dry run does on every host; a fake tensor
reaches the registered B.5 op on any device.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch.distributed.device_mesh import init_device_mesh

from repro.configs import get_spec as j_spec
from repro.launch.steps import build_cell as j_build
from repro_torch.configs import get_spec
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.kernels.flash_attn import attention_pairs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_group
from repro_torch.launch.steps import build_cell, concrete_args
from repro_torch.models import params_from_numpy
from repro_torch.tree import tree_leaves, tree_map

SMALL = dict(
    lm=dict(
        train_4k=dict(kind="train", seq_len=64, global_batch=8),
        prefill_32k=dict(kind="prefill", seq_len=64, global_batch=8),
        decode_32k=dict(kind="decode", seq_len=64, global_batch=8)),
    gnn=dict(
        full_graph_sm=dict(kind="full", n_nodes=60, n_edges=200, d_feat=12,
                           n_classes=5),
        minibatch_lg=dict(kind="sampled", n_nodes=100, n_edges=400,
                          batch_nodes=8, fanout=(3, 2), d_feat=12,
                          n_classes=5),
        molecule=dict(kind="batched", n_nodes=5, n_edges=8, batch=8,
                      d_feat=6, n_classes=1)),
    recsys=dict(
        train_batch=dict(kind="train", batch=16),
        serve_p99=dict(kind="serve", batch=16),
        retrieval_cand=dict(kind="retrieval", batch=1, n_candidates=32)),
)
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
RECORD_KEYS = {
    "hlo_flops", "hlo_bytes", "collective_bytes", "collective_breakdown",
    "collective_ops", "t_compute", "t_memory", "t_collective", "bottleneck",
    "step_time_bound", "model_flops", "useful_flops_ratio",
    "roofline_fraction", "bytes_per_device",
}
LOSS_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5


def small_spec(arch, shapes=None, **replace):
    spec = get_spec(arch)
    return dataclasses.replace(
        spec, config=dataclasses.replace(spec.smoke, **replace),
        shapes=shapes or SMALL[spec.family])


def trace(spec, shape, mesh_name):
    dims, axes = MESHES[mesh_name]
    with fake_process_group(8):
        mesh = init_device_mesh(dryrun.TRACE_DEVICE, dims,
                                mesh_dim_names=axes)
        plan = build_cell(spec, shape, mesh)
        return dryrun.trace_plan(plan, mesh, 8)


CELLS = [
    ("tinyllama-1.1b", "train_4k", ("4x2",)),
    ("tinyllama-1.1b", "decode_32k", ("4x2", "2x2x2")),
    ("mixtral-8x7b", "train_4k", ("4x2",)),
    ("gcn-cora", "full_graph_sm", ("4x2", "2x2x2")),
    ("gat-cora", "minibatch_lg", ("4x2", "2x2x2")),
    ("nequip", "molecule", ("4x2", "2x2x2")),
    ("bst", "train_batch", ("4x2",)),
    ("bst", "serve_p99", ("4x2", "2x2x2")),
    ("bst", "retrieval_cand", ("4x2", "2x2x2")),
]


@pytest.mark.parametrize("arch,shape,mesh_name", [
    (a, s, m) for a, s, ms in CELLS for m in ms])
def test_cell_traces_ok(arch, shape, mesh_name):
    rec = trace(small_spec(arch), shape, mesh_name)
    assert RECORD_KEYS <= set(rec)
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["step_time_bound"] == max(
        rec["t_compute"], rec["t_memory"], rec["t_collective"])
    bpd = rec["bytes_per_device"]
    assert 0 < bpd["argument"] <= bpd["peak"]
    if rec["gathered_fallbacks"]:      # the tracer's gathers, split out
        gb = rec["gathered_bytes"]
        assert gb["collective"] <= rec["collective_bytes"]
        assert sum(gb["collective_by_op"].values()) == gb["collective"]
        assert 0 <= gb["peak"] <= bpd["peak"]
    else:
        assert "gathered_bytes" not in rec


def _flash_prefill(n_layers, mesh_name="4x2"):
    spec = small_spec("tinyllama-1.1b", attn_impl="flash",
                      n_layers=n_layers)
    return spec, trace(spec, "prefill_32k", mesh_name)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_flash_prefill_reaches_registered_op(mesh_name):
    """The prefill's attention is the B.5 op (traced, not launched), its
    flops the ``attention_pairs`` formula on each device's shard."""
    spec, rec = _flash_prefill(2, mesh_name)
    cfg, sh = spec.config, spec.shapes["prefill_32k"]
    got = rec["flops_by_op"]["repro_torch.flash_attention"]
    S, B = sh["seq_len"], sh["global_batch"]
    total = cfg.n_layers * 4 * B * cfg.n_heads * cfg.d_head * \
        attention_pairs(S, S, True, cfg.sliding_window)
    # batch-sharded over the data axes, or head-sharded, or both
    assert total % got == 0 and 1 <= total // got <= 8
    assert "aten.bmm" not in rec["flops_by_op"]   # no chunked attention


def test_flops_linear_in_depth():
    f = [_flash_prefill(n)[1]["hlo_flops"] for n in (1, 2, 3)]
    assert f[2] - f[1] == f[1] - f[0] > 0


# ---- one step per family on one CPU device against the reference ----------

def _j_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _to_numpy(tree):
    return tree_map(lambda x: x.numpy(), tree)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


STEP_CELLS = [("tinyllama-1.1b", "train_4k"), ("mixtral-8x7b", "prefill_32k"),
              ("gcn-cora", "full_graph_sm"), ("bst", "train_batch"),
              ("bst", "serve_p99")]


@pytest.mark.parametrize("arch,shape", STEP_CELLS)
def test_step_matches_reference(arch, shape):
    spec = small_spec(arch)
    jspec = j_spec(arch)
    jspec = dataclasses.replace(jspec, config=jspec.smoke,
                                shapes=SMALL[spec.family])
    tp = build_cell(spec, shape, AbstractMesh((1, 1), ("data", "model")))
    jp = j_build(jspec, shape, _j_mesh())
    gen = torch.Generator().manual_seed(7)
    args_np = _to_numpy(concrete_args(tp, gen, "cpu"))
    t_args = params_from_numpy(args_np, device="cpu")
    j_args = jax.tree.map(jnp.asarray, args_np)
    t_out = tp.step_fn(*t_args)
    j_out = jax.jit(jp.step_fn)(*j_args)
    if tp.step_name == "train_step":
        t_new, t_opt, t_m = t_out
        j_new, j_opt, j_m = j_out
        _close(t_m["loss"], j_m["loss"], LOSS_TOL, LOSS_TOL)
        _close(t_m["grad_norm"], j_m["grad_norm"], GRAD_RTOL, GRAD_ATOL)
        for t, j in zip(tree_leaves(t_opt["m"]), jax.tree.leaves(j_opt["m"])):
            _close(t.detach(), j, GRAD_RTOL, GRAD_ATOL)
        for t, j in zip(tree_leaves(t_new), jax.tree.leaves(j_new)):
            _close(t.detach(), j, GRAD_RTOL, GRAD_ATOL)
    else:
        _close(t_out, j_out, LOSS_TOL, LOSS_TOL)


# ---- the decode cache's slot write on a length-sharded DTensor -------------

@pytest.mark.parametrize("placements,shape,slot,local_slot", [
    # the length (dim 1) over both mesh dims: rank 0 holds slots [0, 2)
    (("S1", "S1"), (2, 16, 3), 1, 1),
    (("S1", "S1"), (2, 16, 3), 5, None),
    # batch over 'data', length over 'model': rank 0 holds slots [0, 8)
    (("S0", "S1"), (8, 16, 3), 7, 7),
    (("S0", "S1"), (8, 16, 3), 8, None),
    # an uneven split: 10 over 4 in chunks of 3, rank 0 holds [0, 3)
    (("S1", "R"), (2, 10, 3), 2, 2),
])
def test_write_slot_writes_the_shard_that_holds_it(placements, shape, slot,
                                                   local_slot):
    """``write_slot`` (the decode step's cache write on DTensors) writes
    rank 0's local shard at the slot's local offset where rank 0 holds the
    slot, and nothing where it does not; a DTensor value is redistributed
    to the cache's placements on the other dims first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.dtensor_rules import write_slot

    pl = [Shard(int(p[1])) if p[0] == "S" else Replicate()
          for p in placements]
    with fake_process_group(8):
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data",
                                                               "model"))
        local_shape = list(shape)
        for p, n in zip(pl, mesh.shape):
            if isinstance(p, Shard):
                local_shape[p.dim] = -(-local_shape[p.dim] // n)
        buf = DTensor.from_local(torch.zeros(local_shape), mesh, pl,
                                 run_check=False, shape=torch.Size(shape),
                                 stride=torch.empty(shape).stride())
        val = DTensor.from_local(torch.full((shape[0], shape[2]), 7.0),
                                 mesh, [Replicate(), Replicate()],
                                 run_check=False)
        write_slot(buf, 1, slot, val)
        write_slot(buf, 1, slot, 9.0)     # a number, over the first write
        local = buf.to_local()
        want = torch.zeros(local_shape)
        if local_slot is not None:
            want[:, local_slot] = 9.0
        assert torch.equal(local, want)
        if local_slot is not None:        # the tensor value went first
            buf2 = DTensor.from_local(torch.zeros(local_shape), mesh, pl,
                                      run_check=False,
                                      shape=torch.Size(shape),
                                      stride=torch.empty(shape).stride())
            write_slot(buf2, 1, slot, val)
            want[:, local_slot] = 7.0
            assert torch.equal(buf2.to_local(), want)


def test_shard_to_shard_counts_an_all_to_all():
    """A shard moved from one dim to another is one all-to-all in the
    trace on a CPU mesh too (DTensor would gather and chunk there): its
    output, a ``[16, 2]`` float32 shard, is what the record counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.roofline.analyze import StepTracer, collective_bytes

    with fake_process_group(8):
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
        tracer = StepTracer()
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(2, 16), mesh, [Shard(0)],
                                   run_check=False, shape=torch.Size((16, 16)),
                                   stride=(16, 1))
            with tracer.watching():
                y = x.redistribute(mesh, [Shard(1)])
        assert tuple(y.to_local().shape) == (16, 2)
    got = collective_bytes(tracer.collectives)
    assert got["n_ops"] == {"all-to-all": 1}
    assert got["total"] == got["all-to-all"] == 16 * 2 * 4
