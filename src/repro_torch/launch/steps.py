"""Step builders: one (arch x shape x mesh) cell -> a step function, its
abstract inputs and their shardings (port of ``repro/launch/steps.py``).

``build_cell`` returns a :class:`CellPlan` carrying the step function,
abstract inputs (:class:`SDS` leaves: shapes and dtypes, nothing
allocated) and in/out shardings, ready for the dry run
(:mod:`repro_torch.launch.dryrun`: the step traced over fake ranks on
DTensors of those shardings) or for real execution on concrete tensors of
the same structure (:func:`concrete_args`; plain tensors, or DTensors by
:func:`distribute_args`).

The abstract inputs replace ``jax.eval_shape``: :func:`eval_shape` runs an
``init_*`` function (or any builder) under ``FakeTensorMode``.  The init
functions draw from a ``torch.Generator``; a CPU generator, with the
outputs left on the CPU, draws fake CPU tensors under that mode without
complaint, and only their shapes and dtypes are kept, so no CUDA generator
(which would need a card) is ever asked for.

Sharding policy (the reference's):
  * LM: FSDP params/optimizer over ('pod','data'), tensor-parallel over
    'model'; batch over ('pod','data'); activations constrained
    batch-sharded (``constrain``, a DTensor redistribution).
  * GNN full-graph: nodes over ('pod','data'), edges over the whole mesh.
  * GNN sampled/batched: pure data parallel over seeds/graphs.
  * recsys: embedding-table rows over 'model', batch over ('pod','data').
  * louvain: vertex-aligned edge shards, one a rank
    (:func:`repro_torch.core.distributed.build_community_step`).

Every sharding is *divisibility-safe*: mesh axes that do not divide an
array dimension are dropped for that dimension (:func:`_safe_spec`).

A mesh here is a ``DeviceMesh`` with axis names or an
:class:`~repro_torch.distributed.sharding.AbstractMesh`; specs need only
the names and sizes.  The step functions take plain tensors or DTensors
alike (the trace runs them under DTensor's ``implicit_replication``, so a
plain tensor made inside a step counts as replicated).

One input differs from the reference's: the sampled GNN step takes its
neighbour draws (int32 ``[Bn * f1 + Bn * f1 * f2]``, uniform in ``[0,
DRAW_HIGH)``, as :func:`repro_torch.graph.sampler.sample_layer` takes
them) where the reference takes a ``jax.random`` key, which torch cannot
use.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.distributed.sharding import (
    NamedSharding, P, ShardingRules, map_axes, mesh_axes,
)
from repro_torch.launch.train import value_and_grad
from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class SDS:
    """An abstract tensor: shape and dtype (``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype, device="meta").element_size()

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.itemsize


@dataclasses.dataclass
class CellPlan:
    arch_id: str
    shape_name: str
    step_name: str                 # train_step | serve_step | prefill_step
    step_fn: Callable
    args: tuple                    # abstract (SDS) args
    in_shardings: Any
    out_shardings: Any
    model_flops: float             # useful work per step (6ND etc.)
    notes: str = ""
    donate: tuple = ()
    # how :func:`concrete_args` fills each arg: a callable ``(gen, device)
    # -> tree``, or a tree like the arg of fill rules (see ``_fill``)
    fills: tuple = ()
    extra: dict = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------------
# abstract values and concrete inputs
# --------------------------------------------------------------------------

def eval_shape(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under ``FakeTensorMode``: its tensors as
    :class:`SDS` leaves (the reference's ``jax.eval_shape``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        out = fn(*args, **kwargs)
    return tree_map(lambda x: SDS(tuple(x.shape), x.dtype)
                    if isinstance(x, torch.Tensor) else x, out)


NORMAL, ZEROS = ("normal",), ("zeros",)


def randint(hi: int) -> tuple:
    return ("randint", int(hi))


def full(value) -> tuple:
    return ("full", value)


def _fill(rule, sds: SDS, gen: torch.Generator, device) -> torch.Tensor:
    kind = rule[0]
    if kind == "normal":
        x = torch.randn(sds.shape, generator=gen, device=gen.device)
    elif kind == "zeros":
        x = torch.zeros(sds.shape)
    elif kind == "randint":
        x = torch.randint(0, rule[1], sds.shape, generator=gen,
                          device=gen.device)
    elif kind == "full":
        x = torch.full(sds.shape, rule[1])
    else:
        raise ValueError(f"unknown fill rule {rule!r}")
    return x.to(device=device, dtype=sds.dtype)


def _is_rule(x) -> bool:
    return isinstance(x, tuple) and bool(x) and isinstance(x[0], str)


def _fill_tree(rules, abstract, gen, device):
    if _is_rule(rules):
        return tree_map(lambda s: _fill(rules, s, gen, device), abstract)
    if isinstance(rules, dict):
        return {k: _fill_tree(rules[k], abstract[k], gen, device)
                for k in sorted(abstract)}
    if isinstance(rules, (list, tuple)):
        return type(abstract)(_fill_tree(r, a, gen, device)
                              for r, a in zip(rules, abstract))
    raise TypeError(f"not a fill rule: {rules!r}")


def concrete_args(plan: CellPlan, gen: torch.Generator, device) -> tuple:
    """Concrete tensors of ``plan.args``' shapes and dtypes on ``device``,
    drawn from ``gen``: parameters by the model's ``init_*`` (cast to the
    plan's dtypes), optimiser moments zero, ids within their ranges,
    floats standard normal."""
    out = []
    for fill, sds in zip(plan.fills, plan.args):
        tree = fill(gen, device) if callable(fill) else _fill_tree(
            fill, sds, gen, device)
        tree = tree_map(lambda x, s: x.to(s.dtype), tree, sds)
        out.append(tree)
    return tuple(out)


def distribute_args(args, shardings, mesh):
    """``args`` (concrete tensors) as DTensors on ``mesh`` (a
    ``DeviceMesh`` with the shardings' axis names) of ``shardings``'
    specs."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda x, sh: distribute_tensor(
        x, mesh, list(sh.placements())), args, shardings)


def fake_dtensor(sds: SDS, sharding: NamedSharding, mesh):
    """A DTensor on ``mesh`` of ``sds``' global shape and ``sharding``'s
    spec whose local shard is a new empty tensor on the mesh's device type:
    a fake one when called under ``FakeTensorMode``."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(sharding.shard_shape(sds.shape), dtype=sds.dtype,
                        device=mesh.device_type)
    stride, acc = [], 1
    for n in reversed(sds.shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, list(sharding.placements()),
                              run_check=False, shape=torch.Size(sds.shape),
                              stride=tuple(reversed(stride)))


def arg_bytes(plan: CellPlan) -> int:
    """Per-device bytes of the plan's arguments under its shardings."""
    return sum(math.prod(sh.shard_shape(sds.shape)) * sds.itemsize
               for sds, sh in zip(tree_leaves(plan.args),
                                  tree_leaves(plan.in_shardings)))


# --------------------------------------------------------------------------
# sharding helpers
# --------------------------------------------------------------------------

def _safe_spec(mesh, rules: ShardingRules, axes, shape) -> P:
    """Resolve logical axes -> PartitionSpec.

    Joint resolution: a mesh axis is consumed only if it is actually kept,
    and an axis is kept only when (a) it exists on this mesh, (b) it has not
    been consumed by an earlier dim, and (c) the running product divides the
    dim size.  (E.g. mixtral's 8-expert dim cannot take model=16, so 'model'
    stays available for the expert-FFN width dim.)
    """
    sizes = mesh_axes(mesh)
    logical = tuple(axes) + (None,) * (len(shape) - len(axes))
    used: set = set()
    parts = []
    for dim, ax in zip(shape, logical):
        names = rules.rules.get(ax, ()) if ax is not None else ()
        kept = []
        prod = 1
        for n in names:
            if n not in sizes or n in used:
                continue
            if dim % (prod * sizes[n]) == 0:
                kept.append(n)
                prod *= sizes[n]
        used.update(kept)
        if not kept:
            parts.append(None)
        elif len(kept) == 1:
            parts.append(kept[0])
        else:
            parts.append(tuple(kept))
    return P(*parts)


def shard_tree(mesh, rules, axes_tree, abs_tree):
    """NamedShardings for an abstract tree given a logical-axes tree."""
    return map_axes(
        lambda axes, node: NamedSharding(
            mesh, _safe_spec(mesh, rules, axes, node.shape)),
        axes_tree, abs_tree)


def replicated(mesh, tree):
    return tree_map(lambda _: NamedSharding(mesh, P()), tree)


def _named(mesh, rules, axes, shape) -> NamedSharding:
    return NamedSharding(mesh, _safe_spec(mesh, rules, axes, shape))


def _opt_axes(param_axes):
    return dict(
        m=param_axes, v=param_axes,
        step=(None,),
    )


def _constrain(mesh, rules):
    """``x`` redistributed batch-sharded (dim 0) and replicated elsewhere,
    where ``x`` is a DTensor (the reference's
    ``with_sharding_constraint``); anything else as it is."""
    def constrain(x):
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        axes = ("batch",) + (None,) * (x.ndim - 1)
        sh = _named(mesh, rules, axes, tuple(x.shape))
        return x.redistribute(x.device_mesh, list(sh.placements()))
    return constrain


def _train_metrics(mesh):
    return replicated(mesh, dict(grad_norm=0., lr=0., loss=0.))


def _is_fake(x) -> bool:
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(x)


def _cast_tree(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------

def _lm_cell(spec: ArchSpec, shape_name: str, mesh, rules) -> CellPlan:
    from repro_torch.models import transformer as T

    cfg = spec.config
    sh = spec.shapes[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    params_abs = eval_shape(T.init_params, torch.Generator(), cfg)
    p_axes = T.param_logical_axes(cfg)
    p_shard = shard_tree(mesh, rules, p_axes, params_abs)
    constrain = _constrain(mesh, rules)
    batch_shard = _named(mesh, rules, ("batch", None), (B, S))

    def init(dtype=None):
        def draw(gen, device):
            p = T.init_params(gen, cfg, device=device)
            return p if dtype is None else _cast_tree(p, dtype)
        return draw

    if kind == "train":
        opt_cfg = AdamWConfig()
        opt_abs = _adamw_abs(params_abs)
        o_shard = shard_tree(mesh, rules, _opt_axes(p_axes), opt_abs)

        def train_step(params, opt_state, tokens, targets):
            loss, grads = value_and_grad(
                lambda p: T.loss_fn(p, tokens, targets, cfg, constrain),
                params)
            lr_scale = warmup_cosine(opt_state["step"])
            params, opt_state, metrics = adamw_update(
                params, grads, opt_state, opt_cfg, lr_scale)
            metrics["loss"] = loss
            return params, opt_state, metrics

        args = (params_abs, opt_abs,
                SDS((B, S), torch.int32), SDS((B, S), torch.int32))
        in_sh = (p_shard, o_shard, batch_shard, batch_shard)
        out_sh = (p_shard, o_shard, _train_metrics(mesh))
        flops = 6.0 * cfg.active_param_count() * B * S
        fills = (init(), ZEROS, randint(cfg.vocab), randint(cfg.vocab))
        return CellPlan(spec.arch_id, shape_name, "train_step", train_step,
                        args, in_sh, out_sh, flops, donate=(0, 1),
                        fills=fills)

    if kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, tokens):
            logits = T.forward(params, tokens, cfg, constrain)
            return logits[:, -1].clone()     # not a view holding [B, S, V]

        args = (params_abs, SDS((B, S), torch.int32))
        out_sh = _named(mesh, rules, ("batch", None), (B, cfg.vocab))
        flops = 2.0 * cfg.active_param_count() * B * S
        return CellPlan(spec.arch_id, shape_name, "prefill_step",
                        prefill_step, args, (p_shard, batch_shard), out_sh,
                        flops, fills=(init(), randint(cfg.vocab)))

    # decode: one new token against a cache of seq_len context.
    # Params use 2-D tensor-parallel sharding (no 'fsdp'; widths over BOTH
    # mesh axes): FSDP would re-gather the weights each step to serve ONE
    # token, and model-only TP leaves mixtral-8x22b's expert FFNs at
    # 18 GB/device (E=8 cannot take model=16).
    rules = rules.with_overrides(
        fsdp=(), mlp=("model", "data"), heads=("model", "data"),
        vocab=("model", "data"),
    )
    # serving keeps no optimizer state and needs no f32 master: weights in
    # the compute dtype halve resident bytes and per-step weight reads
    params_abs = tree_map(lambda s: SDS(s.shape, cfg.compute_dtype),
                          params_abs)
    p_shard = shard_tree(mesh, rules, p_axes, params_abs)
    serve_cfg = dataclasses.replace(cfg, moe_dropless=True) \
        if cfg.is_moe else cfg
    cache_abs = eval_shape(T.init_cache, serve_cfg, B, S, device="cpu")
    # the cache shards along its LENGTH (flash-decoding split-K): attention
    # contracts locally per length shard and only softmax stats and [B, D]
    # partials cross devices
    cache_axes = dict(
        k=("stack", "batch", "kv_len", "kv_heads", None),
        v=("stack", "batch", "kv_len", "kv_heads", None),
        pos=("stack", "batch", "kv_len"),
        t=(None,),
    )
    c_shard = shard_tree(mesh, rules, cache_axes, cache_abs)

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        # a fake cache's position cannot be read: it is init_cache's, S
        t = S if _is_fake(cache["t"]) else None
        return T.decode_step(params, cache, tokens, serve_cfg, t=t)

    args = (params_abs, cache_abs, SDS((B,), torch.int32))
    tok_shard = _named(mesh, rules, ("batch",), (B,))
    logit_shard = _named(mesh, rules, ("batch", None), (B, cfg.vocab))
    flops = 2.0 * serve_cfg.active_param_count() * B
    cl = cfg.cache_len(S)
    fills = (init(cfg.compute_dtype),
             dict(k=NORMAL, v=NORMAL, pos=randint(cl), t=full(S)),
             randint(cfg.vocab))
    return CellPlan(spec.arch_id, shape_name, "serve_step", serve_step,
                    args, (p_shard, c_shard, tok_shard),
                    (logit_shard, c_shard), flops, donate=(1,), fills=fills)


def _adamw_abs(params_abs):
    """The abstract :func:`~repro_torch.optim.adamw_init` state of
    ``params_abs``: float32 moments and an int32 step."""
    f32 = tree_map(lambda s: SDS(s.shape, torch.float32), params_abs)
    return dict(m=f32, v=f32, step=SDS((), torch.int32))


# --------------------------------------------------------------------------
# GNN cells
# --------------------------------------------------------------------------

def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _gnn_model(spec: ArchSpec, d_in: int, n_classes: int):
    """Adapt the arch config to a shape's feature/class dims + bind fns
    (``fwd(p, x, s, d, w, cfg)``) and the axes function."""
    from repro_torch.models.gnn import gat, gatedgcn, gcn

    cfg = dataclasses.replace(spec.config, d_in=d_in, n_classes=n_classes)
    if spec.arch_id.startswith("gcn"):
        return (cfg, gcn.init_gcn,
                lambda p, x, s, d, w, c: gcn.gcn_forward(p, x, s, d, c))
    if spec.arch_id.startswith("gatedgcn"):   # before 'gat' (prefix!)
        return cfg, gatedgcn.init_gatedgcn, gatedgcn.gatedgcn_forward
    if spec.arch_id.startswith("gat"):
        return (cfg, gat.init_gat,
                lambda p, x, s, d, w, c: gat.gat_forward(p, x, s, d, c))
    raise KeyError(spec.arch_id)


def _gnn_flops(spec: ArchSpec, cfg, nv, ne):
    d_h = getattr(cfg, "d_hidden", 32)
    L = cfg.n_layers
    d_in = getattr(cfg, "d_in", d_h)
    if spec.arch_id == "nequip":
        C = cfg.d_hidden
        paths = 11
        return L * ne * paths * C * 25 * 2.0 + L * ne * cfg.n_rbf * 16 * 2
    heads = getattr(cfg, "n_heads", 1)
    per_edge = 2.0 * d_h * heads
    per_node = 2.0 * d_in * d_h + 2.0 * d_h * d_h * (
        5 if "gated" in spec.arch_id else 1)
    return L * (nv * per_node + ne * per_edge)


def _ce_rows(logits, y):
    """Per-row ``logsumexp - gold`` (the reference's softmax CE)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return logz - gold


def _gnn_train(loss, opt_cfg):
    def train_step(params, opt, *data):
        l, g = value_and_grad(lambda p: loss(p, *data), params)
        params, opt, m = adamw_update(params, g, opt, opt_cfg)
        m["loss"] = l
        return params, opt, m
    return train_step


def _gnn_cell(spec: ArchSpec, shape_name: str, mesh, rules) -> CellPlan:
    from repro_torch.models.gnn import common
    from repro_torch.models.gnn import nequip as NQ

    sizes = mesh_axes(mesh)
    sh = spec.shapes[shape_name]
    kind = sh["kind"]
    flat = math.prod(sizes.values())
    opt_cfg = AdamWConfig(weight_decay=0.0)
    rep = NamedSharding(mesh, P())

    def plan(args, in_sh, fl, fills, params_abs, train_step, notes=""):
        out_sh = (replicated(mesh, params_abs), replicated(mesh, args[1]),
                  _train_metrics(mesh))
        return CellPlan(spec.arch_id, shape_name, "train_step", train_step,
                        args, in_sh, out_sh, fl, donate=(0, 1), fills=fills,
                        notes=notes)

    if kind == "batched":
        # molecule: batch of small graphs, flattened with a ghost slot
        Bg, n_per, e_per = sh["batch"], sh["n_nodes"], sh["n_edges"]
        nv = Bg * n_per + 1
        ne = _round_up(Bg * e_per * 2, flat)
        e_sh = _named(mesh, rules, ("edges",), (ne,))
        if spec.arch_id == "nequip":
            cfg = spec.config
            params_abs = eval_shape(NQ.init_nequip, torch.Generator(), cfg)

            def loss(params, species, pos, src, dst, gid, y):
                e = NQ.nequip_forward(params, species, pos, src, dst, cfg)
                e_g = common.scatter_sum(e, gid, Bg + 1)[:Bg]
                return torch.mean((e_g - y) ** 2)

            args = (params_abs, _adamw_abs(params_abs),
                    SDS((nv,), torch.int32), SDS((nv, 3), torch.float32),
                    SDS((ne,), torch.int32), SDS((ne,), torch.int32),
                    SDS((nv,), torch.int32), SDS((Bg,), torch.float32))
            in_sh = (replicated(mesh, params_abs), replicated(mesh, args[1]),
                     rep, rep, e_sh, e_sh, rep, rep)
            fills = (lambda g, d: NQ.init_nequip(g, cfg, device=d), ZEROS,
                     randint(cfg.n_species), NORMAL, randint(nv),
                     randint(nv), randint(Bg + 1), NORMAL)
            return plan(args, in_sh, _gnn_flops(spec, cfg, nv, ne), fills,
                        params_abs, _gnn_train(loss, opt_cfg))
        d_in, n_cls = sh["d_feat"], 8
        cfg, init, fwd = _gnn_model(spec, d_in, n_cls)
        params_abs = eval_shape(init, torch.Generator(), cfg)

        def loss(params, x, src, dst, w, gid, y):
            out = fwd(params, x, src, dst, w, cfg)         # [nv, C]
            pooled = common.scatter_sum(out, gid, Bg + 1)[:Bg]
            return torch.mean(_ce_rows(pooled, y))

        args = (params_abs, _adamw_abs(params_abs),
                SDS((nv, d_in), torch.float32),
                SDS((ne,), torch.int32), SDS((ne,), torch.int32),
                SDS((ne,), torch.float32),
                SDS((nv,), torch.int32), SDS((Bg,), torch.int32))
        in_sh = (replicated(mesh, params_abs), replicated(mesh, args[1]),
                 rep, e_sh, e_sh, e_sh, rep, rep)
        fills = (lambda g, d: init(g, cfg, device=d), ZEROS, NORMAL,
                 randint(nv), randint(nv), NORMAL, randint(Bg + 1),
                 randint(n_cls))
        return plan(args, in_sh, _gnn_flops(spec, cfg, nv, ne), fills,
                    params_abs, _gnn_train(loss, opt_cfg))

    if kind == "sampled":
        # neighbor-sampled training on a big graph held as CSR inputs
        from repro_torch.graph.sampler import DRAW_HIGH, sample_layer

        N, E = sh["n_nodes"], sh["n_edges"]
        Bn = sh["batch_nodes"]
        f1, f2 = sh["fanout"]
        d_in, n_cls = sh["d_feat"], sh["n_classes"]
        nv_full = N + 1
        ne_full = _round_up(E, flat)
        p1 = Bn * f1
        p2 = p1 * f2
        P_nodes = Bn + p1 + p2 + 1                      # + ghost
        ne_sub = _round_up(2 * (p1 + p2), flat)
        nequip = spec.arch_id == "nequip"
        if nequip:
            cfg = spec.config
            init, fwd = NQ.init_nequip, None
        else:
            cfg, init, fwd = _gnn_model(spec, d_in, n_cls)
        params_abs = eval_shape(init, torch.Generator(), cfg)

        def make_subgraph(draws, seeds, row_offsets, dst_full):
            dev = seeds.device
            r1 = draws[:p1].reshape(Bn, f1)
            r2 = draws[p1:].reshape(p1, f2)
            n1, v1 = sample_layer(r1, seeds, row_offsets, dst_full)
            fr1 = n1.reshape(-1)
            n2, v2 = sample_layer(r2, fr1, row_offsets, dst_full)
            fr2 = n2.reshape(-1)
            nodes = torch.cat([seeds, fr1, fr2])
            ghost = P_nodes - 1
            # positional edges: hop1 nbrs -> seeds, hop2 nbrs -> hop1
            src1 = Bn + torch.arange(p1, dtype=torch.int32, device=dev)
            dst1 = torch.arange(Bn, dtype=torch.int32,
                                device=dev).repeat_interleave(f1)
            src2 = Bn + p1 + torch.arange(p2, dtype=torch.int32, device=dev)
            dst2 = Bn + torch.arange(p1, dtype=torch.int32,
                                     device=dev).repeat_interleave(f2)
            esrc = torch.cat([src1, src2])
            edst = torch.cat([dst1, dst2])
            val = torch.cat([v1.reshape(-1), v2.reshape(-1)])
            # both directions + padding to static ne_sub
            esrc2 = torch.cat([esrc, edst])
            edst2 = torch.cat([edst, esrc])
            val2 = torch.cat([val, val])
            pad = torch.full((ne_sub - esrc2.shape[0],), ghost,
                             dtype=torch.int32, device=dev)
            esrc2 = torch.cat([torch.where(val2, esrc2, ghost), pad])
            edst2 = torch.cat([torch.where(val2, edst2, ghost), pad])
            wsub = (esrc2 < ghost).float()
            return nodes, esrc2, edst2, wsub

        def loss(params, x_sub, esrc, edst, wsub, labels, pos_sub=None,
                 species_sub=None):
            if nequip:
                e = NQ.nequip_forward(params, species_sub, pos_sub, esrc,
                                      edst, cfg)
                return torch.mean((e[:Bn] - labels.float()) ** 2)
            out = fwd(params, x_sub, esrc, edst, wsub, cfg)
            return torch.mean(_ce_rows(out[:Bn], labels[:Bn]))

        def train_step(params, opt, draws, seeds, labels, row_offsets,
                       dst_full, feats):
            nodes, esrc, edst, wsub = make_subgraph(
                draws, seeds, row_offsets, dst_full)
            ghostf = torch.zeros((1, feats.shape[1]), dtype=feats.dtype,
                                 device=feats.device)
            x_sub = torch.cat([feats[nodes.long()], ghostf], dim=0)
            if nequip:
                pos_sub = x_sub[:, :3].float()
                species_sub = torch.cat([
                    (nodes % cfg.n_species).to(torch.int32),
                    torch.zeros((1,), dtype=torch.int32,
                                device=nodes.device)])
                data = (x_sub, esrc, edst, wsub, labels, pos_sub,
                        species_sub)
            else:
                data = (x_sub, esrc, edst, wsub, labels)
            l, g = value_and_grad(lambda p: loss(p, *data), params)
            params, opt, m = adamw_update(params, g, opt, opt_cfg)
            m["loss"] = l
            return params, opt, m

        args = (params_abs, _adamw_abs(params_abs),
                SDS((p1 + p2,), torch.int32),
                SDS((Bn,), torch.int32), SDS((Bn,), torch.int32),
                SDS((nv_full + 1,), torch.int32),
                SDS((ne_full,), torch.int32),
                SDS((nv_full, d_in), torch.float32))
        seed_sh = _named(mesh, rules, ("batch",), (Bn,))
        in_sh = (replicated(mesh, params_abs), replicated(mesh, args[1]),
                 rep, seed_sh, seed_sh, rep,
                 _named(mesh, rules, ("edges",), (ne_full,)),
                 _named(mesh, rules, ("batch", None), (nv_full, d_in)))
        fills = (lambda g, d: init(g, cfg, device=d), ZEROS,
                 randint(DRAW_HIGH), randint(N), randint(n_cls),
                 randint(ne_full), randint(nv_full), NORMAL)
        fl = _gnn_flops(spec, spec.config, P_nodes, ne_sub)
        return plan(args, in_sh, fl, fills, params_abs, train_step,
                    notes="sampler inside the step (draws as an input)")

    # full-graph training
    N, E = sh["n_nodes"], sh["n_edges"]
    d_in, n_cls = sh["d_feat"], sh["n_classes"]
    dp_total = sizes.get("pod", 1) * sizes["data"]
    nv = _round_up(N, dp_total * sizes["model"]) + 1
    ne = _round_up(E, flat)
    e_sh = _named(mesh, rules, ("edges",), (ne,))

    if spec.arch_id == "nequip":
        cfg = spec.config
        params_abs = eval_shape(NQ.init_nequip, torch.Generator(), cfg)

        def loss(params, species, pos, src, dst, y, mask):
            e = NQ.nequip_forward(params, species, pos, src, dst, cfg)
            return torch.sum(((e - y) ** 2) * mask) / torch.clamp(
                mask.sum(), min=1)

        node_sh = _named(mesh, rules, ("batch",), (nv,))
        args = (params_abs, _adamw_abs(params_abs),
                SDS((nv,), torch.int32), SDS((nv, 3), torch.float32),
                SDS((ne,), torch.int32), SDS((ne,), torch.int32),
                SDS((nv,), torch.float32), SDS((nv,), torch.float32))
        in_sh = (replicated(mesh, params_abs), replicated(mesh, args[1]),
                 node_sh, _named(mesh, rules, ("batch", None), (nv, 3)),
                 e_sh, e_sh, node_sh, node_sh)
        fills = (lambda g, d: NQ.init_nequip(g, cfg, device=d), ZEROS,
                 randint(cfg.n_species), NORMAL, randint(nv), randint(nv),
                 NORMAL, NORMAL)
        return plan(args, in_sh, _gnn_flops(spec, cfg, nv, ne), fills,
                    params_abs, _gnn_train(loss, opt_cfg))

    cfg, init, fwd = _gnn_model(spec, d_in, n_cls)
    params_abs = eval_shape(init, torch.Generator(), cfg)

    def loss(params, x, src, dst, w, y, mask):
        out = fwd(params, x, src, dst, w, cfg)
        return torch.sum(_ce_rows(out, y) * mask) / torch.clamp(
            mask.sum(), min=1)

    args = (params_abs, _adamw_abs(params_abs),
            SDS((nv, d_in), torch.float32),
            SDS((ne,), torch.int32), SDS((ne,), torch.int32),
            SDS((ne,), torch.float32),
            SDS((nv,), torch.int32), SDS((nv,), torch.float32))
    node_sh = _named(mesh, rules, ("batch", None), (nv, d_in))
    lab_sh = _named(mesh, rules, ("batch",), (nv,))
    in_sh = (replicated(mesh, params_abs), replicated(mesh, args[1]),
             node_sh, e_sh, e_sh, e_sh, lab_sh, lab_sh)
    fills = (lambda g, d: init(g, cfg, device=d), ZEROS, NORMAL,
             randint(nv), randint(nv), NORMAL, randint(n_cls), NORMAL)
    return plan(args, in_sh, _gnn_flops(spec, cfg, nv, ne), fills,
                params_abs, _gnn_train(loss, opt_cfg))


# --------------------------------------------------------------------------
# recsys cells
# --------------------------------------------------------------------------

def _bst_flops(cfg, batch):
    d = cfg.embed_dim
    s = cfg.seq_len + 1
    attn = 4 * s * d * d + 2 * s * s * d
    ffn = 2 * s * d * cfg.d_ff * 2
    flat = s * d + d + cfg.n_user_fields * d
    mlp_dims = [flat] + list(cfg.mlp) + [1]
    mlp = sum(2 * a * b for a, b in zip(mlp_dims[:-1], mlp_dims[1:]))
    return batch * float(cfg.n_blocks * (attn + ffn) + mlp)


def _recsys_cell(spec: ArchSpec, shape_name: str, mesh, rules) -> CellPlan:
    from repro_torch.models.recsys import bst as R

    cfg = spec.config
    sh = spec.shapes[shape_name]
    kind = sh["kind"]
    B = sh["batch"]
    hot = 3
    params_abs = eval_shape(R.init_bst, torch.Generator(), cfg)
    p_axes = R.param_logical_axes(cfg)
    p_shard = shard_tree(mesh, rules, p_axes, params_abs)

    def init(gen, device):
        return R.init_bst(gen, cfg, device=device)

    def batch_abs(n):
        return dict(
            user=SDS((n,), torch.int32),
            behavior=SDS((n, cfg.seq_len), torch.int32),
            target=SDS((n,), torch.int32),
            fields=SDS((n, cfg.n_user_fields, hot), torch.int32),
            label=SDS((n,), torch.int32),
        )

    def batch_shard(n):
        return tree_map(lambda s: _named(
            mesh, rules, ("batch",) + (None,) * (len(s.shape) - 1),
            s.shape), batch_abs(n))

    batch_fill = dict(user=randint(cfg.user_vocab),
                      behavior=randint(cfg.item_vocab),
                      target=randint(cfg.item_vocab),
                      fields=randint(cfg.user_field_vocab), label=randint(2))

    if kind == "train":
        opt_cfg = AdamWConfig(weight_decay=0.0, lr=1e-3)
        opt_abs = _adamw_abs(params_abs)
        o_shard = shard_tree(mesh, rules, _opt_axes(p_axes), opt_abs)

        def train_step(params, opt, batch):
            l, g = value_and_grad(lambda p: R.bst_loss(p, batch, cfg),
                                  params)
            params, opt, m = adamw_update(params, g, opt, opt_cfg)
            m["loss"] = l
            return params, opt, m

        args = (params_abs, opt_abs, batch_abs(B))
        in_sh = (p_shard, o_shard, batch_shard(B))
        out_sh = (p_shard, o_shard, _train_metrics(mesh))
        return CellPlan(spec.arch_id, shape_name, "train_step", train_step,
                        args, in_sh, out_sh, 3 * _bst_flops(cfg, B),
                        donate=(0, 1), fills=(init, ZEROS, batch_fill))

    if kind == "serve":
        @torch.no_grad()
        def serve_step(params, batch):
            return R.bst_forward(params, batch, cfg)

        b = batch_abs(B)
        b.pop("label")
        bs = batch_shard(B)
        bs.pop("label")
        fill = dict(batch_fill)
        fill.pop("label")
        out_sh = _named(mesh, rules, ("batch",), (B,))
        return CellPlan(spec.arch_id, shape_name, "serve_step", serve_step,
                        (params_abs, b), (p_shard, bs), out_sh,
                        _bst_flops(cfg, B), fills=(init, fill))

    # retrieval: 1 user x n_candidates
    NC = sh["n_candidates"]

    @torch.no_grad()
    def retrieval_step(params, query, candidates):
        return R.bst_score_candidates(params, query, candidates, cfg)

    query_abs = dict(
        user=SDS((), torch.int32),
        behavior=SDS((cfg.seq_len,), torch.int32),
        fields=SDS((cfg.n_user_fields, hot), torch.int32),
    )
    cand_abs = SDS((NC,), torch.int32)
    cand_sh = _named(mesh, rules, ("batch",), (NC,))
    fills = (init, dict(user=randint(cfg.user_vocab),
                        behavior=randint(cfg.item_vocab),
                        fields=randint(cfg.user_field_vocab)),
             randint(cfg.item_vocab))
    return CellPlan(spec.arch_id, shape_name, "retrieval_step",
                    retrieval_step, (params_abs, query_abs, cand_abs),
                    (p_shard, replicated(mesh, query_abs), cand_sh), cand_sh,
                    _bst_flops(cfg, NC), fills=fills)


# --------------------------------------------------------------------------
# louvain (graph family) cells — one distributed pass, one shard a rank
# --------------------------------------------------------------------------

class _Ranks:
    """The size of a mesh for :func:`build_community_step`, where the mesh
    is not a :class:`~repro_torch.launch.mesh.Mesh` of worker ranks: the
    plan's ``fn`` then has no ranks to run on and raises."""

    def __init__(self, size: int):
        self.size = size

    def start(self):
        raise RuntimeError("this community step was built on a mesh of "
                           f"{self.size} ranks without workers; build it on "
                           "a repro_torch.launch.mesh.Mesh to run it")


def _louvain_cell(spec: ArchSpec, shape_name: str, mesh, rules) -> CellPlan:
    """One GSP-Louvain pass.  The plan holds ``fn`` (the pass on a
    :class:`~repro_torch.launch.mesh.Mesh` of ranks, or one that raises on
    any other mesh), ``nv`` and ``n_shards`` (``extra``), the reference's
    abstract arguments and no shardings: the pass is a host loop over
    spawned ranks whose sweeps depend on the data, so the dry run cannot
    trace it and records its analytic ``model_flops`` instead."""
    from repro_torch.core.distributed import build_community_step
    from repro_torch.launch.mesh import Mesh

    sh = spec.shapes[shape_name]
    flat = mesh.size if isinstance(mesh, Mesh) else math.prod(
        mesh_axes(mesh).values())
    n_cap = _round_up(sh["n_nodes"], 1024)
    m_shard = _round_up(sh["n_edges"], flat) // flat
    plan = build_community_step(
        mesh if isinstance(mesh, Mesh) else _Ranks(flat), n_cap=n_cap,
        m_shard=m_shard, move_iters=4, split_iters=8, prune=False,
    )
    # edges-ops model: ~ local-move sorting + split + aggregate touch each
    # edge ~(move_iters + split_iters + 1) times with ~20 flops/edge
    fl = sh["n_edges"] * (4 + 8 + 1) * 20.0
    S = flat
    args = (SDS((S, m_shard), torch.int32), SDS((S, m_shard), torch.int32),
            SDS((S, m_shard), torch.float32), SDS((S,), torch.int32),
            SDS((S,), torch.int32), SDS((), torch.float32),
            SDS((), torch.int32))
    return CellPlan(spec.arch_id, shape_name, "community_step", plan["fn"],
                    args, None, None, fl,
                    notes="one GSP-Louvain pass (move+split+aggregate)",
                    extra=dict(nv=plan["nv"], n_shards=plan["n_shards"],
                               m_shard=m_shard))


def build_cell(spec: ArchSpec, shape_name: str, mesh,
               rules: Optional[ShardingRules] = None) -> CellPlan:
    rules = rules or ShardingRules()
    if spec.family == "lm":
        return _lm_cell(spec, shape_name, mesh, rules)
    if spec.family == "gnn":
        return _gnn_cell(spec, shape_name, mesh, rules)
    if spec.family == "recsys":
        return _recsys_cell(spec, shape_name, mesh, rules)
    if spec.family == "graph":
        return _louvain_cell(spec, shape_name, mesh, rules)
    raise KeyError(spec.family)
