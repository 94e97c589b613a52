"""End-to-end training driver (port of ``repro/launch/train.py``).

Wires every layer together: config registry -> model -> data stream ->
AdamW -> checkpointing (async, keep-k, atomic, the reference's format) ->
fault handling (a non-finite loss rolls back to the last checkpoint).
Runs on CUDA unless ``--device cpu`` is given.

Usage:
  python -m repro_torch.launch.train --arch smollm-360m --smoke --steps 200
  python -m repro_torch.launch.train --arch bst --smoke --steps 300
  python -m repro_torch.launch.train --arch gcn-cora --smoke --steps 200
  python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \\
      --steps 100 --ckpt-dir ck --resume --device cpu

Without ``--smoke`` the published config is trained (on one card: a few
steps at small batch are what fits).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_spec
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.data import recsys_stream, token_stream
from repro_torch.device import resolve_device
from repro_torch.optim import (
    AdamWConfig, adamw_init, adamw_update, warmup_cosine,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _finite(tree) -> bool:
    return all(bool(torch.all(torch.isfinite(x))) for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor) and x.is_floating_point())


def value_and_grad(loss_of, params):
    """``(loss, grads)`` of the scalar ``loss_of(params)``, the gradients
    a tree like ``params`` (the reference's ``jax.value_and_grad``; a
    leaf the loss does not read gets zeros).  Records under
    ``torch.enable_grad()``, whatever the caller's grad mode."""
    p = tree_map(lambda x: x.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_of(p)
        leaves = tree_leaves(p)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if gr is None else gr
             for x, gr in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _report(on_step, i, loss, m):
    if on_step is not None:
        on_step(i, dict(loss=float(loss), grad_norm=float(m["grad_norm"])))


def train_lm(cfg, steps, batch, seq_len, ckpt: CheckpointManager | None,
             resume: bool, log_every: int = 10, *, device=None,
             on_step=None):
    """Train the LM ``cfg`` on the Markov token stream for ``steps`` steps
    on ``device`` (``None`` = CUDA); returns the losses.  A checkpoint
    every 50 steps and at the end; ``resume`` restarts from the latest.
    ``on_step(i, dict(loss, grad_norm))`` sees each step's metrics."""
    from repro_torch.models import transformer as T

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg, device=dev)
    opt = adamw_init(params)
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.01)
    start = 0
    if ckpt and resume:
        restored, step = ckpt.restore_latest(dict(params=params, opt=opt),
                                             device=dev)
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start = step
            print(f"resumed from step {step}")

    def step_fn(params, opt, tokens, targets):
        loss, grads = value_and_grad(
            lambda p: T.loss_fn(p, tokens, targets, cfg), params)
        lr = warmup_cosine(opt["step"], warmup=20, total=max(steps, 100))
        params, opt, m = adamw_update(params, grads, opt, opt_cfg, lr)
        m["loss"] = loss
        return params, opt, m

    stream = token_stream(cfg.vocab, batch, seq_len, device=dev)
    losses = []
    t0 = time.time()
    for i, (tokens, targets) in enumerate(stream):
        if i < start:
            continue
        if i >= steps:
            break
        params_new, opt_new, m = step_fn(params, opt, tokens, targets)
        if not np.isfinite(float(m["loss"])):
            print(f"step {i}: non-finite loss — rolling back")
            if ckpt:
                restored, step = ckpt.restore_latest(
                    dict(params=params, opt=opt), device=dev)
                if restored is not None:
                    params, opt = restored["params"], restored["opt"]
                    continue
            raise FloatingPointError("non-finite loss, no checkpoint")
        params, opt = params_new, opt_new
        losses.append(float(m["loss"]))
        _report(on_step, i, losses[-1], m)
        if i % log_every == 0:
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"({(time.time() - t0):.1f}s)")
        if ckpt and i > 0 and i % 50 == 0:
            ckpt.save(i, dict(params=params, opt=opt))
    if ckpt:
        ckpt.save(steps, dict(params=params, opt=opt))
        ckpt.wait()
    return losses


def train_recsys(cfg, steps, batch, ckpt, resume, log_every=20, *,
                 device=None, on_step=None):
    """Train BST ``cfg`` on the recsys stream on ``device`` (``None`` =
    CUDA); returns the losses.  ``ckpt`` and ``resume`` are taken and
    unused, as in the reference."""
    from repro_torch.models import recsys as R

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = R.init_bst(gen, cfg, device=dev)
    opt = adamw_init(params)
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.0)

    losses = []
    for i, b in enumerate(recsys_stream(cfg, batch, device=dev)):
        if i >= steps:
            break
        loss, grads = value_and_grad(lambda p: R.bst_loss(p, b, cfg), params)
        params, opt, m = adamw_update(params, grads, opt, opt_cfg)
        losses.append(float(loss))
        _report(on_step, i, losses[-1], m)
        if i % log_every == 0:
            print(f"step {i:5d} loss {losses[-1]:.4f}")
    return losses


def gnn_problem(spec, *, full: bool = False, device=None):
    """The GNN training problem of ``spec`` on ``device`` (``None`` =
    CUDA): ``(cfg, graph, labels, x, mask)``.  The smoke problem is the
    reference's (``sbm_graph(300, 4, 0.3, 0.01, seed=1)``, the smoke
    config); ``full`` takes the published config on Cora's shape from
    ``GNN_SHAPES['full_graph_sm']`` (2,708 vertices in 7 planted blocks,
    about 10.8k directed edges, d_in and classes from the shape where the
    config has them)."""
    from repro_torch.graph import sbm_graph

    dev = resolve_device(device)
    if full:
        shape = GNN_SHAPES["full_graph_sm"]
        g, blocks = sbm_graph(n_nodes=shape["n_nodes"],
                              n_blocks=shape["n_classes"], p_in=0.008,
                              p_out=0.0004, seed=1, device=dev)
        cfg = spec.config
        swap = {k: shape[v] for k, v in (("d_in", "d_feat"),
                                          ("n_classes", "n_classes"))
                if hasattr(cfg, k)}
        cfg = dataclasses.replace(cfg, **swap)
    else:
        g, blocks = sbm_graph(n_nodes=300, n_blocks=4, p_in=0.3, p_out=0.01,
                              seed=1, device=dev)
        cfg = spec.smoke
    n_classes = getattr(cfg, "n_classes", 4)
    labels = np.zeros(g.nv, np.int64)
    labels[: len(blocks)] = blocks % n_classes
    labels = torch.from_numpy(labels).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    d_in = getattr(cfg, "d_in", 12)
    x = torch.randn((g.nv, d_in), generator=gen, device=dev) * 0.1
    # make features weakly label-informative
    x[torch.arange(g.nv, device=dev), labels % d_in] += 1.0
    mask = g.node_mask().float()
    return cfg, g, labels, x, mask


def train_gnn(spec, steps, ckpt, resume, log_every=20, *, full: bool = False,
              device=None, on_step=None):
    """Train the GNN of ``spec`` on :func:`gnn_problem` (``full``: the
    published config at Cora's shape) on ``device`` (``None`` = CUDA);
    returns the losses.  ``ckpt`` and ``resume`` are taken and unused, as
    in the reference."""
    import repro_torch.models.gnn as G

    dev = resolve_device(device)
    cfg, g, labels, x, mask = gnn_problem(spec, full=full, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    if spec.arch_id == "nequip":
        pos = torch.randn((g.nv, 3), generator=gen, device=dev)
        species = labels % cfg.n_species
        params = G.init_nequip(gen, cfg, device=dev)

        def loss_fn(p):
            e = G.nequip_forward(p, species, pos, g.src, g.dst, cfg)
            return torch.sum((e - labels.float()) ** 2 * mask) / mask.sum()
    else:
        if spec.arch_id.startswith("gcn"):
            init, fwd = G.init_gcn, lambda p: G.gcn_forward(
                p, x, g.src, g.dst, cfg)
        elif spec.arch_id.startswith("gatedgcn"):  # before 'gat' (prefix!)
            init, fwd = G.init_gatedgcn, lambda p: G.gatedgcn_forward(
                p, x, g.src, g.dst, g.w, cfg)
        else:
            init, fwd = G.init_gat, lambda p: G.gat_forward(
                p, x, g.src, g.dst, cfg)
        params = init(gen, cfg, device=dev)

        def loss_fn(p):
            out = fwd(p)
            logz = torch.logsumexp(out, -1)
            gold = torch.gather(out, -1, labels[:, None])[:, 0]
            return torch.sum((logz - gold) * mask) / mask.sum()

    opt = adamw_init(params)
    opt_cfg = AdamWConfig(lr=5e-3, weight_decay=0.0)
    losses = []
    for i in range(steps):
        loss, grads = value_and_grad(loss_fn, params)
        params, opt, m = adamw_update(params, grads, opt, opt_cfg)
        losses.append(float(loss))
        _report(on_step, i, losses[-1], m)
        if i % log_every == 0:
            print(f"step {i:5d} loss {losses[-1]:.4f}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    spec = get_spec(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    if spec.family == "lm":
        losses = train_lm(cfg, args.steps, args.batch, args.seq_len,
                          ckpt, args.resume, device=args.device)
    elif spec.family == "recsys":
        losses = train_recsys(cfg, args.steps, args.batch, ckpt, args.resume,
                              device=args.device)
    elif spec.family == "gnn":
        losses = train_gnn(spec, args.steps, ckpt, args.resume,
                           full=not args.smoke, device=args.device)
    else:
        raise SystemExit("use examples/torch_quickstart.py for the louvain "
                         "arch")
    k = max(len(losses) // 10, 1)
    print(f"first-10 mean {np.mean(losses[:k]):.4f} -> "
          f"last-10 mean {np.mean(losses[-k:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
