"""AdamW with decoupled weight decay + global-norm gradient clipping (port
of ``repro/optim/adamw.py``).

State is a tree mirroring params, ``dict(m=..., v=..., step=...)``: ``m``
and ``v`` in float32, ``step`` an int32 scalar, the reference's layout, so
either package restores the other's optimiser checkpoints.  The update is
functional, as the reference's: it returns new tensors and leaves its
arguments as they were.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return dict(
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm of all leaves together: each leaf's sum of
    squares, added leaf by leaf in tree order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step. Returns (new_params, new_state, metrics).

    ``grads`` mirrors ``params``; ``lr_scale`` is a float or a 0-dim
    tensor (a schedule's value)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state["step"] + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                           for i in range(3))
    metrics = dict(grad_norm=gnorm,
                   lr=torch.as_tensor(lr, dtype=torch.float32))
    return new_p, dict(m=new_m, v=new_v, step=step), metrics
