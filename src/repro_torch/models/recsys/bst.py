"""BST — Behavior Sequence Transformer (Alibaba, arXiv:1905.06874), port of
``repro/models/recsys/bst.py``.

CTR model: the user's behavior sequence (seq_len=20 item ids) plus the
target item are embedded (huge sparse tables — the hot path), passed
through one transformer block (8 heads), flattened, concatenated with
user/context "other features" embeddings, and scored by a 1024-512-256 MLP.

Multi-hot user features use :func:`embedding_bag`, a gather plus a sum
over each bag's fixed ``K`` slots in which index -1 adds nothing (the
reference's ``take`` + segment sum).  ``bst_score_candidates`` is the
``retrieval_cand`` path: one user scored against ``N`` candidates as one
batched forward with the user's features broadcast.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import normal


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    item_vocab: int = 4_000_000
    user_vocab: int = 2_000_000
    n_user_fields: int = 8          # multi-hot user profile fields
    user_field_vocab: int = 100_000
    embed_dim: int = 32
    seq_len: int = 20               # behavior sequence length (excl. target)
    n_blocks: int = 1
    n_heads: int = 8
    d_ff: int = 64
    mlp: tuple = (1024, 512, 256)
    dropout: float = 0.0


def init_bst(gen: torch.Generator, cfg: BSTConfig, *, device=None):
    d = cfg.embed_dim
    dev = device if device is not None else gen.device
    seq_total = cfg.seq_len + 1
    flat = seq_total * d + d + cfg.n_user_fields * d
    mlp_dims = [flat] + list(cfg.mlp) + [1]

    def rnd(*shape):
        return normal(gen, shape, device=device)

    mlp = [dict(w=rnd(mlp_dims[i], mlp_dims[i + 1])
                * (1.0 / math.sqrt(mlp_dims[i])),
                b=torch.zeros((mlp_dims[i + 1],), dtype=torch.float32,
                              device=dev))
           for i in range(len(mlp_dims) - 1)]
    s = 1.0 / math.sqrt(d)
    blocks = [dict(
        wq=rnd(d, d) * s, wk=rnd(d, d) * s, wv=rnd(d, d) * s,
        wo=rnd(d, d) * s, w1=rnd(d, cfg.d_ff) * s,
        w2=rnd(cfg.d_ff, d) * (1.0 / math.sqrt(cfg.d_ff)),
        ln1=torch.ones((d,), dtype=torch.float32, device=dev),
        ln2=torch.ones((d,), dtype=torch.float32, device=dev),
    ) for _ in range(cfg.n_blocks)]
    return dict(
        item_table=rnd(cfg.item_vocab, d) * 0.03,
        user_table=rnd(cfg.user_vocab, d) * 0.03,
        field_table=rnd(cfg.n_user_fields * cfg.user_field_vocab, d) * 0.03,
        pos_embed=rnd(seq_total, d) * 0.03,
        blocks=blocks,
        mlp=mlp,
    )


def param_logical_axes(cfg: BSTConfig):
    block = dict(wq=(None, "heads"), wk=(None, "heads"), wv=(None, "heads"),
                 wo=("heads", None), w1=(None, "mlp"), w2=("mlp", None),
                 ln1=(None,), ln2=(None,))
    return dict(
        item_table=("rows", None),
        user_table=("rows", None),
        field_table=("rows", None),
        pos_embed=(None, None),
        blocks=[block] * cfg.n_blocks,
        mlp=[dict(w=("fsdp", "mlp"), b=(None,))] * (len(cfg.mlp) + 1),
    )


def embedding_bag(table, indices, offsets=None, mode="sum"):
    """EmbeddingBag: gather + sum over each bag.

    indices: int[..., K] (fixed K entries per bag, padded with -1) ->
    [..., D].  ``mode='mean'`` divides by the bag's valid count (at least
    1).  ``offsets`` is the reference's unused argument."""
    valid = indices >= 0
    idx = torch.clamp(indices, min=0).long()
    emb = table[idx] * valid[..., None]
    out = emb.sum(dim=-2)
    if mode == "mean":
        out = out / torch.clamp(valid.sum(-1, keepdim=True), min=1)
    return out


def _ln(x, g, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g


def _block(bp, x, n_heads):
    b, s, d = x.shape
    dh = d // n_heads
    h = _ln(x, bp["ln1"])
    q = (h @ bp["wq"]).reshape(b, s, n_heads, dh)
    k = (h @ bp["wk"]).reshape(b, s, n_heads, dh)
    v = (h @ bp["wv"]).reshape(b, s, n_heads, dh)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    a = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, s, d)
    x = x + o @ bp["wo"]
    h2 = _ln(x, bp["ln2"])
    return x + torch.relu(h2 @ bp["w1"]) @ bp["w2"]


def _encode_sequence(params, behavior, target, cfg: BSTConfig):
    """behavior: int[B, S], target: int[B] -> [B, (S+1)*D]."""
    seq = torch.cat([behavior, target[:, None]], dim=1).long()
    x = params["item_table"][seq] + params["pos_embed"][None]
    for bp in params["blocks"]:
        x = _block(bp, x, cfg.n_heads)
    return x.reshape(x.shape[0], -1)


def bst_forward(params, batch, cfg: BSTConfig):
    """batch: dict(user int[B], behavior int[B,S], target int[B],
    fields int[B, F, K]) -> CTR logits [B]."""
    seq_flat = _encode_sequence(params, batch["behavior"], batch["target"],
                                cfg)
    user = params["user_table"][batch["user"].long()]
    # per-field offset into the concatenated field table
    f = cfg.n_user_fields
    fields = batch["fields"]
    offs = (torch.arange(f, dtype=fields.dtype, device=fields.device)
            * cfg.user_field_vocab)[None, :, None]
    fields = fields + torch.where(fields >= 0, offs, 0)
    bags = embedding_bag(params["field_table"], fields)   # [B, F, D]
    bags = bags.reshape(bags.shape[0], -1)
    h = torch.cat([seq_flat, user, bags], dim=-1)
    for i, lp in enumerate(params["mlp"]):
        h = h @ lp["w"] + lp["b"]
        if i < len(params["mlp"]) - 1:
            h = F.leaky_relu(h)
    return h[:, 0]


def bst_loss(params, batch, cfg: BSTConfig):
    """Binary cross-entropy on CTR labels."""
    logits = bst_forward(params, batch, cfg)
    y = batch["label"].float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def bst_score_candidates(params, batch, candidates, cfg: BSTConfig):
    """Retrieval scoring: one query user vs [N] candidate items.

    ``batch``: dict(user int[], behavior int[S], fields int[F, K]); each
    candidate takes the target slot of one row of a batched forward."""
    n = candidates.shape[0]
    b = dict(
        user=batch["user"].expand(n),
        behavior=batch["behavior"].expand(n, cfg.seq_len),
        target=candidates,
        fields=batch["fields"][None].expand(
            (n,) + tuple(batch["fields"].shape)),
    )
    return bst_forward(params, b, cfg)
