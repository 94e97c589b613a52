"""Decoder-only LM transformer: GQA + RoPE, SWA, SwiGLU, top-k MoE, KV cache
(port of ``repro/models/transformer.py``).

Covers the five LM architectures of the configs (mixtral-8x7b/-8x22b,
command-r-35b, smollm-360m, tinyllama-1.1b) from one config dataclass.

* Parameters keep the reference's tree: layers **stacked** on axis 0
  (``[L, ...]`` leaves), float32 masters cast to ``compute_dtype`` in the
  forward pass, so either package reads the other's checkpoints.
  ``scan_layers`` has no scan here: both settings run one loop over the
  stacked leaves and give one result.
* ``remat`` is ``torch.utils.checkpoint`` around each layer, applied only
  where autograd records; ``remat_policy='dots'`` saves the plain matrix
  products (``aten.mm``) and recomputes the rest, as JAX's
  ``dots_with_no_batch_dims_saveable``.
* Attention is **online-softmax KV chunking** (``attn_impl='chunked'``,
  peak score memory ``[B, Hkv, G, chunk, chunk]``, each kv block
  recomputed in the backward pass) or the hand-written flash kernel
  (``attn_impl='flash'``: :func:`repro_torch.kernels.ops.flash_attention`,
  ``csrc/flash_attn.cu`` on the card).  Flash is forward only, as in the
  reference: called where autograd records, it raises.
* Decode uses a **rolling KV cache** bounded by the sliding window.
  :func:`decode_step` writes the new key and value into the cache in place
  (the reference returns a new cache): the cache is the largest tensor of
  serving, and no caller keeps the old one.
* MoE is sort-based dispatch (tokens sorted by expert, capacity-bounded,
  renormalized top-k combine).  ``torch.topk`` and ``jax.lax.top_k`` may
  order equal probabilities differently; random routers have no ties.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as tckpt

from repro_torch.device import resolve_device
from repro_torch.models import normal


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 2
    d_head: int = 32
    d_ff: int = 512
    vocab: int = 1024
    # MoE (None -> dense SwiGLU)
    n_experts: Optional[int] = None
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_dropless: bool = False      # serving: capacity = T (no token drops)
    # attention
    sliding_window: Optional[int] = None
    rope_theta: float = 1e4
    attn_chunk: int = 1024          # query/kv chunk for online softmax
    attn_impl: str = "chunked"      # chunked | flash (the CUDA kernel;
                                    # forward-only -> serving/prefill paths)
    # numerics
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"      # full | dots  (dots: save matmul outputs)
    scan_layers: bool = True        # kept for the reference's configs; one loop
    tie_embeddings: bool = False

    @property
    def d_q(self) -> int:
        return self.n_heads * self.d_head

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def is_moe(self) -> bool:
        return self.n_experts is not None

    def cache_len(self, seq_len: int) -> int:
        if self.sliding_window is not None:
            return min(seq_len, self.sliding_window)
        return seq_len

    def param_count(self) -> int:
        """Total parameters (for 6ND roofline accounting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.d_q + 2 * d * self.d_kv + self.d_q * d
        if self.is_moe:
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            mlp = 3 * d * f
        per_layer = attn + mlp + 2 * d
        head = 0 if self.tie_embeddings else d * v
        return v * d + self.n_layers * per_layer + d + head

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        return self.param_count() - self.n_layers * (
            self.n_experts - self.top_k) * 3 * d * f


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: LMConfig, *, device=None):
    """The reference's parameter tree in float32, drawn from ``gen`` on its
    device and placed on ``device`` (default: the generator's)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    L = cfg.n_layers
    dev = device if device is not None else gen.device

    def norm(*shape, scale=None):
        if scale is None:
            scale = 1.0 / math.sqrt(shape[-2] if len(shape) > 1 else d)
        return normal(gen, shape, device=device) * scale

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    layers = dict(
        ln1=ones(L, d),
        ln2=ones(L, d),
        wq=norm(L, d, cfg.d_q),
        wk=norm(L, d, cfg.d_kv),
        wv=norm(L, d, cfg.d_kv),
        wo=norm(L, cfg.d_q, d),
    )
    if cfg.is_moe:
        E = cfg.n_experts
        layers.update(
            gate=norm(L, d, E),
            w1=norm(L, E, d, f),
            w3=norm(L, E, d, f),
            w2=norm(L, E, f, d, scale=f ** -0.5),
        )
    else:
        layers.update(
            w1=norm(L, d, f),
            w3=norm(L, d, f),
            w2=norm(L, f, d, scale=f ** -0.5),
        )
    params = dict(
        embed=norm(v, d, scale=1.0),
        layers=layers,
        final_norm=ones(d),
    )
    if not cfg.tie_embeddings:
        params["lm_head"] = norm(d, v)
    return params


def param_logical_axes(cfg: LMConfig):
    """The logical axes of :func:`init_params`' leaves (the reference's
    tree, for :mod:`repro_torch.distributed.sharding`)."""
    layers = dict(
        ln1=("stack", None),
        ln2=("stack", None),
        wq=("stack", "fsdp", "heads"),
        wk=("stack", "fsdp", "heads"),
        wv=("stack", "fsdp", "heads"),
        wo=("stack", "heads", "fsdp"),
    )
    if cfg.is_moe:
        # the experts dim stays unsharded where E does not divide 'model';
        # expert matrices shard 2-D: D over fsdp, F over model
        layers.update(
            gate=("stack", "fsdp", None),
            w1=("stack", "experts", "fsdp", "mlp"),
            w3=("stack", "experts", "fsdp", "mlp"),
            w2=("stack", "experts", "mlp", "fsdp"),
        )
    else:
        layers.update(
            w1=("stack", "fsdp", "mlp"),
            w3=("stack", "fsdp", "mlp"),
            w2=("stack", "mlp", "fsdp"),
        )
    axes = dict(
        embed=("vocab", "fsdp"),
        layers=layers,
        final_norm=(None,),
    )
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("fsdp", "vocab")
    return axes


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

def rmsnorm(x, g, eps=1e-6):
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * g.to(x.dtype)


def rope(x, positions, theta):
    """x: [B, S, H, Dh]; positions: [B, S] or [S]."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq          # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def _kv_step(qb, kb, vb, m, l, acc, qp, kp, window, scale):
    """One kv block of the online softmax (float32 scores and sums)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb.float(), kb.float()) * scale
    mask = kp[None, :] <= qp[:, None]
    if window is not None:
        mask = mask & ((qp[:, None] - kp[None, :]) < window)
    s = torch.where(mask, s, -math.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    fin = torch.isfinite(m)
    corr = torch.exp(torch.where(fin, m - m_safe, -math.inf))
    corr = torch.where(fin, corr, 0.0)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vb.float())
    return m_new, l_new, acc * corr[..., None] + pv


def _attend_chunked(q, k, v, q_pos, k_pos, window, chunk):
    """Online-softmax attention. q: [B,Sq,Hkv,G,Dh], k/v: [B,Sk,Hkv,Dh].

    q_pos [Sq], k_pos [Sk] are absolute positions (causal + window masks
    are computed from them, so the same code serves train, prefill, and
    rolling-cache decode).  Memory peak: [B, Hkv, G, chunk_q, chunk_k];
    where autograd records, each kv block is recomputed in the backward
    pass, so the score tiles are never saved.  Returns float32
    ``[B, Sq, Hkv*G*Dh]``."""
    b, sq, hkv, g, dh = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    cq = min(chunk, sq)
    ck = min(chunk, sk)
    if sq % cq or sk % ck:
        raise ValueError(f"sequence lengths {sq}, {sk} are not multiples "
                         f"of the attention chunk {chunk}")
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for i0 in range(0, sq, cq):
        qb, qp = q[:, i0:i0 + cq], q_pos[i0:i0 + cq]
        m = torch.full((b, hkv, g, cq), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, cq, dh), dtype=torch.float32,
                          device=q.device)
        for j0 in range(0, sk, ck):
            args = (qb, k[:, j0:j0 + ck], v[:, j0:j0 + ck], m, l, acc, qp,
                    k_pos[j0:j0 + ck], window, scale)
            if remat:
                m, l, acc = tckpt.checkpoint(_kv_step, *args,
                                             use_reentrant=False)
            else:
                m, l, acc = _kv_step(*args)
        outs.append(acc / torch.clamp(l[..., None], min=1e-9))
    out = torch.cat(outs, dim=3)                       # [B, Hkv, G, Sq, Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hkv * g * dh)


def attention(lp, x, cfg: LMConfig, positions, kv=None):
    """Self-attention. If ``kv=(k_cache, v_cache, k_pos)`` attends to the
    cache (decode); otherwise to ``x`` itself (train/prefill).  Returns
    ``(out, (k, v))``, the second ``None`` with a cache."""
    b, s, _ = x.shape
    hkv, g, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    dt = cfg.compute_dtype
    q = (x @ lp["wq"].to(dt)).reshape(b, s, hkv, g, dh)
    k = (x @ lp["wk"].to(dt)).reshape(b, s, hkv, dh)
    v = (x @ lp["wv"].to(dt)).reshape(b, s, hkv, dh)
    q = rope(q.reshape(b, s, hkv * g, dh), positions, cfg.rope_theta)
    q = q.reshape(b, s, hkv, g, dh)
    k = rope(k, positions, cfg.rope_theta)
    if kv is None:
        if cfg.attn_impl == "flash":
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in (q, k, v)):
                raise RuntimeError(
                    "attn_impl='flash' is forward only; train with "
                    "attn_impl='chunked' or run under torch.no_grad()")
            from repro_torch.kernels import ops as kops
            out = kops.flash_attention(
                q.reshape(b, s, hkv * g, dh), k, v,
                causal=True, window=cfg.sliding_window,
            ).reshape(b, s, hkv * g * dh)
        elif cfg.attn_impl == "chunked":
            out = _attend_chunked(q, k, v, positions, positions,
                                  cfg.sliding_window, cfg.attn_chunk)
        else:
            raise ValueError(f"attn_impl must be 'chunked' or 'flash', got "
                             f"{cfg.attn_impl!r}")
        new_kv = (k, v)
    else:
        k_cache, v_cache, k_pos = kv
        out = _attend_chunked(
            q, k_cache, v_cache,
            positions if positions.dim() == 1 else positions[0],
            k_pos, cfg.sliding_window, cfg.attn_chunk,
        )
        new_kv = None
    return out.to(dt) @ lp["wo"].to(dt), new_kv


def swiglu(lp, x, dt):
    h = F.silu(x @ lp["w1"].to(dt)) * (x @ lp["w3"].to(dt))
    return h @ lp["w2"].to(dt)


def moe_mlp(lp, x, cfg: LMConfig, constrain=None):
    """Grouped sort-based top-k MoE with per-group capacity.

    GShard-style groups: each batch row routes its own tokens with local
    capacity ``ceil(cf * K * S / E)`` (``S`` with ``moe_dropless``).  A
    token's top-k experts are sorted by a stable argsort on the expert id;
    a token past its expert's capacity is dropped (its slot is the dump row
    ``E * cap``).  Every dispatch and combine op works along dim 1 of a
    ``[B, ...]`` tensor, one group a batch row, so a batch-sharded ``x``
    stays shard-local; ``constrain`` (the step builder's) holds the
    ``[B, E, cap, *]`` buffers batch-sharded, as the reference's does."""
    b, s, d = x.shape
    dt = cfg.compute_dtype
    E, K = cfg.n_experts, cfg.top_k
    if cfg.moe_dropless:
        cap = s                      # worst-case skew: no drops (serving)
    else:
        cap = min(max(-(-int(cfg.capacity_factor * K * s) // E), 1), s)
    dev = x.device

    logits = (x @ lp["gate"].to(dt)).float()                  # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    topv, tope = torch.topk(probs, K, dim=-1)                 # [B, S, K]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    flat_e = tope.reshape(b, s * K)
    flat_t = torch.arange(s, device=dev).repeat_interleave(K)  # [S*K]
    flat_w = topv.reshape(b, s * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = torch.gather(flat_t.expand(b, -1), 1, order)          # [B, S*K]
    sw = torch.gather(flat_w, 1, order)
    start = torch.searchsorted(
        se, torch.arange(E, device=dev).expand(b, E).contiguous())
    pos = torch.arange(s * K, device=dev) - torch.gather(start, 1, se)
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, E * cap)         # dropped -> tail
    xs = torch.gather(x, 1, st[..., None].expand(-1, -1, d))
    # kept slots are distinct; every dropped token writes zeros to the dump
    buf = torch.zeros((b, E * cap + 1, d), dtype=dt, device=dev).scatter(
        1, slot[..., None].expand(-1, -1, d), xs * keep[..., None].to(dt))
    h = buf[:, : E * cap].reshape(b, E, cap, d)
    if constrain is not None:
        h = constrain(h)

    up = F.silu(torch.einsum("gecd,edf->gecf", h, lp["w1"].to(dt))) \
        * torch.einsum("gecd,edf->gecf", h, lp["w3"].to(dt))
    if constrain is not None:
        up = constrain(up)
    down = torch.einsum("gecf,efd->gecd", up, lp["w2"].to(dt))
    if constrain is not None:
        down = constrain(down)

    flat = torch.cat([down.reshape(b, E * cap, d),
                      torch.zeros((b, 1, d), dtype=dt, device=dev)], dim=1)
    contrib = torch.gather(flat, 1, slot[..., None].expand(-1, -1, d)) \
        * (sw * keep)[..., None].to(dt)
    return torch.zeros((b, s, d), dtype=dt, device=dev).scatter_add(
        1, st[..., None].expand(-1, -1, d), contrib)


def _layer(lp, x, cfg: LMConfig, positions, kv=None, constrain=None):
    h, new_kv = attention(lp, rmsnorm(x, lp["ln1"]), cfg, positions, kv)
    x = x + h
    h2 = rmsnorm(x, lp["ln2"])
    if cfg.is_moe:
        x = x + moe_mlp(lp, h2, cfg, constrain)
    else:
        x = x + swiglu(lp, h2, cfg.compute_dtype)
    if constrain is not None:
        x = constrain(x)
    return x, new_kv


def _save_dots(ctx, op, *args, **kwargs):
    """The ``'dots'`` remat policy: keep plain matrix products, recompute
    everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return tckpt.CheckpointPolicy.MUST_SAVE
    return tckpt.CheckpointPolicy.PREFER_RECOMPUTE


def layer_params(layers, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer leaves."""
    return {k: a[i] for k, a in layers.items()}


def _head(params, x, dt):
    x = rmsnorm(x, params["final_norm"])
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return (x @ head.to(dt)).float()


# --------------------------------------------------------------------------
# public forward passes
# --------------------------------------------------------------------------

def forward(params, tokens, cfg: LMConfig, constrain=None, *,
            return_kv: bool = False):
    """Train/prefill forward. tokens: int[B, S] -> float32 logits
    [B, S, V].  With ``return_kv`` also each layer's rotated keys and
    values, ``[(k, v)]`` of ``[B, S, Hkv, Dh]`` (:func:`prefill`).
    ``constrain`` (or ``None``) maps the activations after the embedding
    and after each layer: the step builder's batch-sharding constraint.
    The layers run in a Python loop, so a trace sees every layer."""
    b, s = tokens.shape
    dt = cfg.compute_dtype
    x = params["embed"].to(dt)[tokens.long()]
    if constrain is not None:
        x = constrain(x)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    names = sorted(params["layers"])
    kvs = []

    def body(h, *leaves):
        return _layer(dict(zip(names, leaves)), h, cfg, positions,
                      constrain=constrain)[0]

    remat = cfg.remat and torch.is_grad_enabled() and not return_kv
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        if remat:
            kw = {}
            if cfg.remat_policy == "dots":
                kw["context_fn"] = functools.partial(
                    tckpt.create_selective_checkpoint_contexts, _save_dots)
            x = tckpt.checkpoint(body, x, *(lp[n] for n in names),
                                 use_reentrant=False, **kw)
        else:
            x, kv = _layer(lp, x, cfg, positions, constrain=constrain)
            if return_kv:
                kvs.append(kv)
    logits = _head(params, x, dt)
    return (logits, kvs) if return_kv else logits


def loss_fn(params, tokens, targets, cfg: LMConfig, constrain=None):
    """Next-token cross-entropy (mean over tokens).  The gold logit is
    picked by a mask over the vocabulary, not a gather: the same value and
    gradient, and on a DTensor its backward keeps the logits' sharding
    (a gather's backward scatters into zeros of the logits' global shape,
    which DTensor replicates on every device)."""
    logits = forward(params, tokens, cfg, constrain)
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(vocab == targets.long()[..., None], logits,
                       0.0).sum(dim=-1)
    return torch.mean(logz - gold)


# ---- serving -------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, seq_len: int, *, device=None):
    """Allocate the KV cache for decode at context length ``seq_len`` on
    ``device`` (``None`` = CUDA).

    SWA models use a rolling buffer bounded by the window: the 524k-token
    long-context cell costs the same cache as a 4k one.
    """
    dev = resolve_device(device)
    cl = cfg.cache_len(seq_len)
    shape = (cfg.n_layers, batch, cl, cfg.n_kv_heads, cfg.d_head)
    return dict(
        k=torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        pos=torch.full((cfg.n_layers, batch, cl), -1, dtype=torch.int32,
                       device=dev),
        t=torch.tensor(seq_len, dtype=torch.int32, device=dev),
    )


@torch.no_grad()
def prefill(params, tokens, cfg: LMConfig, seq_len: int):
    """Prefill through :func:`forward` (flash or chunked, as ``cfg``
    says): ``(logits [B, S, V], cache)`` with the cache of
    :func:`init_cache` at context ``seq_len`` holding the prompt's keys and
    values in their rolling slots (the last ``cache_len`` positions), its
    ``t`` the prompt's length, ready for :func:`decode_step`."""
    b, s = tokens.shape
    logits, kvs = forward(params, tokens, cfg, return_kv=True)
    cache = init_cache(cfg, b, seq_len, device=tokens.device)
    cl = cache["k"].shape[2]
    keep = torch.arange(max(s - cl, 0), s, device=tokens.device)
    slot = keep % cl
    for i, (k, v) in enumerate(kvs):
        cache["k"][i][:, slot] = k[:, keep]
        cache["v"][i][:, slot] = v[:, keep]
        cache["pos"][i][:, slot] = keep.to(torch.int32)
    cache["t"].fill_(s)
    return logits, cache


def _write_slot(buf, slot: int, val):
    """``buf[:, slot] = val`` in place.  A DTensor ``buf`` (the step
    builder's cache, sharded along its length) is written in the one local
    shard that holds the slot
    (:func:`repro_torch.distributed.dtensor_rules.write_slot`)."""
    from torch.distributed.tensor import DTensor

    if isinstance(buf, DTensor):
        from repro_torch.distributed.dtensor_rules import write_slot

        write_slot(buf, 1, slot, val)
    else:
        buf[:, slot] = val


def decode_step(params, cache, tokens, cfg: LMConfig, *, t=None):
    """One decode step. tokens: int[B] -> (logits [B, V], cache).

    Writes the step's key, value and position into ``cache`` in place and
    advances its ``t``; returns the same cache.  ``t``: the step's
    position where the caller knows it without reading ``cache['t']``
    (a trace over fake tensors, whose values cannot be read)."""
    b = tokens.shape[0]
    dt = cfg.compute_dtype
    t = int(cache["t"]) if t is None else int(t)
    x = params["embed"].to(dt)[tokens.long()][:, None, :]     # [B, 1, D]
    positions = torch.full((b, 1), t, dtype=torch.int32, device=x.device)
    cl = cache["k"].shape[2]
    slot = t % cl                                            # rolling slot
    hkv, g, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head

    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        kc, vc, pc = cache["k"][i], cache["v"][i], cache["pos"][i]
        h1 = rmsnorm(x, lp["ln1"])
        q = (h1 @ lp["wq"].to(dt)).reshape(b, 1, hkv, g, dh)
        k = (h1 @ lp["wk"].to(dt)).reshape(b, 1, hkv, dh)
        v = (h1 @ lp["wv"].to(dt)).reshape(b, 1, hkv, dh)
        q = rope(q.reshape(b, 1, hkv * g, dh), positions, cfg.rope_theta)
        q = q.reshape(b, 1, hkv, g, dh)
        k = rope(k, positions, cfg.rope_theta)
        _write_slot(kc, slot, k[:, 0])
        _write_slot(vc, slot, v[:, 0])
        _write_slot(pc, slot, t)
        # score against the whole cache; stale slots masked via positions
        s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), kc.float())
        s = s / math.sqrt(dh)
        valid = (pc >= 0) & (pc <= t)
        if cfg.sliding_window is not None:
            valid = valid & ((t - pc) < cfg.sliding_window)
        s = torch.where(valid[:, None, None, None, :], s, -math.inf)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(dt), vc)
        o = o.reshape(b, 1, cfg.d_q) @ lp["wo"].to(dt)
        x = x + o
        h2 = rmsnorm(x, lp["ln2"])
        if cfg.is_moe:
            x = x + moe_mlp(lp, h2, cfg)
        else:
            x = x + swiglu(lp, h2, dt)
    logits = _head(params, x[:, 0], dt)
    cache["t"].fill_(t + 1)
    return logits, cache
