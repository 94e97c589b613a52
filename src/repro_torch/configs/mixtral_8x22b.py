"""Mixtral 8x22B [arXiv:2401.04088; hf] — 56L 6144d 48H (GQA kv=8)
d_ff=16384, vocab 32768, MoE 8 experts top-2, sliding-window attention."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=32768,
    n_experts=8, top_k=2,
    sliding_window=4096, rope_theta=1e6,
    compute_dtype=torch.bfloat16, remat=True,
)

SMOKE = LMConfig(
    name="mixtral-8x22b-smoke",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_head=16,
    d_ff=192, vocab=128, n_experts=4, top_k=2, sliding_window=32,
    compute_dtype=torch.float32, remat=False, attn_chunk=16,
)

SPEC = ArchSpec(
    arch_id="mixtral-8x22b",
    family="lm",
    config=CONFIG,
    smoke=SMOKE,
    shapes=LM_SHAPES,
    skip_shapes={},
    source="[arXiv:2401.04088; hf]",
)
