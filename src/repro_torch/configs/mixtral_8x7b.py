"""Mixtral 8x7B [arXiv:2401.04088; hf] — 32L 4096d 32H (GQA kv=8)
d_ff=14336, vocab 32000, MoE 8 experts top-2, sliding-window attention."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=32000,
    n_experts=8, top_k=2,
    sliding_window=4096, rope_theta=1e6,
    compute_dtype=torch.bfloat16, remat=True, remat_policy="dots",
)

SMOKE = LMConfig(
    name="mixtral-8x7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=128, n_experts=4, top_k=2, sliding_window=32,
    compute_dtype=torch.float32, remat=False, attn_chunk=16,
)

SPEC = ArchSpec(
    arch_id="mixtral-8x7b",
    family="lm",
    config=CONFIG,
    smoke=SMOKE,
    shapes=LM_SHAPES,
    # SWA => sub-quadratic; long_500k runs with the rolling-window cache
    skip_shapes={},
    source="[arXiv:2401.04088; hf]",
)
