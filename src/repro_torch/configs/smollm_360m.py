"""SmolLM 360M [hf:HuggingFaceTB/SmolLM-360M; hf] — llama-arch small:
32L 960d 15H (GQA kv=5), d_ff=2560, vocab 49152."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="smollm-360m",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_head=64,
    d_ff=2560, vocab=49152,
    sliding_window=None, rope_theta=1e4,
    compute_dtype=torch.bfloat16, remat=True,
)

SMOKE = LMConfig(
    name="smollm-smoke",
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, d_head=20,
    d_ff=160, vocab=128,
    compute_dtype=torch.float32, remat=False, attn_chunk=16,
)

SPEC = ArchSpec(
    arch_id="smollm-360m",
    family="lm",
    config=CONFIG,
    smoke=SMOKE,
    shapes=LM_SHAPES,
    skip_shapes=dict(
        long_500k="pure full attention (quadratic); skipped per assignment",
    ),
    source="[hf:HuggingFaceTB/SmolLM-360M; hf]",
)
