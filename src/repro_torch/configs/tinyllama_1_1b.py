"""TinyLlama 1.1B [arXiv:2401.02385; hf] — llama2-arch small:
22L 2048d 32H (GQA kv=4), d_ff=5632, vocab 32000."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="tinyllama-1.1b",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_head=64,
    d_ff=5632, vocab=32000,
    sliding_window=None, rope_theta=1e4,
    compute_dtype=torch.bfloat16, remat=True,
)

SMOKE = LMConfig(
    name="tinyllama-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=176, vocab=128,
    compute_dtype=torch.float32, remat=False, attn_chunk=16,
)

SPEC = ArchSpec(
    arch_id="tinyllama-1.1b",
    family="lm",
    config=CONFIG,
    smoke=SMOKE,
    shapes=LM_SHAPES,
    skip_shapes=dict(
        long_500k="pure full attention (quadratic); skipped per assignment",
    ),
    source="[arXiv:2401.02385; hf]",
)
