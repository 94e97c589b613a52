"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified] — dense
40L 8192d 64H (GQA kv=8), d_ff=22528, vocab 256000, no biases."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="command-r-35b",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22528, vocab=256000,
    sliding_window=None, rope_theta=8e6,
    compute_dtype=torch.bfloat16, remat=True,
)

SMOKE = LMConfig(
    name="command-r-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=160, vocab=256,
    compute_dtype=torch.float32, remat=False, attn_chunk=16,
)

SPEC = ArchSpec(
    arch_id="command-r-35b",
    family="lm",
    config=CONFIG,
    smoke=SMOKE,
    shapes=LM_SHAPES,
    skip_shapes=dict(
        long_500k="pure full attention: a 512k dense cache/attention row is "
                  "quadratic; skipped per assignment (DESIGN.md §5)",
    ),
    source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
)
