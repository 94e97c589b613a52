"""BST [arXiv:1905.06874; paper] — Behavior Sequence Transformer:
embed_dim 32, seq_len 20, 1 block, 8 heads, MLP 1024-512-256.
Table sizes follow the paper's Taobao-scale setting (huge sparse tables)."""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import BSTConfig

CONFIG = BSTConfig(
    name="bst",
    item_vocab=4_000_000,
    user_vocab=2_000_000,
    n_user_fields=8,
    user_field_vocab=100_000,
    embed_dim=32,
    seq_len=20,
    n_blocks=1,
    n_heads=8,
    d_ff=64,
    mlp=(1024, 512, 256),
)

SMOKE = BSTConfig(
    name="bst-smoke",
    item_vocab=1000, user_vocab=500, n_user_fields=4, user_field_vocab=100,
    embed_dim=16, seq_len=8, n_blocks=1, n_heads=4, d_ff=32, mlp=(64, 32),
)

SPEC = ArchSpec(
    arch_id="bst",
    family="recsys",
    config=CONFIG,
    smoke=SMOKE,
    shapes=RECSYS_SHAPES,
    source="[arXiv:1905.06874; paper]",
)
