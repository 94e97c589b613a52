"""Optimizers and schedules (port of ``repro/optim/``)."""
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_init, adamw_update, global_norm,
)
from repro_torch.optim.compress import (
    compress_int8, decompress_int8, init_error,
)
from repro_torch.optim.schedules import warmup_cosine

__all__ = [
    "adamw_init", "adamw_update", "AdamWConfig", "global_norm",
    "warmup_cosine", "compress_int8", "decompress_int8", "init_error",
]
