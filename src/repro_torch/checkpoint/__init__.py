"""Checkpointing in the reference's file format (port of
``repro/checkpoint/``); restore takes one ``device``."""
from repro_torch.checkpoint.store import (
    CheckpointCorrupt, CheckpointManager, checkpoint_steps, latest_step,
    load_checkpoint_arrays, restore_checkpoint, save_checkpoint,
)

__all__ = [
    "CheckpointCorrupt", "CheckpointManager", "checkpoint_steps",
    "latest_step", "load_checkpoint_arrays", "restore_checkpoint",
    "save_checkpoint",
]
