"""Learning-rate schedules as pure functions of the step (port of
``repro/optim/schedules.py``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor`` of peak (scale factor),
    a float32 0-dim tensor on ``step``'s device (an int step: the CPU)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
