"""The roofline on an H100 (port of ``repro/roofline/``): the card's
constants (:mod:`.hw`) and per-device terms of a traced step
(:mod:`.analyze`)."""
from repro_torch.roofline.analyze import analyze_trace, collective_bytes
from repro_torch.roofline.hw import HW

__all__ = ["HW", "analyze_trace", "collective_bytes"]
