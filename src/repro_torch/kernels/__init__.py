"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

* ``segsum`` — the sorted segment-reduce kernel's wrapper (sum/max/min,
  float32/int32, any channel count; ``csrc/segreduce.cu``), the backend of
  every GSP-Louvain sortscan phase.
* ``ref``    — the plain versions (the CPU path, and the yardstick the
  kernels are held against on the card).
* ``ops``    — the dispatch point, by device.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
