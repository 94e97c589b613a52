"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

* ``segsum``        — the scan kernels' wrappers: the sorted segment reduce
  (sum/max/min, float32/int32, any channel count; ``csrc/segreduce.cu``),
  the backend of every GSP-Louvain sortscan phase, and the prefix sum
  (``csrc/cumsum.cu``).
* ``onehot_segsum`` — the deterministic unsorted segment sum
  (``csrc/onehot_segsum.cu``).
* ``spmm``          — the fixed-degree neighbour aggregation
  (``csrc/spmm.cu``).
* ``flash_attn``    — the attention forward (``csrc/flash_attn.cu``).
* ``ref``           — the plain versions (the CPU path, and the yardstick
  the kernels are held against on the card).
* ``ops``           — the dispatch point, by device: ``segreduce_sorted``,
  ``segment_sum_inorder``, ``sum_inorder`` (a flat float32 sum in one fixed
  order on every device), ``cumsum``, ``segsum_sorted``, ``segsum``,
  ``spmm``, ``flash_attention``.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
