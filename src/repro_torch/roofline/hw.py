"""Hardware model for the roofline: one NVIDIA H100 SXM5 80 GB (port of
``repro/roofline/hw.py``, whose constants are a TPU's and do not carry
over).

The card the port is measured on reports itself as ``NVIDIA H100 80GB
HBM3, 700.00 W`` (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``); the figures below are NVIDIA's data-sheet peaks
for that part at its full 700 W.  A card capped below 700 W runs slower
under load, so a measured fraction of these peaks is read beside the
card's power limit.

* ``peak_flops_bf16``: dense bfloat16 tensor-core rate, 989 TFLOP/s
  (no 2:4 sparsity).  Every ``t_compute`` divides by it, whatever the
  op's type: the reference's one-peak convention.
* ``hbm_bw``: HBM3, 3.35 TB/s.
* ``hbm_bytes``: 80 GB of device memory; each dry-run record's peak bytes
  a device are read against it.
* ``smem_per_sm``: 228 KiB of shared memory an SM (not a roofline term:
  the kernels' budget, the reference's ``vmem_bytes``).
* The collective term.  NVLink 4 carries ``nvlink_bw`` = 450 GB/s each way
  a GPU, but only inside one 8-GPU node.  The production meshes hold 256
  or 512 GPUs: the 16-wide ``model`` axis spans two nodes, and the
  ``data`` and ``pod`` axes cross nodes on every step.  Every ring of
  those meshes therefore has a hop over the network, and a ring runs at
  its slowest hop: one 400 Gb/s NDR InfiniBand port a GPU, ``link_bw`` =
  50 GB/s each way.  ``coll_bw`` (what ``t_collective`` divides by) is that
  one figure, the reference's single ``ici_bw`` convention with the
  ``(n - 1) / n`` ring factor folded in.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class _HW:
    name: str = "NVIDIA H100 80GB HBM3"
    power_limit_w: float = 700.0
    peak_flops_bf16: float = 989e12     # FLOP/s per card, dense
    hbm_bw: float = 3.35e12             # B/s per card
    hbm_bytes: int = 80 * 10**9         # device memory
    nvlink_bw: float = 450e9            # B/s per direction, inside a node
    link_bw: float = 50e9               # B/s per direction, NDR IB port
    links: int = 1                      # network ports per GPU
    smem_per_sm: int = 228 * 1024       # not a roofline term; kernel budget

    @property
    def coll_bw(self) -> float:
        return self.link_bw * self.links


HW = _HW()
