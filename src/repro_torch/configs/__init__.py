"""Architecture configs (port of ``repro/configs/``): one module per
assigned architecture, with the reference's published and smoke widths and
``compute_dtype`` as a torch dtype."""
from repro_torch.configs.base import ARCH_IDS, ArchSpec, all_cells, get_spec

__all__ = ["ARCH_IDS", "ArchSpec", "get_spec", "all_cells"]
