"""Distribution layer: the group-optional collective wrappers
(:mod:`.collectives`), the logical-axis sharding rules (:mod:`.sharding`)
and the DTensor sharding rules the dry run registers
(:mod:`.dtensor_rules`)."""
from repro_torch.distributed.collectives import axis_size, pmax, pmin, psum

__all__ = ["psum", "pmin", "pmax", "axis_size"]
