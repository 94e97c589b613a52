"""Distribution layer: the group-optional collective wrappers.  The
reference's ``ShardingRules`` waits for its readers (ROADMAP A.14)."""
from repro_torch.distributed.collectives import axis_size, pmax, pmin, psum

__all__ = ["psum", "pmin", "pmax", "axis_size"]
