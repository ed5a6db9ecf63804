"""Sharding: logical-axis rules and mesh-aware partition specs (the
reference's ``repro.sharding``), as ``DTensor`` placements."""

from .logical import (NamedSharding, PartitionSpec, axis_rules, constrain,
                      current_rules, logical_to_mesh, mesh_axis_sizes,
                      named_sharding, placements, spec_for)

__all__ = ["NamedSharding", "PartitionSpec", "axis_rules", "constrain",
           "current_rules", "logical_to_mesh", "mesh_axis_sizes",
           "named_sharding", "placements", "spec_for"]
