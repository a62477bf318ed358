"""repro_torch.sharding — the logical-axis rules of `repro.sharding`: the
region mesh's rules and the model zoo's FSDP / tensor-parallel rules, the
specs they give a parameter tree, and their DTensor placements."""
from .partition import (PARAM_AXIS_PATTERNS, active_axis_sizes,
                        active_rules, axes_for_path, fsdp_tp_rules,
                        logical_to_spec, param_logical_axes, param_pspecs,
                        param_shardings, region_rules, shape_aware_spec,
                        shard, spec_placements, use_rules)

__all__ = ["PARAM_AXIS_PATTERNS", "active_axis_sizes", "active_rules",
           "axes_for_path", "fsdp_tp_rules", "logical_to_spec",
           "param_logical_axes", "param_pspecs", "param_shardings",
           "region_rules", "shape_aware_spec", "shard", "spec_placements",
           "use_rules"]
