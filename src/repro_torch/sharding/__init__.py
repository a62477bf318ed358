"""repro_torch.sharding — the logical-axis rules of `repro.sharding`, as far
as the region mesh uses them (`partition.region_rules`,
`partition.logical_to_spec`)."""
from .partition import logical_to_spec, region_rules

__all__ = ["logical_to_spec", "region_rules"]
