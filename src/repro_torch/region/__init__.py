"""repro_torch.region — the region layer of `repro.region`, as far as it is
ported: padding mixed-size cell pools onto a power-of-two bucket menu with
masked devices (`region.batch`). The serving pipeline and its mesh are
ROADMAP Queue 1 item 9.
"""
from .batch import bucket_size, inactive_system, pad_allocation, pad_system

__all__ = ["bucket_size", "inactive_system", "pad_allocation", "pad_system"]
