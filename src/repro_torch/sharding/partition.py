"""Logical-axis sharding rules: logical tensor axes -> mesh axes.

Port of the part of `repro/sharding/partition.py` that the region mesh
uses (`region/mesh.py::cell_specs`): the region's rule set and the rule
lookup. A spec is a plain tuple with one entry per tensor axis, the mesh
axis it is split over or None, as a `jax.sharding.PartitionSpec` is. The
model zoo's rule sets (FSDP / tensor parallel) are ROADMAP Queue 1 item
12.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...], None]
Rules = Dict[str, MeshAxes]
Spec = Tuple[MeshAxes, ...]


def region_rules() -> Rules:
    """Allocator-side rules for the region service (`repro_torch.region`):
    a stacked fleet's leading cell axis splits over the 1-D "cells" mesh
    (`region.region_mesh`); the per-device axis — and everything below
    it — stays local to a shard (cells are independent problems)."""
    return {
        "cells": "cells",     # stacked base-station cells -> mesh axis
        "device": None,       # per-MAR-device axis: shard-local
        "rounds": None,       # dynamics ledgers: time stays local
    }


def logical_to_spec(axes: Sequence[Optional[str]], rules: Rules) -> Spec:
    """The spec of a tensor whose axes carry the logical names `axes`. A
    mesh axis is used at most once in a spec (a later axis mapping to one
    already used stays unsplit)."""
    parts = []
    used = set()
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        flat = tuple(m) if isinstance(m, tuple) else ((m,) if m else ())
        if any(f in used for f in flat):
            m = None
        for f in flat:
            used.add(f)
        parts.append(m)
    return tuple(parts)
