"""Mesh layer: split the cell axis of a stacked fleet across devices.

Port of `repro/region/mesh.py`. A region is C cells x N devices; with
`Problem.mesh` set, `repro_torch.solve` splits the cell axis into D
contiguous blocks of ceil(C / D) cells, one per device of the mesh (the
last cell replicated up to a multiple of D, `pad_cells`, and sliced off
after). Two execution modes (`SolverSpec.lockstep`):

  * `lockstep=False` (default): each block is solved as its own batch on
    its own device, one after the other, with its own `while_cells` exit —
    a shard stops as soon as its own cells converge. This is the
    reference's `shard_map` mode.
  * `lockstep=True`: the whole padded cell axis is solved as ONE batch on
    the mesh's first device, so every shard runs the global number of
    batched iterations — the loop condition covers every cell, as the
    reference's GSPMD mode all-reduces it across shards. On a one-device
    mesh the two modes are the same program.

Cells are solved by the same per-cell frozen-carry loop either way (a
converged cell's carry is frozen while others go on), so per-cell results
are bit-identical between the modes and equal to the unsharded fleet
solve: sharding moves work, not math. Results are gathered on the mesh's
first device.

A mesh is a `RegionMesh`: a tuple of `torch.device` and the axis name
"cells" (`sharding.partition.region_rules` maps the logical cell axis
onto it). `region_mesh()` holds every visible CUDA device; tests may pass
the same CPU device D times to get D shards.

Not ported: the deprecated `allocate_region` / `run_rounds_region` shims
(`repro_torch.solve(Problem(..., mesh=...))` is the entry) and
`place_cells` (placement happens per shard inside the solve).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..core.bcd import FleetResult
from ..core.types import Allocation

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RegionMesh:
    """A 1-D mesh: its devices, in shard order, and its axis name."""
    devices: Tuple[torch.device, ...]
    axis_name: str = "cells"

    @property
    def size(self) -> int:
        return len(self.devices)


def region_mesh(n_devices: Optional[int] = None,
                devices: Optional[Sequence] = None) -> RegionMesh:
    """1-D mesh with axis name "cells" over `devices` (default: every
    visible CUDA device; without CUDA the caller must name the devices),
    cut to the first `n_devices`."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "region_mesh: CUDA is not available; pass devices=[...] "
                "(e.g. ['cpu'] * D) to build a mesh on the CPU")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("region_mesh: a mesh needs at least one device")
    return RegionMesh(tuple(devs))


def map_tensors(fn, tree):
    """Apply `fn` to every tensor of `tree` (a tensor, a dataclass such as
    SystemParams / Allocation / RoundDraws, or a tuple / list of those);
    None and other leaves (the static resolution menu) pass through."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, x) for x in tree)
    return tree


def cell_specs(tree):
    """The spec of every tensor of `tree`: its leading (cell) axis split
    over the mesh, deeper axes shard-local, read off
    `sharding.partition.region_rules`."""
    from ..sharding.partition import logical_to_spec, region_rules

    rules = region_rules()
    return map_tensors(lambda x: logical_to_spec(
        ("cells",) + ("device",) * (x.ndim - 1), rules), tree)


def pad_cells(tree, c_pad: int):
    """Pad every tensor's leading (cell) axis to `c_pad` by replicating the
    last cell — mesh shards must divide the cell count. Replicated cells
    cost duplicate work on the last shard only; callers slice them off."""
    def pad(x):
        c = x.shape[0]
        if c == c_pad:
            return x
        reps = x[-1:].expand((c_pad - c,) + tuple(x.shape[1:]))
        return torch.cat([x, reps], 0)
    return map_tensors(pad, tree)


def _cat(outs):
    """Concatenate per-shard outputs (tensors, nested tuples of them)
    along the cell axis, on the first shard's device."""
    first = outs[0]
    if isinstance(first, Tensor):
        return torch.cat([o.to(first.device) for o in outs], 0)
    return type(first)(_cat(parts) for parts in zip(*outs))


def run_over_mesh(fn, args, cells: int, mesh: RegionMesh, lockstep: bool):
    """`fn(*args)` over the cell axis of `args` (every tensor's leading
    axis, `cells` long) split across `mesh`: padded to a multiple of the
    mesh size (`pad_cells`), solved, and every output cut back to `cells`.

    Shard-local (default): block d of ceil(C / D) cells goes to
    `mesh.devices[d]` and is solved there on its own; the outputs are
    concatenated on the first device. Lockstep (or a one-device mesh): the
    whole cell axis is one batch on the first device."""
    D = mesh.size
    block = -(-cells // D)
    args = pad_cells(args, block * D)
    if lockstep or D == 1:
        dev = mesh.devices[0]
        out = fn(*map_tensors(lambda x: x.to(dev), args))
    else:
        out = _cat([fn(*map_tensors(
            lambda x: x[d * block:(d + 1) * block].to(dev), args))
            for d, dev in enumerate(mesh.devices)])
    return map_tensors(lambda x: x[:cells], out)


@dataclasses.dataclass
class RegionResult:
    """A mesh fleet solve plus per-shard convergence stats.

    `stats` is gathered host-side lazily, ONCE, on first access (one
    device->host copy of a packed (4 + 4*D,) tensor): the serving hot path
    — which only slices allocations back out — never pays the copy, while
    monitoring callers still get the summary. The trailing 4*D block is
    the per-shard `SolveCounters` aggregation (summed
    bcd_iters/sp1_evals/sp2_evals and max residual over each shard's
    contiguous cell block, pad cells excluded)."""
    fleet: FleetResult
    _stats_packed: Tensor    # (4,) or (4 + 4*D,), _pack_stats
    _n_cells: int
    _mesh_devices: int
    _stats_cache: Optional[dict] = dataclasses.field(default=None,
                                                     repr=False)

    @property
    def stats(self) -> dict:
        if self._stats_cache is None:
            vals = self._stats_packed.cpu().numpy()
            stats = dict(
                cells=self._n_cells, mesh_devices=self._mesh_devices,
                converged_frac=float(vals[0]), iters_max=int(vals[1]),
                iters_mean=float(vals[2]), objective_mean=float(vals[3]))
            if vals.shape[0] > 4:   # per-shard counter block (D, 4)
                shard = vals[4:].reshape(-1, 4)
                stats.update(
                    shard_bcd_iters=[float(x) for x in shard[:, 0]],
                    shard_sp1_evals=[float(x) for x in shard[:, 1]],
                    shard_sp2_evals=[float(x) for x in shard[:, 2]],
                    shard_residual_max=[float(x) for x in shard[:, 3]],
                    bcd_iters_total=float(shard[:, 0].sum()),
                    sp1_evals_total=float(shard[:, 1].sum()),
                    sp2_evals_total=float(shard[:, 2].sum()),
                    residual_max=float(shard[:, 3].max()))
            self._stats_cache = stats
        return self._stats_cache

    # passthroughs so a RegionResult reads like a FleetResult
    @property
    def allocation(self) -> Allocation:
        return self.fleet.allocation

    @property
    def objective(self) -> Tensor:
        return self.fleet.objective

    @property
    def iters(self) -> Tensor:
        return self.fleet.iters

    @property
    def converged(self) -> Tensor:
        return self.fleet.converged


def _nanmax(x: Tensor, dim: int) -> Tensor:
    """max over `dim` ignoring NaN; NaN where every entry is NaN."""
    nan = torch.isnan(x)
    m = torch.where(nan, torch.full((), -float("inf"), dtype=x.dtype,
                                    device=x.device), x).amax(dim)
    return torch.where(nan.all(dim), torch.full((), float("nan"),
                                                dtype=x.dtype,
                                                device=x.device), m)


def _pack_stats(fleet: FleetResult, n_shards: int = 1) -> Tensor:
    """Region summary stats packed into ONE tensor — (4,) base stats plus,
    when the fleet carries `SolveCounters`, a (n_shards, 4) per-shard
    aggregation flattened behind them. The single lazy host copy happens
    in `RegionResult.stats`.

    Shard attribution follows the mesh layout: cells split in contiguous
    blocks of ceil(C / n_shards), so shard d's block is rows
    [d*B, (d+1)*B) of the zero-padded counter matrix — pad cells
    contribute nothing. Effort columns (bcd_iters, sp1_evals, sp2_evals)
    are nan-summed per shard; the residual column is nan-maxed (a NaN
    residual marks a 0-iteration lane)."""
    dtype = fleet.objective.dtype
    base = torch.stack([
        fleet.converged.to(dtype).mean(),
        fleet.iters.max().to(dtype),
        fleet.iters.to(dtype).mean(),
        torch.nanmean(fleet.objective),
    ])
    if fleet.counters is None:
        return base
    ctr = fleet.counters.data.to(dtype)                 # (C, 4)
    C = ctr.shape[0]
    D = max(int(n_shards), 1)
    block = -(-C // D)
    pad = torch.zeros((block * D - C, ctr.shape[1]), dtype=dtype,
                      device=ctr.device)
    per_shard = torch.cat([ctr, pad]).reshape(D, block, -1)
    effort = torch.nansum(per_shard[..., :3], 1)        # (D, 3)
    resid = _nanmax(per_shard[..., 3], 1)               # (D,)
    return torch.cat([base, torch.cat([effort, resid[:, None]], 1)
                      .reshape(-1)])

