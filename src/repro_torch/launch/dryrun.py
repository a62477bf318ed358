"""Dry run: every (arch x input-shape) as an abstract pass on the
production meshes, with FLOPs, bytes, collectives and memory per device.

Port of `repro/launch/dryrun.py`. The reference lowers and compiles each
step with XLA over 512 placeholder host devices and reads the partitioned
program's costs. PyTorch has no SPMD compiler, so the port runs the step
itself on "meta" tensors (shapes and dtypes, no storage, no arithmetic),
twice: the model, the optimizer state, the batch and, for decode, the
cache are built on "meta" (`init_model(..., device="meta")`,
`launch/specs.py`), and the step (`make_train_step`, `make_prefill_step`
or `make_serve_step`) runs

  1. unsharded, under `torch.utils.flop_counter.FlopCounterMode` and a
     dispatch mode that adds up each op's operand and result bytes
     (`count_step`): the whole step's counts;
  2. partitioned: every argument a meta DTensor on the mesh (parameters
     and AdamW moments by `param_pspecs` -> `spec_placements`, the batch
     over the data axes, the cache by its specs) under the rules
     (`use_rules`), so the models' `shard` sites redistribute for real and
     DTensor splits every op; `LocalCounter` counts the local ops DTensor
     runs for rank 0: FLOPs (the same formulas), bytes, the collectives
     its redistributions issue, and the local results' live bytes.
     DTensor's sharding propagation runs an op's first call with a given
     signature once more on fake global-shaped tensors; those calls run
     under a FakeTensorMode, which the counter detects and leaves out (no
     warm-up pass). `Reshard` runs again, gathered, any op whose sharding
     DTensor cannot propagate. On the multi-pod mesh the pass runs with
     "pod" folded into "data" (`pass_mesh`).

The three LM kernels run their fakes there, count through their FLOP
formulas and split by their DTensor sharding rules (`kernels/ops.py`).
The production mesh is a `DeviceMesh` over a fake process group of 512
ranks ("fake" backend: no process, no communication), made in
`lower_pair` / `main` when no group exists, never at import.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both --out dryrun.jsonl

The record has the reference's keys, each per device as the reference's:
  flops, hbm_bytes   one device's share from the partitioned pass (the
                     unsharded pass's on a one-device mesh);
  collectives        {kind: {"count", "bytes"}} for the reference's
                     kinds and total_bytes; bytes are each collective's
                     result bytes on the device (`_c10d_functional`'s
                     all_gather_into_tensor, all_reduce,
                     reduce_scatter_tensor, all_to_all_single); DTensor
                     issues no collective-permute;
  argument_bytes     every argument leaf at its local size under its
                     shape-aware spec (`param_shardings` from
                     `fsdp_tp_rules`; the batch split over the data axes),
                     checked against `distribute_tensor(...).to_local()`
                     on the mesh;
  output_bytes       the same way: train's parameters, optimizer state
                     and two float32 scalars; prefill's logits under
                     their ("batch", "seq", "vocab") constraint; decode's
                     logits ("batch", "vocab") and cache;
  temp_bytes         the most bytes the partitioned pass's local results
                     held at once; peak_bytes = argument_bytes + that;
                     None on a one-device mesh (no partitioned pass);
  lower_s            the passes' seconds (build and steps);
  compile_s          None: there is no compiler.
and beside them
  flops_global, hbm_bytes_global
                     the unsharded step's (`chip_smoke.py` holds them
                     against the card exactly);
  reshards           the ops `Reshard` ran gathered, by name.
The decode step takes `pos` as a host integer (the port's attention reads
it with `int(pos)`): the context's last position.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..configs.base import ModelConfig
from ..models.transformer import STACKED, init_cache, init_model, param_tree
from ..optim import AdamWState
from ..sharding.partition import (_iter_paths, fsdp_tp_rules, param_pspecs,
                                  shape_aware_spec, spec_placements,
                                  use_rules)
from .mesh import make_production_mesh, mesh_axis_sizes
from .specs import (SHAPES, adapt_config, batch_specs, decode_cache_len,
                    supported)
from .steps import make_prefill_step, make_serve_step, make_train_step

FAKE_WORLD = 512        # ranks of the fake group: the multi-pod mesh's

# the reference's collective kinds (`repro/launch/dryrun.py`), and the
# `_c10d_functional` ops DTensor's redistributions issue for each
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
_COLLECTIVE_OF = {"all_gather_into_tensor": "all-gather",
                  "all_reduce": "all-reduce",
                  "reduce_scatter_tensor": "reduce-scatter",
                  "all_to_all_single": "all-to-all"}


class ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every op's tensor operands and results; view
    ops (which move nothing) are left out. `total` is the sum."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.total += _nbytes(args) + _nbytes(kwargs.values()) \
                + _nbytes(out)
        return out


def _nbytes(x) -> int:
    """Bytes of the tensors in x: a tensor or a (nested) sequence."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple, type({}.values()))):
        return sum(_nbytes(t) for t in x)
    return 0


def count_step(fn, *args, **kwargs):
    """(fn's result, FLOPs, operand and result bytes) of one call."""
    with FlopCounterMode(display=False) as fc, ByteCounter() as bc:
        out = fn(*args, **kwargs)
    return out, fc.get_total_flops(), bc.total


class LocalCounter(TorchDispatchMode):
    """One device's share of a pass on DTensors: it declines every op on
    DTensors (returns NotImplemented, so DTensor dispatches it) and counts
    the local ops DTensor runs for it, rank 0's shards:
      flops        the FLOP formulas FlopCounterMode reads
                   (`torch.utils.flop_counter.flop_registry`, the custom
                   ops' included), on the local shapes;
      bytes        every op's operand and result bytes, views left out, as
                   `ByteCounter`;
      collectives  count and result bytes of each `_c10d_functional`
                   collective, under the reference's kinds;
      peak         the most bytes the pass's local results held at once
                   (views and in-place results left out; each is released
                   when its last reference goes).
    DTensor's sharding propagation runs an op's first call with a given
    signature once more on fake global-shaped tensors to infer the output
    (then caches it); those calls run under a FakeTensorMode, which the
    counter detects and leaves out."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = {op: {"count": 0, "bytes": 0}
                            for op in COLLECTIVE_OPS}
        self.live = self.peak = 0

    def _release(self, n):
        self.live -= n

    def snapshot(self):
        """The counts so far, for `restore` (the live bytes go on)."""
        return (self.flops, self.bytes, self.peak,
                {k: dict(v) for k, v in self.collectives.items()})

    def restore(self, snap):
        self.flops, self.bytes, self.peak, self.collectives = snap

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVE_OF.get(func._opname.removesuffix("_coalesced"))
            if kind is not None:
                self.collectives[kind]["count"] += 1
                self.collectives[kind]["bytes"] += _nbytes(out)
                self.bytes += _nbytes(args) + _nbytes(out)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += _nbytes(args) + _nbytes(kwargs.values()) \
                + _nbytes(out)
            if not func._schema.is_mutable:
                for t in (out if isinstance(out, (list, tuple)) else (out,)):
                    if isinstance(t, torch.Tensor):
                        n = _nbytes(t)
                        self.live += n
                        weakref.finalize(t, self._release, n)
                self.peak = max(self.peak, self.live)
        return out

    def collectives_record(self) -> Dict[str, Any]:
        """The reference's form: {kind: {"count", "bytes"}} and
        total_bytes."""
        out = {k: dict(v) for k, v in self.collectives.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        return out


class Reshard(TorchDispatchMode):
    """An op on DTensors whose sharding DTensor cannot propagate (a view
    that would keep a split inside a head, where a mesh dimension does not
    divide the heads) runs again with its DTensor arguments gathered on
    the innermost mesh dimension that splits them, then on the next one
    out, and so on: the all-gathers a partitioner inserts where no
    sharding holds, over as few mesh dimensions as will do. An op DTensor
    has no sharding strategy for at all (some, such as `flip` in a
    gradient, lack one in older PyTorch releases) runs on the gathered
    local tensors, its results replicated. A dispatch mode, so a
    gradient's ops are repaired as the forward's. `repaired` counts those
    ops by name; an in-place op is never repaired. What an attempt that
    fails issued is taken off `counter`."""

    def __init__(self, counter: LocalCounter):
        super().__init__()
        self.repaired: Dict[str, int] = {}
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_leaves, tree_map

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:     # NotImplementedError included
            if func._schema.is_mutable:
                raise
            error = e
        name = str(func.overloadpacket.__name__)
        self.repaired[name] = self.repaired.get(name, 0) + 1
        mesh = next(t.device_mesh for t in tree_leaves((args, kwargs))
                    if isinstance(t, DTensor))
        if not isinstance(error, NotImplementedError):
            for keep in range(mesh.ndim - 1, -1, -1):
                def gathered(x):
                    if not isinstance(x, DTensor):
                        return x
                    want = tuple(p if i < keep else Replicate()
                                 for i, p in enumerate(x.placements))
                    return x.redistribute(x.device_mesh, want)
                snap = self.counter.snapshot()
                try:
                    return func(*tree_map(gathered, args),
                                **tree_map(gathered, kwargs))
                except RuntimeError:
                    self.counter.restore(snap)
            raise error
        whole = [Replicate()] * mesh.ndim

        def local(x):
            return x.redistribute(mesh, whole).to_local() \
                if isinstance(x, DTensor) else x

        def replicated(x):
            return DTensor.from_local(x, mesh, whole, run_check=False) \
                if isinstance(x, torch.Tensor) else x
        return tree_map(replicated, func(*tree_map(local, args),
                                         **tree_map(local, kwargs)))


def fake_group(world: int = FAKE_WORLD):
    """The default process group, made as a fake one of `world` ranks
    (rank 0) when none exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)


def local_bytes(t: torch.Tensor, spec, sizes: Dict[str, int]) -> int:
    """Bytes of one device's shard of `t` under `spec` (every split dim
    divides: shape-aware specs, or a batch that fills its axes)."""
    n = t.element_size()
    for dim, size in enumerate(t.shape):
        ways = 1
        for a in (spec[dim] if isinstance(spec[dim], tuple)
                  else (spec[dim],) if spec[dim] else ()):
            ways *= sizes[a]
        n *= size // ways
    return n


def tree_local_bytes(tree, specs, sizes, mesh=None) -> int:
    """Per-device bytes of every leaf of `tree` under the matching tree of
    specs; with `mesh`, each leaf's shard is also made by
    `distribute_tensor` and its `to_local()` size must agree."""
    total = 0
    for (path, t), (_, spec) in zip(_iter_paths(tree), _iter_paths(specs),
                                    strict=True):
        n = local_bytes(t, spec, sizes)
        if mesh is not None:
            from torch.distributed.tensor import distribute_tensor

            local = distribute_tensor(
                t, mesh, spec_placements(spec, mesh.mesh_dim_names)
            ).to_local()
            if local.numel() * local.element_size() != n:
                raise AssertionError(
                    f"{path}: local bytes {n} from its spec {spec}, "
                    f"{local.numel() * local.element_size()} from "
                    "distribute_tensor")
        total += n
    return total


def batch_spec(t: torch.Tensor, multi_pod: bool):
    """The reference's batch sharding: a scalar or a batch of one
    replicated, else the leading axis over the data axes."""
    if t.dim() == 0 or t.shape[0] == 1:
        return (None,) * t.dim()
    data = ("pod", "data") if multi_pod else ("data",)
    return (data if len(data) > 1 else data[0],) + (None,) * (t.dim() - 1)


def _distributed(t: torch.Tensor, spec, mesh):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, spec_placements(spec,
                                                      mesh.mesh_dim_names))


def pass_mesh(mesh, rules: dict):
    """The mesh and rules of the partitioned pass: `mesh` and `rules`
    themselves, except that the multi-pod mesh's "pod" and "data" axes
    become one "data" axis of pod x data devices (the rules' "pod" folded
    into it). The batch splits as on the pod and data axes, and every
    op's local shapes are the same, but FSDP's weight splits go over the
    folded axis, so the weights' gradients reduce-scatter once over it
    where the 3-D layout would reduce over "pod" and scatter over "data".
    Merging a batch split over two mesh axes with a split over a third
    (a strided layout) sends DTensor into a search over layouts that takes
    up to minutes an op on three mesh axes, and no time on two."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return mesh, rules
    from torch.distributed.device_mesh import init_device_mesh

    sizes = mesh_axis_sizes(mesh)
    folded = init_device_mesh(
        mesh.device_type, (sizes["pod"] * sizes["data"], sizes["model"]),
        mesh_dim_names=("data", "model"))

    def fold(axes):
        flat = tuple(dict.fromkeys(
            "data" if a == "pod" else a
            for a in (axes if isinstance(axes, tuple)
                      else (axes,) if axes else ())))
        return flat[0] if len(flat) == 1 else (flat or None)
    return folded, {k: fold(v) for k, v in rules.items()}


def place_model(model, psp, mesh) -> None:
    """Every parameter of `model` replaced, in place, by a DTensor laid out
    by its spec: the leaf of `psp` (`param_pspecs` of `param_tree(model)`)
    at its path, less the stacked "layers" / "encoder" axis (never split)
    for a layer's own parameter."""
    for name, p in list(model.named_parameters()):
        parts = name.split(".")
        if parts[0] in STACKED:
            parts = [parts[0], *parts[2:]]
        spec = psp
        for part in parts:
            spec = spec[part]
        if parts[0] in STACKED:
            assert spec[0] is None, (name, spec)
            spec = spec[1:]
        *owner, leaf = name.split(".")
        mod = model.get_submodule(".".join(owner))
        setattr(mod, leaf, torch.nn.Parameter(
            _distributed(p.detach(), spec, mesh),
            requires_grad=p.requires_grad))


def _partitioned(step, *args):
    """One call of `step` on DTensor arguments, counted per device
    (`LocalCounter`), plain tensors taken as replicated, and calls DTensor
    cannot shard run replicated (`Reshard`). Returns (the counter, the
    repairs by function)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from ..kernels.ops import register_sharding_rules

    register_sharding_rules()
    # DTensor caches each op's sharding by its arguments from a fixed
    # position on, which for topk leaves k out: a pass after one with
    # another top-k on the same shapes (jamba's 2 of 16 experts, then
    # dbrx's 4) would get the first pass's output shapes. Its caches
    # (Python, and C++ where the release has one) start empty each pass.
    prop = DTensor._op_dispatcher.sharding_propagator
    for clear in (
            getattr(prop.propagate_op_sharding, "cache_clear", None),
            getattr(getattr(prop, "_propagate_tensor_meta_cached", None),
                    "cache_clear", None),
            getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                    None)):
        if clear is not None:
            clear()
    lc = LocalCounter()
    with implicit_replication(), lc, Reshard(lc) as rs:
        step(*args)
    return lc, rs.repaired


def lower_step(cfg: ModelConfig, kind: str, specs: Dict[str, torch.Tensor],
               mesh, rules: dict, *, cache_len: Optional[int] = None,
               accum_steps: int = 1) -> Dict[str, Any]:
    """The abstract passes of one step of `cfg` ("train", "prefill" or
    "decode") on the batch `specs` (meta tensors) over `mesh`: the
    unsharded step's FLOPs and bytes, then the step on meta DTensors laid
    out on `mesh` (parameters and optimizer moments by their specs, the
    batch over the data axes, the cache by its specs) counted on one
    device, and the per-device argument and output bytes. decode needs
    `cache_len` (the cache's slots per sequence). On a one-device mesh the
    per-device pass is the unsharded one and is not run again."""
    t0 = time.perf_counter()
    sizes = mesh_axis_sizes(mesh)
    multi_pod = "pod" in sizes
    model = init_model(cfg, 0, "meta")
    ptree = param_tree(model)
    psp = param_pspecs(ptree, rules, sizes)
    bsp = {k: batch_spec(v, multi_pod) for k, v in specs.items()}
    args_tree: Dict[str, Any] = {"params": ptree, "batch": specs}
    args_specs: Dict[str, Any] = {"params": psp, "batch": bsp}
    cache = csp = None
    if kind == "decode":
        B = specs["token"].shape[0]
        cache = init_cache(cfg, B, cache_len, device="meta")
        csp = param_pspecs(cache, rules, sizes)
        args_tree["cache"], args_specs["cache"] = cache, csp
    extras = [k for k in specs if k == "frame_embeds"]
    states = []

    def run(batch, cache, counted):
        """One call of the step on `batch` and `cache`, counted by
        `counted` (`count_step` or `_partitioned`)."""
        if kind == "train":
            step, opt = make_train_step(cfg, accum_steps=accum_steps)
            params = dict(model.named_parameters())
            state = opt.init(params)
            if states:     # the placed pass: the moments laid out as params
                from torch.distributed.tensor import distribute_tensor

                state = AdamWState(step=state.step, **{
                    f: {n: distribute_tensor(t, params[n].device_mesh,
                                             params[n].placements)
                        for n, t in getattr(state, f).items()}
                    for f in ("mu", "nu")})
            states.append(state)
            return counted(step, model, state, batch)
        if kind == "prefill":
            return counted(make_prefill_step(cfg), model, batch)
        return counted(make_serve_step(cfg), model, cache, batch["token"],
                       cache_len - 1,
                       {k: batch[k] for k in extras} if extras else None)

    with use_rules(rules, sizes):
        out, flops_global, bytes_global = run(specs, cache, count_step)
    local = None
    if math.prod(mesh.shape) > 1:
        pmesh, prules = pass_mesh(mesh, rules)
        psizes = mesh_axis_sizes(pmesh)
        with use_rules(prules, psizes):
            place_model(model, param_pspecs(ptree, prules, psizes), pmesh)
            local = run(
                {k: _distributed(v, batch_spec(v, False), pmesh)
                 for k, v in specs.items()},
                cache and _place_tree(cache, param_pspecs(cache, prules,
                                                          psizes), pmesh),
                _partitioned)
    if kind == "train":
        state = states[0]
        args_tree["opt"] = [state.step, param_tree(model, state.mu),
                            param_tree(model, state.nu)]
        args_specs["opt"] = [(), psp, psp]
        out_tree = {"params": ptree, "opt": args_tree["opt"],
                    "metrics": [torch.empty((), device="meta")] * 2}
        out_specs = {"params": psp, "opt": args_specs["opt"],
                     "metrics": [(), ()]}
    elif kind == "prefill":
        out_tree = out
        out_specs = shape_aware_spec(("batch", "seq", "vocab"),
                                     tuple(out.shape), rules, sizes,
                                     repair=False)
    else:
        logits, cache_out = out
        out_tree = [logits, cache_out]
        out_specs = [shape_aware_spec(("batch", "vocab"),
                                      tuple(logits.shape), rules, sizes,
                                      repair=False), csp]
    argument_bytes = tree_local_bytes(args_tree, args_specs, sizes, mesh)
    output_bytes = tree_local_bytes(out_tree, out_specs, sizes)
    if local is None:      # one device: the unsharded pass is its share
        flops, nbytes, temp, reshards = flops_global, bytes_global, None, {}
        collectives = LocalCounter().collectives_record()
    else:
        (counter, reshards) = local
        flops, nbytes, temp = counter.flops, counter.bytes, counter.peak
        collectives = counter.collectives_record()
    return dict(
        kind=kind, mesh="x".join(str(s) for s in mesh.shape),
        n_devices=math.prod(mesh.shape),
        lower_s=time.perf_counter() - t0, compile_s=None,
        flops=float(flops), hbm_bytes=float(nbytes),
        flops_global=float(flops_global),
        hbm_bytes_global=float(bytes_global),
        argument_bytes=int(argument_bytes), output_bytes=int(output_bytes),
        temp_bytes=None if temp is None else int(temp),
        peak_bytes=None if temp is None else int(argument_bytes + temp),
        collectives=collectives, reshards=reshards)


def _place_tree(tree, specs, mesh):
    """`tree` (the decode cache: a list of dicts of NamedTuples) with every
    leaf a DTensor laid out by the matching leaf of `specs`."""
    if isinstance(tree, dict):
        return {k: _place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_place_tree(getattr(tree, k), getattr(specs, k),
                                        mesh) for k in tree._fields))
    if isinstance(tree, list):
        return [_place_tree(v, sp, mesh)
                for v, sp in zip(tree, specs, strict=True)]
    return _distributed(tree, specs, mesh)


def lower_pair(arch: str, shape_name: str, multi_pod: bool,
               rules_override: Optional[dict] = None,
               cfg_overrides: Optional[dict] = None,
               accum_steps: int = 1,
               verbose: bool = True) -> Dict[str, Any]:
    """The abstract pass of one (arch, shape, mesh); the roofline record."""
    t0 = time.perf_counter()
    cfg = adapt_config(get_config(arch), shape_name)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    fake_group()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rules = fsdp_tp_rules(multi_pod, seq_shard_decode=(kind == "decode"))
    if rules_override:
        rules.update(rules_override)
    rec = lower_step(cfg, kind, batch_specs(cfg, shape_name), mesh, rules,
                     cache_len=decode_cache_len(cfg, shape_name),
                     accum_steps=accum_steps)
    rec = dict(arch=arch, shape=shape_name, **rec)
    rec["lower_s"] = time.perf_counter() - t0
    if verbose:
        coll = rec["collectives"]
        temp = rec["temp_bytes"]
        print(f"== {arch} x {shape_name} on {rec['mesh']} "
              f"(abstract passes {rec['lower_s']:.1f}s)")
        print(f"   memory: args={rec['argument_bytes'] / 2**30:.2f}GiB "
              f"out={rec['output_bytes'] / 2**30:.2f}GiB "
              + (f"temp={temp / 2**30:.2f}GiB " if temp is not None else "")
              + "(per device)")
        print(f"   cost: flops={rec['flops']:.3e} "
              f"bytes={rec['hbm_bytes']:.3e} (per device); "
              f"flops={rec['flops_global']:.3e} "
              f"bytes={rec['hbm_bytes_global']:.3e} (global)")
        print(f"   collectives: {coll['total_bytes'] / 2**20:.1f} MiB "
              + " ".join(f"{op}:{coll[op]['count']}" for op in COLLECTIVE_OPS
                         if coll[op]["count"]))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (or --all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    pairs = []
    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                pairs.append((a, s, mp))

    fake_group()
    ok = skipped = failed = 0
    for a, s, mp in pairs:
        if not supported(get_config(a), s):
            print(f"-- skip {a} x {s} (documented skip: no 500k decode for "
                  "the encoder-decoder)")
            skipped += 1
            continue
        try:
            rec = lower_pair(a, s, mp)
            ok += 1
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        except Exception as e:
            failed += 1
            print(f"!! FAIL {a} x {s} multi_pod={mp}: {type(e).__name__}: {e}")
            traceback.print_exc(limit=3)
    print(f"\ndry-run summary: {ok} ok, {skipped} skipped, {failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
