"""Dry run: every (arch x input-shape) as an abstract pass on the
production meshes, with FLOPs, bytes and per-device memory recorded.

Port of `repro/launch/dryrun.py`. The reference lowers and compiles each
step with XLA over 512 placeholder host devices. PyTorch has no SPMD
compiler, so the port runs the step itself on "meta" tensors (shapes and
dtypes, no storage, no arithmetic): the model, the optimizer state, the
batch and, for decode, the cache are built on "meta"
(`init_model(..., device="meta")`, `launch/specs.py`), and the step
(`make_train_step`, `make_prefill_step` or `make_serve_step`) runs under
`torch.utils.flop_counter.FlopCounterMode` and a dispatch mode that adds
up each op's operand and result bytes. The three LM kernels run their
fakes there and count through their FLOP formulas (`kernels/ops.py`).
The production mesh is a `DeviceMesh` over a fake process group of 512
ranks ("fake" backend: no process, no communication), made in
`lower_pair` / `main` when no group exists, never at import.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both --out dryrun.jsonl

The record has the reference's keys:
  flops, hbm_bytes   global, for the unsharded step: FlopCounterMode's
                     count and the bytes of every op's operands and
                     results (views left out), each op once;
  argument_bytes     per device: every argument leaf (parameters, the
                     optimizer state, the batch, the cache) at its local
                     size under its shape-aware spec (`param_shardings`
                     from `fsdp_tp_rules`; the batch split over the data
                     axes), checked against `distribute_tensor(...)
                     .to_local()` on the mesh;
  output_bytes       per device, the same way: train's parameters,
                     optimizer state and two float32 scalars; prefill's
                     logits under their ("batch", "seq", "vocab")
                     constraint; decode's logits ("batch", "vocab") and
                     cache;
  lower_s            the abstract pass's seconds (build and step);
  compile_s, temp_bytes, peak_bytes, collectives
                     None: there is no compiler, so no compile time, no
                     buffer assignment (temporaries, peak) and no
                     partitioned program whose collectives could be
                     counted. Collectives exist only in a DTensor
                     execution of the model (sharded execution, not
                     ported yet).
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
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..configs.base import ModelConfig
from ..models.transformer import init_cache, init_model, param_tree
from ..sharding.partition import (_iter_paths, fsdp_tp_rules, param_pspecs,
                                  shape_aware_spec, spec_placements,
                                  use_rules)
from .mesh import make_production_mesh, mesh_axis_sizes
from .specs import (SHAPES, adapt_config, batch_specs, decode_cache_len,
                    supported)
from .steps import make_prefill_step, make_serve_step, make_train_step

FAKE_WORLD = 512        # ranks of the fake group: the multi-pod mesh's


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


def lower_step(cfg: ModelConfig, kind: str, specs: Dict[str, torch.Tensor],
               mesh, rules: dict, *, cache_len: Optional[int] = None,
               accum_steps: int = 1) -> Dict[str, Any]:
    """The abstract pass of one step of `cfg` ("train", "prefill" or
    "decode") on the batch `specs` (meta tensors) over `mesh`: FLOPs and
    bytes of the unsharded step, per-device argument and output bytes.
    decode needs `cache_len` (the cache's slots per sequence)."""
    t0 = time.perf_counter()
    sizes = mesh_axis_sizes(mesh)
    multi_pod = "pod" in sizes
    model = init_model(cfg, 0, "meta")
    ptree = param_tree(model)
    psp = param_pspecs(ptree, rules, sizes)
    bsp = {k: batch_spec(v, multi_pod) for k, v in specs.items()}
    args_tree: Dict[str, Any] = {"params": ptree, "batch": specs}
    args_specs: Dict[str, Any] = {"params": psp, "batch": bsp}
    with use_rules(rules, sizes):
        if kind == "train":
            step, opt = make_train_step(cfg, accum_steps=accum_steps)
            state = opt.init(dict(model.named_parameters()))
            args_tree["opt"] = [state.step, param_tree(model, state.mu),
                                param_tree(model, state.nu)]
            args_specs["opt"] = [(), psp, psp]
            _, flops, nbytes = count_step(step, model, state, specs)
            out_tree = {"params": ptree, "opt": args_tree["opt"],
                        "metrics": [torch.empty((), device="meta")] * 2}
            out_specs = {"params": psp, "opt": args_specs["opt"],
                         "metrics": [(), ()]}
        elif kind == "prefill":
            step = make_prefill_step(cfg)
            logits, flops, nbytes = count_step(step, model, specs)
            out_tree = logits
            out_specs = shape_aware_spec(("batch", "seq", "vocab"),
                                         tuple(logits.shape), rules, sizes,
                                         repair=False)
        else:
            B = specs["token"].shape[0]
            cache = init_cache(cfg, B, cache_len, device="meta")
            csp = param_pspecs(cache, rules, sizes)
            args_tree["cache"], args_specs["cache"] = cache, csp
            extras = {k: v for k, v in specs.items() if k == "frame_embeds"}
            step = make_serve_step(cfg)
            (logits, cache), flops, nbytes = count_step(
                step, model, cache, specs["token"], cache_len - 1,
                extras or None)
            out_tree = [logits, cache]
            out_specs = [shape_aware_spec(("batch", "vocab"),
                                          tuple(logits.shape), rules, sizes,
                                          repair=False), csp]
    argument_bytes = tree_local_bytes(args_tree, args_specs, sizes, mesh)
    output_bytes = tree_local_bytes(out_tree, out_specs, sizes)
    return dict(
        kind=kind, mesh="x".join(str(s) for s in mesh.shape),
        n_devices=math.prod(mesh.shape),
        lower_s=time.perf_counter() - t0, compile_s=None,
        flops=float(flops), hbm_bytes=float(nbytes),
        argument_bytes=int(argument_bytes), output_bytes=int(output_bytes),
        temp_bytes=None, peak_bytes=None, collectives=None)


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
        print(f"== {arch} x {shape_name} on {rec['mesh']} "
              f"(abstract pass {rec['lower_s']:.1f}s)")
        print(f"   memory: args={rec['argument_bytes'] / 2**30:.2f}GiB "
              f"out={rec['output_bytes'] / 2**30:.2f}GiB (per device)")
        print(f"   cost: flops={rec['flops']:.3e} "
              f"bytes={rec['hbm_bytes']:.3e} (global)")
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
