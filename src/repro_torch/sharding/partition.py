"""Logical-axis sharding: rules mapping logical tensor axes to mesh axes,
and the specs and DTensor placements they give a parameter tree.

Port of `repro/sharding/partition.py`. A spec is a plain tuple with one
entry per tensor axis: the mesh axis it is split over, a tuple of mesh
axes, or None (as a `jax.sharding.PartitionSpec` is). Parameter trees
are nested dicts (`models.transformer.param_tree`, stacked over periods
in the reference's layout) whose leaf *paths* give the logical axes
(`PARAM_AXIS_PATTERNS`); the decode cache is a list with one dict per
period, whose leaves are unstacked (`axes_for_path` drops "layers").
`param_shardings` turns the specs into DTensor placements over a
`torch.distributed.device_mesh.DeviceMesh`, the counterpart of a
`NamedSharding`.

Activation constraints go through `shard()`, which consults the rules a
launcher made active (`use_rules`). Without active rules, or on a plain
tensor, it returns its input: one check. On a DTensor under active rules
it redistributes to the spec's placements.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...], None]
Rules = Dict[str, MeshAxes]
Spec = Tuple[MeshAxes, ...]

# ---------------------------------------------------------------------------
# Rule sets. Logical axes used across the model zoo:
#   batch, seq, embed, vocab, heads, kv_heads, head_dim, mlp, experts,
#   expert_mlp, inner (ssm inner width), state (ssm state), layers, window
# ---------------------------------------------------------------------------


def fsdp_tp_rules(multi_pod: bool, expert_parallel: bool = True,
                  seq_shard_decode: bool = False) -> Rules:
    """Default production rules: FSDP over 'data', tensor/expert parallel
    over 'model'; the 'pod' axis (if present) extends the data axis."""
    data: MeshAxes = ("pod", "data") if multi_pod else "data"
    rules: Rules = {
        "batch": data,
        "seq": None,
        "embed": "data",          # FSDP shard of params' embed dim
        "embed_act": None,        # activations keep embed replicated
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model" if expert_parallel else None,
        "expert_mlp": None if expert_parallel else "model",
        "inner": "model",
        "state": None,
        "layers": None,
        "kv_seq": "model" if seq_shard_decode else None,
        "pod_batch": data,
        # Megatron-style sequence parallelism: the residual stream between
        # blocks is split over 'model' along seq.
        "seq_outer": "model",
        "cache_batch": data,
    }
    return rules


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


_ACTIVE: threading.local = threading.local()


@contextlib.contextmanager
def use_rules(rules: Optional[Rules],
              axis_sizes: Optional[Dict[str, int]] = None):
    """Make `rules` (and the mesh's axis sizes) the ones `shard` reads,
    for this thread, within the block."""
    prev = getattr(_ACTIVE, "rules", None)
    prev_sz = getattr(_ACTIVE, "axis_sizes", None)
    _ACTIVE.rules = rules
    _ACTIVE.axis_sizes = axis_sizes
    try:
        yield
    finally:
        _ACTIVE.rules = prev
        _ACTIVE.axis_sizes = prev_sz


def active_rules() -> Optional[Rules]:
    return getattr(_ACTIVE, "rules", None)


def active_axis_sizes() -> Optional[Dict[str, int]]:
    return getattr(_ACTIVE, "axis_sizes", None)


def _flat(m: MeshAxes) -> Tuple[str, ...]:
    return tuple(m) if isinstance(m, tuple) else ((m,) if m else ())


def logical_to_spec(axes: Sequence[Optional[str]], rules: Rules) -> Spec:
    """The spec of a tensor whose axes carry the logical names `axes`. A
    mesh axis is used at most once in a spec (a later axis mapping to one
    already used stays unsplit)."""
    parts = []
    used = set()
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        flat = _flat(m)
        if any(f in used for f in flat):
            m = None
        for f in flat:
            used.add(f)
        parts.append(m)
    return tuple(parts)


def _axes_prod(m: MeshAxes, sizes: Dict[str, int]) -> int:
    n = 1
    for a in _flat(m):
        n *= sizes.get(a, 1)
    return n


def shape_aware_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                     rules: Rules, sizes: Dict[str, int],
                     repair: bool = True) -> Spec:
    """logical_to_spec + divisibility: a mesh axis that does not divide its
    dim is dropped; with `repair`, dropped axes are relocated to the first
    unsharded dim they do divide, right to left (e.g. kv_heads=8 on
    model=16 moves the 'model' axis onto head_dim)."""
    parts: list = []
    used: set = set()
    dropped: list = []
    for dim, ax in enumerate(axes):
        m = rules.get(ax) if ax is not None else None
        flat = tuple(a for a in _flat(m) if a is not None)
        if any(a in used for a in flat):
            flat = ()
        # keep the longest prefix of the tuple that still divides
        while flat and shape[dim] % _axes_prod(flat, sizes) != 0:
            dropped.append(flat[-1])
            flat = flat[:-1]
        for a in flat:
            used.add(a)
        parts.append(flat if len(flat) > 1 else (flat[0] if flat else None))
    if repair:
        for a in dropped:
            if a in used:
                continue
            # never the stacked-layers dim: a mesh axis there would split
            # each period's slice across devices
            for dim in range(len(parts) - 1, -1, -1):
                if axes[dim] == "layers":
                    continue
                if parts[dim] is None and shape[dim] % sizes.get(a, 1) == 0 \
                        and shape[dim] >= sizes.get(a, 1):
                    parts[dim] = a
                    used.add(a)
                    break
    return tuple(parts)


def spec_placements(spec: Spec, mesh_dim_names: Sequence[str]) -> tuple:
    """DTensor placements of `spec` over a mesh with these dim names: one
    per mesh dim, `Shard(tensor dim)` where the spec names that mesh axis
    (a tuple entry such as ("pod", "data") shards its tensor dim on each,
    in the mesh's order: pod first), `Replicate()` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    where = {a: dim for dim, m in enumerate(spec) for a in _flat(m)}
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in mesh_dim_names)


def is_partitioned(x) -> bool:
    """True when rules are active and `x` is a DTensor: a partitioned pass
    (the dry run's), where the models lay some tensors out for it."""
    if active_rules() is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def whole_heads(w, dim: int):
    """`w` unchanged, unless it is the DTensor of a partitioned pass whose
    dimension `dim` (a head's width) is split: then gathered there. The
    shape-aware specs move a mesh axis onto the head width where it could
    not split the heads (8 KV heads on 16 devices); a product over the
    heads merged with their widths would then hold a split inside a head,
    which a DTensor view back to (heads, width), a forward's or its
    gradient's, cannot express (the dry run reruns it gathered), and
    whose strided layout DTensor plans redistributions for by a slow
    search; gathering the weight instead keeps the activations split over
    the batch and the other heads."""
    if not is_partitioned(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in w.placements)
    return w if want == tuple(w.placements) else \
        w.redistribute(w.device_mesh, want)


def shard(x, *axes: Optional[str]):
    """Constrain an activation's sharding by logical axes: `x` unchanged
    unless rules are active and `x` is a DTensor, which is then
    redistributed to the spec's placements (mesh axes that do not divide
    their dim are dropped, not relocated)."""
    rules = active_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    sizes = active_axis_sizes()
    if sizes is not None:
        spec = shape_aware_spec(axes, x.shape, rules, sizes, repair=False)
    else:
        spec = logical_to_spec(axes, rules)
    mesh = x.device_mesh
    return x.redistribute(mesh, spec_placements(spec, mesh.mesh_dim_names))


# ---------------------------------------------------------------------------
# Parameter path -> logical axes. First match of a regex on '/'-joined
# paths. Shapes listed for the stacked-layer ('layers' leading axis) layout.
# ---------------------------------------------------------------------------

PARAM_AXIS_PATTERNS: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings / head
    (r"embed/tokens$",        ("vocab", "embed")),
    (r"lm_head/w$",           ("embed", "vocab")),
    (r"pos_embed/w$",         (None, "embed")),
    # attention (stacked over layers)
    (r"attn/wq$",             ("layers", "embed", "heads", "head_dim")),
    (r"attn/wk$",             ("layers", "embed", "kv_heads", "head_dim")),
    (r"attn/wv$",             ("layers", "embed", "kv_heads", "head_dim")),
    (r"attn/wo$",             ("layers", "heads", "head_dim", "embed")),
    (r"attn/bq$",             ("layers", "heads", "head_dim")),
    (r"attn/bk$",             ("layers", "kv_heads", "head_dim")),
    (r"attn/bv$",             ("layers", "kv_heads", "head_dim")),
    # MLA
    (r"attn/wq_a$",           ("layers", "embed", None)),
    (r"attn/wq_b$",           ("layers", None, "heads", "head_dim")),
    (r"attn/wkv_a$",          ("layers", "embed", None)),
    (r"attn/wkv_b$",          ("layers", None, "heads", "head_dim")),
    (r"attn/wk_rope$",        ("layers", "embed", "head_dim")),
    # dense mlp
    (r"mlp/wi$",              ("layers", "embed", "mlp")),
    (r"mlp/wg$",              ("layers", "embed", "mlp")),
    (r"mlp/wo$",              ("layers", "mlp", "embed")),
    # moe
    (r"moe/router$",          ("layers", "embed", "experts")),
    (r"moe/wi$",              ("layers", "experts", "embed", "expert_mlp")),
    (r"moe/wg$",              ("layers", "experts", "embed", "expert_mlp")),
    (r"moe/wo$",              ("layers", "experts", "expert_mlp", "embed")),
    # mamba
    (r"mamba/in_proj$",       ("layers", "embed", "inner")),
    (r"mamba/gate_proj$",     ("layers", "embed", "inner")),
    (r"mamba/conv_w$",        ("layers", None, "inner")),
    (r"mamba/conv_b$",        ("layers", "inner")),
    (r"mamba/a_log$",         ("layers", "inner", "state")),
    (r"mamba/d$",             ("layers", "inner")),
    (r"mamba/dt_w$",          ("layers", "inner", None)),
    (r"mamba/dt_proj$",       ("layers", None, "inner")),
    (r"mamba/dt_bias$",       ("layers", "inner")),
    (r"mamba/bc_proj$",       ("layers", "inner", None)),
    (r"mamba/out_proj$",      ("layers", "inner", "embed")),
    # rwkv6
    (r"rwkv/r_proj$",         ("layers", "embed", "heads", "head_dim")),
    (r"rwkv/k_proj$",         ("layers", "embed", "heads", "head_dim")),
    (r"rwkv/v_proj$",         ("layers", "embed", "heads", "head_dim")),
    (r"rwkv/g_proj$",         ("layers", "embed", "heads", "head_dim")),
    (r"rwkv/w_proj$",         ("layers", "embed", "heads", "head_dim")),
    (r"rwkv/w_lora_a$",       ("layers", "embed", None)),
    (r"rwkv/w_lora_b$",       ("layers", None, "heads", "head_dim")),
    (r"rwkv/u$",              ("layers", "heads", "head_dim")),
    (r"rwkv/o_proj$",         ("layers", "heads", "head_dim", "embed")),
    (r"rwkv/mix_.*$",         ("layers", "embed")),
    (r"rwkv/ffn_k$",          ("layers", "embed", "mlp")),
    (r"rwkv/ffn_v$",          ("layers", "mlp", "embed")),
    (r"rwkv/ffn_r$",          ("layers", "embed", "embed_act")),
    # norms & misc small
    (r"(^|/)norm[123]?/scale$", ("layers", None)),
    (r"final_norm/scale$",    (None,)),
    (r"proj/w$",              ("embed", "embed_act")),   # modality projector
    # ---- decode caches (leading axis = stacked periods) ----
    (r"/k$",                  ("layers", "cache_batch", "kv_seq", "kv_heads", "head_dim")),
    (r"/v$",                  ("layers", "cache_batch", "kv_seq", "kv_heads", "head_dim")),
    (r"/qk$",                 ("layers", "cache_batch", "kv_seq", "kv_heads", "head_dim")),
    (r"/qv$",                 ("layers", "cache_batch", "kv_seq", "kv_heads", "head_dim")),
    (r"/k_scale$",            ("layers", "cache_batch", "kv_seq", "kv_heads")),
    (r"/v_scale$",            ("layers", "cache_batch", "kv_seq", "kv_heads")),
    (r"/xk$",                 ("layers", "cache_batch", "kv_seq", "heads", "head_dim")),
    (r"/xv$",                 ("layers", "cache_batch", "kv_seq", "heads", "head_dim")),
    (r"/c_kv$",               ("layers", "cache_batch", "kv_seq", None)),
    (r"/k_rope$",             ("layers", "cache_batch", "kv_seq", None)),
    (r"/conv$",               ("layers", "cache_batch", None, "inner")),
    (r"/h$",                  ("layers", "cache_batch", "inner", "state")),
    (r"/state$",              ("layers", "cache_batch", "heads", None, None)),
    (r"/x_tm$",               ("layers", "cache_batch", None)),
    (r"/x_cm$",               ("layers", "cache_batch", None)),
)


def axes_for_path(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    for pat, axes in PARAM_AXIS_PATTERNS:
        if re.search(pat, path):
            if len(axes) == ndim:
                return axes
            if len(axes) == ndim + 1 and axes[0] == "layers":
                return axes[1:]          # unstacked: one period's leaf
            if len(axes) == ndim - 1:
                return ("layers",) + tuple(axes)
    return tuple([None] * ndim)          # replicate by default


def _join(prefix: str, k) -> str:
    return f"{prefix}/{k}" if prefix else str(k)


def _iter_paths(tree, prefix=""):
    """(path, leaf) of every leaf: dicts and NamedTuples add their keys to
    the path, a list (the decode cache's periods) adds nothing."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_paths(v, _join(prefix, k))
    elif hasattr(tree, "_fields"):      # NamedTuple (caches)
        for k in tree._fields:
            yield from _iter_paths(getattr(tree, k), _join(prefix, k))
    elif isinstance(tree, list):
        for v in tree:
            yield from _iter_paths(v, prefix)
    else:
        yield prefix, tree


def _map_leaves(fn, tree, prefix=""):
    """`tree` with each leaf replaced by fn(path, leaf), paths as
    `_iter_paths` gives them."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, _join(prefix, k))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, getattr(tree, k),
                                        _join(prefix, k))
                            for k in tree._fields))
    if isinstance(tree, list):
        return [_map_leaves(fn, v, prefix) for v in tree]
    return fn(prefix, tree)


def param_logical_axes(params) -> Dict[str, Tuple[Optional[str], ...]]:
    return {path: axes_for_path(path, leaf.ndim)
            for path, leaf in _iter_paths(params)}


def param_pspecs(params, rules: Rules,
                 axis_sizes: Optional[Dict[str, int]] = None):
    """A tree of specs matching `params`' structure. With axis_sizes,
    specs are shape-aware (divisibility-checked + greedy repair)."""
    def spec(path, leaf):
        axes = axes_for_path(path, leaf.ndim)
        if axis_sizes is not None:
            return shape_aware_spec(axes, tuple(leaf.shape), rules,
                                    axis_sizes)
        return logical_to_spec(axes, rules)
    return _map_leaves(spec, params)


def param_shardings(params, mesh, rules: Rules):
    """A tree of DTensor placements (one per mesh dim) matching `params`'
    structure: the shape-aware specs at the mesh's axis sizes
    (`launch.mesh.mesh_axis_sizes`) over `mesh.mesh_dim_names`."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(mesh.shape)))
    specs = param_pspecs(params, rules, sizes)
    # a spec is a plain tuple: a leaf to _map_leaves
    return _map_leaves(lambda _, spec: spec_placements(spec, names), specs)
