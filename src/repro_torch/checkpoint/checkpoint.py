"""Tree checkpointing: one raw buffer file per leaf and a JSON manifest.

Port of `repro/checkpoint/checkpoint.py`, in its layout: a directory with
one file per leaf, named from the leaf's path ("params/layers/s0_attn/attn/
wq" -> `params__layers__s0_attn__attn__wq.bin`; dict keys sorted,
NamedTuple fields by name, list and tuple items by index), each the leaf's
C-order bytes (bfloat16 as its uint16 bits), and a manifest with the step
and, for each leaf, its file, shape and dtype. The reference writes that
manifest with msgpack (`manifest.msgpack`); the port writes the same
content as JSON (`manifest.json`). Leaf files written from the same
weights and optimizer state are byte for byte the reference's. `restore`
takes an optional device in place of the reference's shardings.

Model parameters go in through `models.transformer.param_tree` (the
reference's tree, stacked over periods).
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

MANIFEST = "manifest.json"


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    elif hasattr(tree, "_fields"):          # NamedTuple
        for k in tree._fields:
            yield from _flatten(getattr(tree, k), f"{prefix}/{k}")
    else:
        yield prefix, tree


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def save(path: str, tree: Any, step: Optional[int] = None) -> None:
    """Writes every tensor leaf of `tree` and the manifest under `path`."""
    os.makedirs(path, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in _flatten(tree):
        t = torch.as_tensor(leaf).detach().cpu().contiguous()
        fn = name.replace("/", "__") + ".bin"
        manifest["leaves"][name] = dict(file=fn, shape=list(t.shape),
                                        dtype=_dtype_name(t))
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        with open(os.path.join(path, fn), "wb") as f:
            f.write(arr.tobytes())
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f)


def _read(path: str, meta: dict) -> torch.Tensor:
    with open(os.path.join(path, meta["file"]), "rb") as f:
        raw = f.read()
    if meta["dtype"] == "bfloat16":
        arr = np.frombuffer(raw, np.int16).reshape(meta["shape"])
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(raw, np.dtype(meta["dtype"])).reshape(meta["shape"])
    return torch.from_numpy(arr.copy())


def restore(path: str, like: Any, device=None) -> Any:
    """The checkpoint under `path` in the structure of `like` (a tree of
    tensors, or of anything at the leaves), each leaf on `device` (the
    CPU if None)."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    out = {name: _read(path, meta).to(device or "cpu")
           for name, meta in manifest["leaves"].items()}

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k], f"{prefix}/{k}" if prefix else str(k))
                    for k in tree}
        if hasattr(tree, "_fields"):
            return type(tree)(*(rebuild(getattr(tree, k), f"{prefix}/{k}")
                                for k in tree._fields))
        if isinstance(tree, (tuple, list)):
            return type(tree)(rebuild(v, f"{prefix}/{i}")
                              for i, v in enumerate(tree))
        return out[prefix]

    return rebuild(like)


def latest_step(path: str) -> Optional[int]:
    mp = os.path.join(path, MANIFEST)
    if not os.path.exists(mp):
        return None
    with open(mp) as f:
        return json.load(f).get("step")
