"""Shared helper of the LM training tests: a tree in the reference's
layout (`models.transformer.param_tree`'s, or a restored checkpoint's)
taken back to the port's parameter names."""
from repro_torch.models.transformer import STACKED


def params_from_tree(model, tree):
    """{parameter name: its leaf of `tree`} (a view of the stacked leaf for
    a layer's parameter), for every parameter of `model`: the inverse of
    `param_tree`."""
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        path = [parts[0], *parts[2:]] if parts[0] in STACKED else parts
        node = tree
        for part in path:
            node = node[part]
        leaf = node[int(parts[1])] if parts[0] in STACKED else node
        if tuple(leaf.shape) != tuple(p.shape):
            raise ValueError(f"params_from_tree: {name} has shape "
                             f"{tuple(p.shape)}, the tree's leaf "
                             f"{tuple(leaf.shape)}")
        out[name] = leaf
    return out
