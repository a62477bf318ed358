"""Resolution-agnostic CNN classifier — the FL-MAR client model.

Port of `repro/models/cnn.py`. Stands in for the paper's "modified
YOLOv5m" (§VII-B): the conv trunk accepts any square frame resolution (the
paper's s_n knob) and global-average-pools before the head, so one
parameter set trains across resolutions.

Parameters are a nested dict, as the reference's: ``{"conv{i}": {"w",
"b"}, "head": {"w", "b"}}``, in PyTorch's layouts: a convolution's "w" is
(out, in, 3, 3) (OIHW; the reference's is HWIO) and the head's "w" is
(classes, in) (the reference's is (in, classes)); `interop.
cnn_params_from_numpy` converts. The functions take and return images in
the reference's NHWC layout; inside, the trunk runs on the NCHW view of
the same memory (channels-last strides). The convolutions, pooling and the
head product are library calls (`conv2d`, `max_pool2d`, `linear`), as the
reference's are XLA's. In float32 they run at PyTorch's process-wide
float32 precision: by default on Hopper the convolutions use TF32 tensor
cores (10-bit mantissa products, float32 sums) and the head's product
stays full float32; the caller's setting governs. `CNN` holds the same parameters as an
`nn.Module`.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.channel import GeneratorLike, _generator
from ..core.types import resolve_device

Tensor = torch.Tensor
Params = Dict[str, Dict[str, Tensor]]


def init_cnn(gen: GeneratorLike, num_classes: int = 10,
             in_channels: int = 1, widths: Sequence[int] = (16, 32, 64), *,
             device=None, dtype: torch.dtype = torch.float32) -> Params:
    """He-normal convolutions and a 1/sqrt(fan-in) head, zero biases,
    drawn from `gen` (a torch.Generator or an integer seed) on the CPU in
    float64, then cast and moved to `device` (CUDA by default): the same
    seed gives the same parameters on every device."""
    dev = resolve_device(device)
    gen = _generator(gen)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)

    def put(x):
        return x.to(dtype=dtype).to(dev)

    params: Params = {}
    cin = in_channels
    for i, cout in enumerate(widths):
        fan_in = 3 * 3 * cin
        params[f"conv{i}"] = dict(
            w=put(normal(cout, cin, 3, 3) * (2.0 / fan_in) ** 0.5),
            b=put(torch.zeros(cout)))
        cin = cout
    params["head"] = dict(w=put(normal(num_classes, cin) * (1.0 / cin) ** 0.5),
                          b=put(torch.zeros(num_classes)))
    return params


def apply_cnn(params: Params, images: Tensor) -> Tensor:
    """images: (B, H, W, C) any H=W resolution -> (B, num_classes) logits."""
    x = images.permute(0, 3, 1, 2)          # NCHW view, channels-last memory
    n_convs = sum(1 for k in params if k.startswith("conv"))
    for i in range(n_convs):
        p = params[f"conv{i}"]
        # 3x3 stride 1 "SAME" is a symmetric 1-pixel pad
        x = F.relu(F.conv2d(x, p["w"], p["b"], padding=1))
        # downsample while the spatial extent allows ("VALID" 2x2 windows
        # drop an odd last row / column, as floor mode does)
        if x.shape[-1] >= 2:
            x = F.max_pool2d(x, 2)
    x = x.mean(dim=(2, 3))                  # global average pool
    h = params["head"]
    return F.linear(x, h["w"], h["b"])


def xent_loss(params: Params, images: Tensor, labels: Tensor) -> Tensor:
    """Mean cross-entropy of the logits against integer labels."""
    logp = F.log_softmax(apply_cnn(params, images), dim=-1)
    return F.nll_loss(logp, labels)


def accuracy(params: Params, images: Tensor, labels: Tensor) -> Tensor:
    """Top-1 accuracy, a float32 scalar."""
    logits = apply_cnn(params, images)
    return (logits.argmax(-1) == labels).to(torch.float32).mean()


class CNN(nn.Module):
    """The CNN as an `nn.Module`: the parameters of a `Params` dict as
    `nn.Parameter`s (`conv{i}_w`, ..., `head_b`); `forward` is
    `apply_cnn`, and `params()` gives the dict back."""

    def __init__(self, params: Params):
        super().__init__()
        for layer, leaves in params.items():
            for leaf, x in leaves.items():
                self.register_parameter(f"{layer}_{leaf}",
                                        nn.Parameter(x.detach().clone()))

    def params(self) -> Params:
        out: Params = {}
        for name, p in self.named_parameters():
            layer, leaf = name.rsplit("_", 1)
            out.setdefault(layer, {})[leaf] = p
        return out

    def forward(self, images: Tensor) -> Tensor:
        return apply_cnn(self.params(), images)
