"""Synthetic resolution-sensitive federated datasets (paper §VII-B).

Port of `repro/fl/data.py`. No dataset downloads: the generator
reproduces the *mechanism* the paper studies (accuracy rises with
video-frame resolution, degrades under non-IID and unbalanced splits):

  * each class has a random template whose evidence is split across
    spatial scales at the base resolution;
  * a sample is template + a per-sample shift + smooth and pixel noise;
  * rendering at resolution s average-pools the base frame down to s x s,
    destroying the class evidence finer than s.

Splits: "iid", "noniid-1" (1 class a client), "noniid-2" (2 classes a
client), and `unbalanced=True` resamples each client's data down to a
Dirichlet-drawn size, as §VII-B.

The draws are inputs (`FLDraws`): the template normals per scale, the
labels themselves (which covers every split), the shifts, the smooth and
pixel noise, and the Dirichlet fractions. `dataset_draws` / `eval_draws`
make them from a `torch.Generator` (on the CPU in float64, then cast and
moved, so a seed gives the same data on every device);
`interop.fl_draws_from_numpy` carries the reference's `jax.random` draws
over. Images are NHWC, as the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..core.channel import GeneratorLike, _generator
from ..core.types import resolve_device

Tensor = torch.Tensor

# the template's spatial scales (those <= the base resolution are used)
_SCALES = (4, 8, 16, 32, 64)


@dataclasses.dataclass(frozen=True)
class FLDataset:
    """Per-client tensors: images at BASE resolution; render at train
    time."""
    images: Tensor             # (clients, per_client, H, H, 1) base frames
    labels: Tensor             # (clients, per_client) int64
    templates: Tensor          # (num_classes, H, H, 1) generative templates
    noise: float
    base_resolution: int
    num_classes: int

    @property
    def n_clients(self) -> int:
        return self.images.shape[0]


@dataclasses.dataclass
class SampleDraws:
    """One `_sample` call's draws for labels of shape L: `shift` (*L, 2)
    integers in {-1, 0, 1}, `smooth` (*L, 4, 4, 1) and `pix` (*L, H, H, 1)
    standard normals."""
    shift: Tensor
    smooth: Tensor
    pix: Tensor


@dataclasses.dataclass
class FLDraws:
    """Every draw of a federated dataset (`templates` set) or of an eval
    set (`templates` None).

    templates: the standard normals of each template scale <= the base
        resolution, (num_classes, s, s, 1) each, finest last.
    labels: (clients, per_client) or (n,) int class labels.
    sample: the `SampleDraws` of the frames.
    frac: (clients,) Dirichlet(1) fractions, read by `unbalanced` only.
    """
    labels: Tensor
    sample: SampleDraws
    templates: Optional[Tuple[Tensor, ...]] = None
    frac: Optional[Tensor] = None


def render(images: Tensor, resolution: int) -> Tensor:
    """Average-pool base frames (..., H, H, 1) down to (..., s, s, 1). A
    resolution that does not divide H keeps the top-left s*k x s*k crop
    (k = H // s)."""
    H = images.shape[-3]
    if resolution >= H:
        return images
    k = H // resolution
    s = resolution
    x = images[..., : s * k, : s * k, :]
    return x.reshape(*x.shape[:-3], s, k, s, k, 1).mean(dim=(-4, -2))


def _upsample(grid: Tensor, factor: int) -> Tensor:
    """Nearest-neighbour upsample of (..., s, s, 1) by `factor`."""
    return grid.repeat_interleave(factor, dim=-3) \
        .repeat_interleave(factor, dim=-2)


def _make_templates(normals: Tuple[Tensor, ...], base: int) -> Tensor:
    """Class evidence split across spatial scales: block-constant
    components at scales 4, 8, ..., base, one per normal draw. Rendering at
    resolution r keeps the components of scale <= r and (mostly) destroys
    finer ones, so accuracy rises with the allocated frame resolution
    (paper Fig. 6/7 mechanism)."""
    parts = [_upsample(z, base // z.shape[-3]) for z in normals]
    return sum(parts) / math.sqrt(float(len(parts)))


def _roll(imgs: Tensor, shift: Tensor) -> Tensor:
    """Roll each frame (..., H, W, 1) by its own (dy, dx) in `shift`
    (..., 2), cyclically, as `jnp.roll` per sample: a gather with modular
    indices."""
    H, W = imgs.shape[-3], imgs.shape[-2]
    rows = (torch.arange(H, device=imgs.device) - shift[..., :1]) % H
    cols = (torch.arange(W, device=imgs.device) - shift[..., 1:]) % W
    imgs = torch.gather(imgs, -3, rows[..., :, None, None].expand(imgs.shape))
    return torch.gather(imgs, -2, cols[..., None, :, None].expand(imgs.shape))


def _sample(draws: SampleDraws, templates: Tensor, labels: Tensor,
            noise: float) -> Tensor:
    base = templates.shape[-3]
    imgs = _roll(templates[labels], draws.shift)
    # smooth noise survives pooling (so low resolutions don't get a free
    # SNR boost); a little pixel noise on top
    smooth = _upsample(draws.smooth, base // 4)
    return imgs + noise * (2.2 * smooth + 0.3 * draws.pix)


def _put(x: Tensor, dtype, device) -> Tensor:
    return x.to(dtype=dtype).to(device)


def _sample_draws(gen: torch.Generator, shape, base: int, dtype, device
                  ) -> SampleDraws:
    shape = tuple(shape)
    return SampleDraws(
        shift=torch.randint(-1, 2, shape + (2,), generator=gen).to(device),
        smooth=_put(torch.randn(shape + (4, 4, 1), generator=gen,
                                dtype=torch.float64), dtype, device),
        pix=_put(torch.randn(shape + (base, base, 1), generator=gen,
                             dtype=torch.float64), dtype, device))


def dataset_draws(gen: GeneratorLike, n_clients: int = 10,
                  per_client: int = 256, num_classes: int = 8,
                  base_resolution: int = 32, split: str = "iid", *,
                  device=None, dtype: torch.dtype = torch.float32) -> FLDraws:
    """A federated dataset's draws from `gen` (a torch.Generator or an
    integer seed), on `device` (CUDA by default). Non-IID splits give each
    client `per_cls` distinct classes (1 or 2) and draw each sample's label
    uniformly among them."""
    dev = resolve_device(device)
    gen = _generator(gen)
    normals = tuple(
        _put(torch.randn((num_classes, s, s, 1), generator=gen,
                         dtype=torch.float64), dtype, dev)
        for s in _SCALES if s <= base_resolution)
    if split == "iid":
        labels = torch.randint(0, num_classes, (n_clients, per_client),
                               generator=gen)
    elif split in ("noniid-1", "noniid-2"):
        per_cls = 1 if split == "noniid-1" else 2
        owned = torch.stack([torch.randperm(num_classes, generator=gen)
                             [:per_cls] for _ in range(n_clients)])
        pick = torch.randint(0, per_cls, (n_clients, per_client),
                             generator=gen)
        labels = torch.gather(owned, 1, pick)
    else:
        raise ValueError(f"unknown split {split!r}")
    sample = _sample_draws(gen, labels.shape, base_resolution, dtype, dev)
    # Dirichlet(1, ..., 1): normalized standard exponentials
    e = -torch.log1p(-torch.rand(n_clients, generator=gen,
                                 dtype=torch.float64))
    return FLDraws(labels=labels.to(dev), sample=sample, templates=normals,
                   frac=_put(e / e.sum(), dtype, dev))


def eval_draws(gen: GeneratorLike, n: int, num_classes: int,
               base_resolution: int, *, device=None,
               dtype: torch.dtype = torch.float32) -> FLDraws:
    """An eval set's draws (IID labels, no templates) from `gen`."""
    dev = resolve_device(device)
    gen = _generator(gen)
    labels = torch.randint(0, num_classes, (n,), generator=gen)
    return FLDraws(labels=labels.to(dev),
                   sample=_sample_draws(gen, labels.shape, base_resolution,
                                        dtype, dev))


def make_federated_dataset(draws, n_clients: int = 10,
                           per_client: int = 256, num_classes: int = 8,
                           base_resolution: int = 32, split: str = "iid",
                           unbalanced: bool = False,
                           noise: float = 0.35, *, device=None,
                           dtype: torch.dtype = torch.float32) -> FLDataset:
    """A federated dataset from its `FLDraws`, or from a torch.Generator /
    integer seed that `dataset_draws` draws them from (the sizes, `split`,
    `device` and `dtype` apply only then; given draws fix them all)."""
    if not isinstance(draws, FLDraws):
        draws = dataset_draws(draws, n_clients, per_client, num_classes,
                              base_resolution, split, device=device,
                              dtype=dtype)
    base = draws.sample.pix.shape[-3]
    templates = _make_templates(draws.templates, base)
    labels = draws.labels
    imgs = _sample(draws.sample, templates, labels, noise)

    if unbalanced:
        # resample each client's data down to a Dirichlet-drawn effective
        # size, repeating sample 0 past it
        n_clients, per_client = labels.shape
        frac = torch.clamp(draws.frac * n_clients, 0.2, 1.0)
        ar = torch.arange(per_client, device=labels.device)
        idx = torch.where(ar[None, :] < (frac[:, None] * per_client),
                          ar[None, :], 0)
        imgs = torch.gather(imgs, 1, idx[..., None, None, None]
                            .expand(imgs.shape))
        labels = torch.gather(labels, 1, idx)

    return FLDataset(images=imgs, labels=labels, templates=templates,
                     noise=noise, base_resolution=base,
                     num_classes=templates.shape[0])


def make_eval_set(draws: FLDraws, ds: FLDataset) -> Tuple[Tensor, Tensor]:
    """Held-out IID eval set from the dataset's generative process:
    (images (n, H, H, 1), labels (n,))."""
    return _sample(draws.sample, ds.templates, draws.labels,
                   ds.noise), draws.labels
