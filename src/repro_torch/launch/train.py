"""LM training entry point.

Port of `repro/launch/train.py`, on CUDA unless `--device cpu` is given:

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-20b \
        --reduced --steps 50 --batch 8 --seq 256 --device cpu

Runs `make_train_step` (AdamW on a cosine schedule, clip 1.0) on the
synthetic token pipeline, weights drawn from seed 0, and with `--ckpt`
writes the trained parameters in the reference's checkpoint layout. An
encoder-decoder config gets zero frame embeddings and a VLM zero patch
embeddings, as in the reference. A caller may pass its own `ModelConfig`
to `main(cfg=...)`, e.g. a depth cut.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..checkpoint import save
from ..configs import get_config
from ..configs.base import ModelConfig
from ..core.types import resolve_device
from ..data import make_pipeline
from ..kernels import ops as kops
from ..models.transformer import init_model, param_tree
from ..optim import AdamW, cosine_schedule
from .steps import make_train_step


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def grad_report(grads: dict) -> dict:
    """Per-parameter gradient checks: how many, and the names of those
    missing (None), with a non-finite entry, or all zero."""
    bad = {"missing": [], "nonfinite": [], "zero": []}
    for name, g in grads.items():
        if g is None:
            bad["missing"].append(name)
        elif not bool(torch.isfinite(g).all()):
            bad["nonfinite"].append(name)
        elif not bool((g != 0).any()):
            bad["zero"].append(name)
    return dict(params=len(grads), **bad)


def main(argv=None, stats: Optional[dict] = None,
         cfg: Optional[ModelConfig] = None) -> list:
    """Train; returns the per-step losses. `stats`, if given, receives per
    step the loss, grad_norm, seconds (to a device sync) and kernel
    launches, the peak device memory, `grad_report` of step 1's
    gradients, and the trained model and optimizer state. `cfg`, if
    given, is trained in place of an `--arch` config, and the two may not
    both be given (`--reduced` still applies)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="config name (default internlm2-20b)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if cfg is None:
        cfg = get_config(args.arch or "internlm2-20b")
    elif args.arch is not None:
        raise ValueError(f"--arch {args.arch} and cfg={cfg.name} both given: "
                         "pass one")
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    print(f"training {cfg.name} ({'reduced' if args.reduced else 'full'}): "
          f"{cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab_size}")
    if stats is not None and device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    model = init_model(cfg, 0, device)
    opt = AdamW(lr=cosine_schedule(args.lr, max(args.steps // 10, 1),
                                   args.steps))
    step_fn, _ = make_train_step(cfg, opt)
    opt_state = opt.init(dict(model.named_parameters()))

    B = args.batch
    extras = {}
    if cfg.n_patches:
        extras["patch_embeds"] = torch.zeros(
            (B, cfg.n_patches, cfg.d_model), dtype=cfg.torch_dtype,
            device=device)
    if cfg.encoder_layers:
        extras["frame_embeds"] = torch.zeros(
            (B, cfg.encoder_ctx, cfg.d_model), dtype=cfg.torch_dtype,
            device=device)
    pipe = make_pipeline(cfg.vocab_size, B, args.seq, seed=0)
    rec = {k: [] for k in ("loss", "grad_norm", "step_s", "step_launches")}
    t0 = time.perf_counter()
    for i, batch in enumerate(pipe):
        if i >= args.steps:
            break
        b = {"tokens": torch.from_numpy(batch["tokens"]).to(device).long(),
             **extras}
        grads = {} if stats is not None and i == 0 else None
        before = kops.launch_counts()
        _sync(device)
        ts = time.perf_counter()
        model, opt_state, metrics = step_fn(model, opt_state, b, grads)
        _sync(device)
        rec["step_s"].append(time.perf_counter() - ts)
        after = kops.launch_counts()
        rec["step_launches"].append({k: after[k] - before[k] for k in after})
        rec["loss"].append(float(metrics["loss"]))
        rec["grad_norm"].append(float(metrics["grad_norm"]))
        if grads is not None:
            rec["step1_grads"] = grad_report(grads)
            del grads
        if (i + 1) % args.log_every == 0:
            dt = time.perf_counter() - t0
            print(f"step {i+1}: loss={rec['loss'][-1]:.4f} "
                  f"({dt/(i+1):.2f}s/step)")
    losses = rec["loss"]
    print(f"loss first->last: {losses[0]:.4f} -> {losses[-1]:.4f}")
    if args.ckpt:
        save(args.ckpt, {"params": param_tree(model)}, step=args.steps)
        print(f"checkpoint written to {args.ckpt}")
    if stats is not None:
        stats.update(rec, model=model, opt_state=opt_state,
                     peak_memory_bytes=torch.cuda.max_memory_allocated(device)
                     if device.type == "cuda" else None)
    return losses


if __name__ == "__main__":
    main()
