"""Serving entry point: prefill a batch of prompts, then batched greedy decode.

Port of `repro/launch/serve.py`, on CUDA unless `--device cpu` is given:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-20b \
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --reduced --device cpu

Weights and prompts are drawn from `--seed` (there are no checkpoints).
The prefill runs the flash-attention, mamba-scan or rwkv6 kernel once per
attention (GQA or MLA), Mamba or RWKV layer; decode is plain torch. An
encoder-decoder config (whisper) gets zero frame embeddings in the
prefill and in every decode step, as the reference serves it: the encoder
and the decoder's cross-attention run the flash kernel in both. A VLM
(llava) is served on tokens alone. A caller may pass its own
`ModelConfig` to `main(cfg=...)`, e.g. a depth cut.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..configs import get_config
from ..configs.base import ModelConfig
from ..core.types import resolve_device
from ..kernels import ops as kops
from ..models.transformer import init_cache, init_model, prefill
from .steps import make_serve_step


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, stats: Optional[dict] = None,
         cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """Run the server once; returns the generated ids (B, gen). `stats`, if
    given, receives the prefill and decode seconds, the decode rate (the
    gen - 1 tokens a row of the decode loop over its wall time), the
    prefill's last-position logits and the kernel launches of each phase.
    `cfg`, if given, is served in place of an `--arch` config, and the two
    may not both be given (`--reduced` still applies)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="config name (default mixtral-8x7b)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if cfg is None:
        cfg = get_config(args.arch or "mixtral-8x7b")
    elif args.arch is not None:
        raise ValueError(f"--arch {args.arch} and cfg={cfg.name} both given: "
                         "pass one")
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    model = init_model(cfg, args.seed, device)

    B, P = args.batch, args.prompt_len
    gen_ = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen_,
                            device=device)
    cache = init_cache(cfg, B, P + args.gen, device)
    serve = make_serve_step(cfg)
    extras = None
    if cfg.encoder_layers:
        extras = {"frame_embeds": torch.zeros(
            (B, cfg.encoder_ctx, cfg.d_model), dtype=cfg.torch_dtype,
            device=device)}
    pbatch = {"tokens": prompts, **(extras or {})}

    # block prefill: one forward fills the decode cache
    launches0 = kops.launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    logits_all, cache = prefill(model, cfg, pbatch, cache)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    launches1 = kops.launch_counts()

    last = logits_all[:, P - 1]
    del logits_all
    tok = last.argmax(-1)
    out = [tok]
    t0 = time.perf_counter()
    for t in range(P, P + args.gen - 1):
        logits, cache = serve(model, cache, tok, t, extras)
        tok = logits.argmax(-1)
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    launches2 = kops.launch_counts()
    gen = torch.stack(out, 1)
    # the summary line counts gen tokens a row, as the reference prints it;
    # the decode loop made gen - 1 of them (the first is the prefill's)
    print(f"{cfg.name}: prefill {P} toks in {t_prefill:.2f}s, "
          f"decoded {args.gen} toks in {t_decode:.2f}s "
          f"({args.gen * B / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample generation (token ids):", gen[0, :12].tolist())
    if stats is not None:
        stats.update(
            prefill_s=t_prefill, decode_s=t_decode,
            decode_tok_s=(args.gen - 1) * B / max(t_decode, 1e-9),
            prefill_last_logits=last,
            prefill_launches={k: launches1[k] - launches0[k]
                              for k in launches0},
            decode_launches={k: launches2[k] - launches1[k]
                             for k in launches0})
    return gen


if __name__ == "__main__":
    main()
