"""Three-term roofline analysis per (arch x shape x mesh), at the H100's
constants.

Port of `repro/roofline/analysis.py`:

    compute term    = FLOPs / (devices x peak)
    memory term     = HBM bytes / HBM bandwidth     (per device)
    collective term = collective bytes / link bandwidth (per device)

Every term is analytic: explicit formulas over the architecture, the
shape and the sharding, the reference's own. The abstract pass's numbers
(`launch/dryrun.py`: FLOPs and bytes of the unsharded step, per-device
argument bytes) are recorded beside them as cross-checks
(`roofline_terms(..., compiler_record=...)`).

Constants: one NVIDIA H100 SXM (the card the port runs on: "NVIDIA H100
80GB HBM3", power limit 700 W, as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives it), from NVIDIA's data sheet, dense, no
sparsity:
  PEAK_FLOPS  989e12  bf16 tensor-core rate (the rate `chip_smoke.py`'s
                      kernel bounds use)
  HBM_BW      3.35e12 bytes/s of HBM3
  LINK_BW     50e9    bytes/s: one 400 Gb/s NDR InfiniBand port a GPU.
                      An HGX H100 node holds 8 GPUs on NVLink (900 GB/s a
                      GPU), but the production meshes' axes are 16 wide,
                      so a collective on either axis leaves the node, and
                      the per-GPU network port bounds it.
With these the dominant term may differ from the reference's (another
machine's balance of compute, memory and links).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

from ..configs import get_config
from ..configs.base import ModelConfig
from ..launch.specs import SHAPES, adapt_config

PEAK_FLOPS = 989e12        # bf16 / device (H100 SXM, dense)
HBM_BW = 3.35e12           # bytes/s / device (HBM3)
LINK_BW = 400e9 / 8        # bytes/s / device: one 400 Gb/s NDR port


# ---------------------------------------------------------------------------
# analytic per-layer forward FLOPs (per token unless noted)
# ---------------------------------------------------------------------------

def _attn_linear_flops(cfg: ModelConfig) -> float:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    if cfg.attention == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        return 2 * D * cfg.q_lora_rank + 2 * cfg.q_lora_rank * H * qk \
            + 2 * D * cfg.kv_lora_rank \
            + 2 * cfg.kv_lora_rank * H * (cfg.qk_nope_dim + cfg.v_head_dim) \
            + 2 * D * cfg.qk_rope_dim + 2 * H * cfg.v_head_dim * D
    return 2 * D * (H + 2 * KV) * hd + 2 * H * hd * D


def _attn_quadratic_flops(cfg: ModelConfig, ctx: float) -> float:
    """Score+value flops per token attending to `ctx` keys."""
    if cfg.attention == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        per_head = qk + cfg.v_head_dim
    else:
        per_head = 2 * cfg.head_dim
    return 2 * cfg.n_heads * ctx * per_head


def _mlp_flops(cfg: ModelConfig) -> float:
    return 2 * 3 * cfg.d_model * cfg.d_ff


def _moe_flops(cfg: ModelConfig) -> float:
    return 2 * 3 * cfg.d_model * cfg.d_ff * cfg.top_k \
        + 2 * cfg.d_model * cfg.n_experts


def _mamba_flops(cfg: ModelConfig) -> float:
    D, Di, N = cfg.d_model, cfg.d_inner, cfg.d_state
    dtr = max(D // 16, 1)
    return (2 * D * Di) * 2 + 2 * Di * cfg.d_conv \
        + 2 * Di * dtr * 2 + 2 * Di * 2 * N + 9 * Di * N + 2 * Di * D


def _rwkv_flops(cfg: ModelConfig) -> float:
    D, H, K, F = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    chunk = cfg.rwkv_chunk
    wkv = 2 * H * K * K + 3 * H * chunk * K       # state update + intra-chunk
    return 5 * 2 * D * D + 2 * D * 64 * 2 + 2 * D * D + wkv \
        + 2 * D * F * 2 + 2 * D * D               # channel mix


_KIND_FLOPS = {
    "attn":       lambda c: _attn_linear_flops(c) + _mlp_flops(c),
    "attn_moe":   lambda c: _attn_linear_flops(c) + _moe_flops(c),
    "attn_cross": lambda c: 2 * _attn_linear_flops(c) + _mlp_flops(c),
    "enc_attn":   lambda c: _attn_linear_flops(c) + _mlp_flops(c),
    "mamba":      lambda c: _mamba_flops(c) + _mlp_flops(c),
    "mamba_moe":  lambda c: _mamba_flops(c) + _moe_flops(c),
    "rwkv":       lambda c: _rwkv_flops(c),
}


def _layer_params(cfg: ModelConfig, kind: str) -> float:
    """Approximate parameter count of one layer of `kind`."""
    D = cfg.d_model
    if cfg.attention == "mla" and kind.startswith("attn"):
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        attn = D * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qk \
            + D * cfg.kv_lora_rank \
            + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim) \
            + D * cfg.qk_rope_dim + cfg.n_heads * cfg.v_head_dim * D
    else:
        attn = D * (cfg.n_heads + 2 * cfg.kv_heads) * cfg.head_dim \
            + cfg.n_heads * cfg.head_dim * D
    mlp = 3 * D * cfg.d_ff
    moe = 3 * D * cfg.d_ff * cfg.n_experts + D * cfg.n_experts
    # in_proj + gate_proj + out_proj (= 3 D*Di) + dt lora + bc proj + conv/A/D
    mamba = 3 * D * cfg.d_inner + 2 * cfg.d_inner * max(D // 16, 1) \
        + cfg.d_inner * (cfg.d_state * 2 + cfg.d_conv + 2 + cfg.d_state)
    rwkv = 7 * D * D + 2 * D * cfg.d_ff + D * 64
    return {
        "attn": attn + mlp, "attn_moe": attn + moe,
        "attn_cross": 2 * attn + mlp, "enc_attn": attn + mlp,
        "mamba": mamba + mlp, "mamba_moe": mamba + moe, "rwkv": rwkv,
    }[kind]


def params_total(cfg: ModelConfig) -> float:
    per_period = sum(_layer_params(cfg, k) for k in cfg.block_pattern)
    total = per_period * cfg.n_periods + cfg.vocab_size * cfg.d_model
    if not cfg.tied_embeddings:
        total += cfg.vocab_size * cfg.d_model
    if cfg.encoder_layers:
        total += cfg.encoder_layers * _layer_params(cfg, "enc_attn")
    return float(total)


def params_active(cfg: ModelConfig) -> float:
    """Active-path params (MoE: top_k of n_experts)."""
    def active(kind):
        p = _layer_params(cfg, kind)
        if kind.endswith("_moe"):
            moe_p = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts
            p = p - moe_p + moe_p * cfg.top_k / cfg.n_experts
        return p
    per_period = sum(active(k) for k in cfg.block_pattern)
    total = per_period * cfg.n_periods + cfg.vocab_size * cfg.d_model
    if not cfg.tied_embeddings:
        total += cfg.vocab_size * cfg.d_model
    if cfg.encoder_layers:
        total += cfg.encoder_layers * _layer_params(cfg, "enc_attn")
    return float(total)


# ---------------------------------------------------------------------------
# per-(arch, shape) analytic cost model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Costs:
    flops_global: float          # executed flops, whole step, all chips
    hbm_bytes_dev: float         # HBM traffic per device
    coll_bytes_dev: float        # collective bytes sent+received per device
    model_flops: float           # 6 N D (dense) / 6 N_active D (MoE), global
    tokens: float


def analytic_costs(arch: str, shape_name: str, multi_pod: bool = False,
                   expert_parallel: bool = True, accum_steps: int = 1,
                   cfg_overrides: Optional[dict] = None) -> Costs:
    cfg = adapt_config(get_config(arch), shape_name)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]
    kind = sh["kind"]
    chips = 512 if multi_pod else 256
    data_ax = 32 if multi_pod else 16
    model_ax = 16

    n_text = S - (cfg.n_patches or 0) if kind in ("train", "prefill") else 1
    tokens = float(B * (S if kind in ("train", "prefill") else 1))

    # context length each query attends to
    if kind in ("train", "prefill"):
        ctx = min(cfg.sliding_window, S) if cfg.sliding_window else S / 2
    else:
        ctx = min(cfg.sliding_window or S, S)

    per_tok = sum(_KIND_FLOPS[k](cfg) for k in cfg.block_pattern) * cfg.n_periods
    attn_layers = sum(1 for k in cfg.block_pattern
                      if k in ("attn", "attn_moe", "attn_cross")) * cfg.n_periods
    quad = _attn_quadratic_flops(cfg, ctx) * attn_layers
    logits = 2 * cfg.d_model * cfg.vocab_size
    fwd_per_tok = per_tok + quad + logits

    enc_flops = 0.0
    if cfg.encoder_layers:
        enc_per_tok = _KIND_FLOPS["enc_attn"](cfg) \
            + _attn_quadratic_flops(cfg, cfg.encoder_ctx)
        enc_flops = enc_per_tok * cfg.encoder_ctx * B * cfg.encoder_layers
        if kind == "train":
            enc_flops *= 4.0 if cfg.remat else 3.0
    if cfg.n_patches and kind == "decode":
        pass  # vlm decode: no patch reprocessing (cache holds them)

    remat_mult = {"full": 4.0, "dots": 3.15}.get(cfg.remat_policy, 4.0)
    mult = (remat_mult if cfg.remat else 3.0) if kind == "train" else 1.0
    flops_global = fwd_per_tok * tokens * mult + (
        enc_flops if kind != "decode" else 0.0)

    if cfg.encoder_layers and kind == "decode":
        # cross-attention reads encoder ctx per decode step either way
        flops_global += _attn_quadratic_flops(cfg, cfg.encoder_ctx) \
            * attn_layers * B
        if not cfg.cross_kv_cache:
            # BASELINE: encoder re-run + cross K/V projections every step
            xkv = 2 * 2 * cfg.encoder_ctx * cfg.d_model \
                * cfg.n_heads * cfg.head_dim * attn_layers * B
            flops_global += enc_flops + xkv

    P_total = params_total(cfg)
    P_dev = P_total * 2 / chips                       # bf16 shard per device

    # HBM traffic per device
    if kind == "train":
        opt_traffic = (P_total / chips) * (4 + 8 + 8 + 8 + 4)   # p, mu, nu rw
        act = tokens / data_ax * cfg.d_model * 2 * cfg.n_layers * 12 / model_ax
        hbm = 3 * P_dev + opt_traffic + act
    elif kind == "prefill":
        act = tokens / data_ax * cfg.d_model * 2 * cfg.n_layers * 8 / model_ax
        hbm = P_dev + act
    else:
        cache_slots = min(cfg.sliding_window or S, S)
        kv_bytes = (cfg.kv_lora_rank + cfg.qk_rope_dim if cfg.attention == "mla"
                    else 2 * cfg.kv_heads * cfg.head_dim)
        elem_bytes = (1.0 + 4.0 / cfg.head_dim) if cfg.kv_cache_int8 else 2.0
        cache = B * cache_slots * kv_bytes * elem_bytes * attn_layers / chips
        hbm = P_dev + cache

    # EP is only real when the expert count divides the model axis; otherwise
    # the shape-aware sharding has already fallen back to TP experts.
    expert_parallel = expert_parallel and cfg.n_experts > 0 \
        and cfg.n_experts % model_ax == 0

    # collective bytes per device (baseline FSDP+TP sharding)
    act_layer = tokens / data_ax * cfg.d_model * 2   # bf16 residual per device-batch
    if kind == "train":
        # FSDP gathers repeat per microbatch under gradient accumulation
        fsdp = (2 * accum_steps + 1) * P_dev * (data_ax - 1) / data_ax
        sp = 4 * act_layer * (model_ax - 1) / model_ax * cfg.n_layers
        coll = fsdp + sp
    elif kind == "prefill":
        fsdp = P_dev * (data_ax - 1) / data_ax
        sp = 2 * act_layer * (model_ax - 1) / model_ax * cfg.n_layers
        coll = fsdp + sp
    else:
        # TP all-reduce of the (B_loc, D) residual per layer, fwd only
        coll = 2 * act_layer * (model_ax - 1) / model_ax * cfg.n_layers

    if cfg.n_experts and expert_parallel:
        # EP all-to-all: dispatch + combine of routed tokens (there and back).
        # With expert_parallel=False experts are FSDP+TP-sharded and computed
        # locally on batch-sharded tokens: no all-to-all at all (the expert
        # weight gathers are inside the fsdp term already).
        moe_layers = sum(1 for k in cfg.block_pattern if k.endswith("_moe")) \
            * cfg.n_periods
        a2a = 4 * (tokens / data_ax) * cfg.top_k * cfg.d_model * 2 * moe_layers \
            * (model_ax - 1) / model_ax
        coll += a2a * (2 if kind == "train" else 1)

    # MODEL_FLOPS: 6 N_active D for training (fwd+bwd), 2 N_active D for
    # inference kinds (fwd only)
    model_flops = (6.0 if kind == "train" else 2.0) * params_active(cfg) * tokens
    return Costs(flops_global=float(flops_global), hbm_bytes_dev=float(hbm),
                 coll_bytes_dev=float(coll), model_flops=float(model_flops),
                 tokens=tokens)


def roofline_terms(arch: str, shape_name: str, multi_pod: bool = False,
                   compiler_record: Optional[dict] = None,
                   expert_parallel: bool = True, accum_steps: int = 1,
                   cfg_overrides: Optional[dict] = None) -> Dict:
    chips = 512 if multi_pod else 256
    c = analytic_costs(arch, shape_name, multi_pod,
                       expert_parallel=expert_parallel,
                       accum_steps=accum_steps,
                       cfg_overrides=cfg_overrides)
    t_compute = c.flops_global / (chips * PEAK_FLOPS)
    t_memory = c.hbm_bytes_dev / HBM_BW
    t_coll = c.coll_bytes_dev / LINK_BW
    terms = dict(compute=t_compute, memory=t_memory, collective=t_coll)
    dominant = max(terms, key=terms.get)
    out = dict(
        arch=arch, shape=shape_name, mesh="2x16x16" if multi_pod else "16x16",
        t_compute_s=t_compute, t_memory_s=t_memory, t_collective_s=t_coll,
        dominant=dominant,
        model_flops=c.model_flops, exec_flops=c.flops_global,
        useful_ratio=c.model_flops / max(c.flops_global, 1.0),
        tokens=c.tokens,
    )
    if compiler_record:
        # the dry run's record (launch/dryrun.py): flops, hbm_bytes and the
        # collectives' bytes per device, from its partitioned pass, as the
        # reference's; compile_s is None there (no compiler)
        coll = compiler_record.get("collectives") or {}
        out["compiler"] = dict(
            flops=compiler_record.get("flops"),
            hbm_bytes=compiler_record.get("hbm_bytes"),
            collective_bytes=coll.get("total_bytes"),
            temp_bytes=compiler_record.get("temp_bytes"),
            compile_s=compiler_record.get("compile_s"),
        )
    return out


def load_dryrun(jsonl_path: str) -> Dict:
    recs = {}
    with open(jsonl_path) as f:
        for line in f:
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def full_table(jsonl_path: Optional[str] = None, multi_pod: bool = False):
    """Roofline rows for every supported (arch, shape)."""
    from ..configs import ARCHS
    from ..launch.specs import supported

    recs = load_dryrun(jsonl_path) if jsonl_path else {}
    mesh = "2x16x16" if multi_pod else "16x16"
    rows = []
    for arch in ARCHS:
        for shape in SHAPES:
            if not supported(get_config(arch), shape):
                continue
            rows.append(roofline_terms(
                arch, shape, multi_pod,
                compiler_record=recs.get((arch, shape, mesh))))
    return rows


def markdown_table(rows) -> str:
    hdr = ("| arch | shape | compute (s) | memory (s) | collective (s) | "
           "dominant | useful FLOP ratio |")
    sep = "|---|---|---|---|---|---|---|"
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} |")
    return "\n".join(lines)
