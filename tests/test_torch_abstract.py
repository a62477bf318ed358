"""The port's abstract ("meta") path: `init_model` / `init_cache` /
`AdamW.init` on "meta" against the CPU build, the three LM custom ops'
fakes and FLOP formulas against their CPU outputs and the operation counts
`chip_smoke.py`'s bounds use, and each step function run on "meta"."""
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models.transformer import init_cache, init_model
from repro_torch.optim import AdamW


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def meta(t):
    return t.to("meta") if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_build_has_the_cpu_builds_names_shapes_dtypes(arch):
    cfg = ARCHS[arch].reduced()
    cpu, abstract = init_model(cfg, 0, "cpu"), init_model(cfg, 0, "meta")
    want = [(n, p.shape, p.dtype, p.requires_grad)
            for n, p in cpu.named_parameters()]
    got = [(n, p.shape, p.dtype, p.requires_grad)
           for n, p in abstract.named_parameters()]
    assert got == want
    assert all(p.device.type == "meta" for p in abstract.parameters())
    kw = dict(cross_kv_cache=True) if cfg.encoder_layers else {}
    cfg = cfg.replace(**kw)
    a = init_cache(cfg, 2, 16, device="cpu")
    b = init_cache(cfg, 2, 16, device="meta")
    flat = [(p, t.shape, t.dtype) for p, t in _leaves(a)]
    assert [(p, t.shape, t.dtype) for p, t in _leaves(b)] == flat
    assert all(t.device.type == "meta" for _, t in _leaves(b))
    params = dict(abstract.named_parameters())
    st = AdamW().init(params)
    assert st.step.device.type == "meta" and st.step.dtype == torch.int32
    assert {n: (m.shape, m.dtype) for n, m in st.mu.items()} == \
        {n: (p.shape, torch.float32) for n, p in params.items()}


def _leaves(tree, prefix=""):
    from repro_torch.sharding.partition import _iter_paths
    return list(_iter_paths(tree, prefix))


def test_full_width_meta_build_draws_nothing():
    cfg = ARCHS["jamba-1.5-large-398b"]
    model = init_model(cfg, 0, "meta")
    n = sum(p.numel() for p in model.parameters())
    assert n > 3.5e11 and all(p.is_meta for p in model.parameters())


def flash_args(S=37, T=37, causal=True, window=None):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, S, 16, generator=g)
    k = torch.randn(2, 2, T, 16, generator=g)
    v = torch.randn(2, 2, T, 8, generator=g)
    return (q, k, v, causal, window, None)


def rwkv_args(T=45, chunk=16):
    g = torch.Generator().manual_seed(1)
    r, k, v = (torch.randn(2, T, 3, 8, generator=g) for _ in range(3))
    logw = -torch.rand(2, T, 3, 8, generator=g)
    return (r, k, v, logw, torch.randn(3, 8, generator=g), chunk)


def mamba_args(T=29):
    g = torch.Generator().manual_seed(2)
    dt = torch.rand(2, T, 12, generator=g) * 0.1
    A = -torch.rand(12, 4, generator=g)
    Bt, Ct = torch.randn(2, T, 4, generator=g), torch.randn(2, T, 4,
                                                            generator=g)
    return (dt, A, Bt, Ct, torch.randn(2, T, 12, generator=g))


OPS = {
    "flash_attention": (kops.flash_attention_op, flash_args,
                        lambda q, k, v, c, w, s: kops.flash_attention_flops(
                            q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                            q.shape[3], v.shape[3], c, w)),
    "rwkv6_scan": (kops.rwkv6_scan_op, rwkv_args,
                   lambda r, *_: kops.rwkv6_scan_flops(*r.shape)),
    "mamba_scan": (kops.mamba_scan_op, mamba_args,
                   lambda dt, A, Bt, Ct, x: kops.mamba_scan_flops(
                       *x.shape, A.shape[1])),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_custom_op_fake_and_flops(name):
    op, make, formula = OPS[name]
    args = make()
    with FlopCounterMode(display=False) as fc_cpu:
        out = op(*args)
    with FlopCounterMode(display=False) as fc_meta:
        fake = op(*(meta(a) for a in args))
    out = out if isinstance(out, tuple) else (out,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.device.type, f.shape, f.dtype) for f in fake] == \
        [("meta", o.shape, o.dtype) for o in out]
    assert fc_cpu.get_total_flops() == fc_meta.get_total_flops() == \
        formula(*args)


def test_formulas_are_the_bounds_counts():
    """The formulas at the kernels' timed shapes are chip_smoke.py's bound
    counts: causal pairs S (S + 1) / 2, B H pairs 2 (hd + vd); rwkv6
    B T H (5 K^2 + 6 K); mamba 8 B T D N."""
    B, H, S, hd = 4, 48, 2048, 128
    assert kops.flash_attention_flops(B, H, S, S, hd, hd, True, None) == \
        B * H * (S * (S + 1) // 2) * 2 * (hd + hd)
    assert kops.flash_attention_flops(4, 20, 416, 1500, 64, 64, False,
                                      None) == 4 * 20 * 416 * 1500 * 2 * 128
    assert kops.rwkv6_scan_flops(4, 2048, 32, 64) == \
        4 * 2048 * 32 * (5 * 64 * 64 + 6 * 64)
    assert kops.mamba_scan_flops(4, 2048, 16384, 16) == \
        8 * 4 * 2048 * 16384 * 16


@pytest.mark.parametrize("S, T", [(1, 1), (5, 9), (9, 5), (16, 16), (3, 40)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 4, 64])
def test_kept_pairs_counts_the_mask(S, T, causal, window):
    want = int(fa._mask(S, T, causal, window, "cpu").sum())
    assert kops.kept_pairs(S, T, causal, window) == want


def test_meta_never_reaches_a_plain_version(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a meta tensor reached a plain version")

    for mod, name in ((fa, "flash_attention_ref"), (rw, "rwkv6_scan_ref"),
                      (ms, "mamba_scan_ref")):
        monkeypatch.setattr(mod, name, refuse)
    q, k, v, causal, window, _ = flash_args()
    out = kops.flash_attention(meta(q), meta(k), meta(v), causal=causal)
    assert out.is_meta
    r, k, v, logw, u, chunk = rwkv_args()
    o, S = kops.rwkv6_scan(*(meta(t) for t in (r, k, v, logw, u)),
                           chunk=chunk)
    assert o.is_meta and S.is_meta
    y, h = kops.mamba_scan(*(meta(t) for t in mamba_args()))
    assert y.is_meta and h.is_meta
    with pytest.raises(AssertionError, match="plain version"):
        kops.flash_attention(q, k, v)


@pytest.mark.parametrize("arch", ["internlm2-20b", "jamba-1.5-large-398b",
                                  "rwkv6-1.6b", "whisper-large-v3",
                                  "minicpm3-4b"])
def test_steps_run_on_meta(arch):
    """Train (with remat and accumulation), prefill and decode on "meta":
    the outputs' shapes, and FLOPs counted (the kernels' formulas among
    them)."""
    cfg = ARCHS[arch].reduced().replace(remat=True)
    B, S = 4, 32
    model = init_model(cfg, 0, "meta")
    toks = torch.empty((B, S), dtype=torch.int32, device="meta")
    extras = {}
    if cfg.encoder_layers:
        extras["frame_embeds"] = torch.empty(
            (B, cfg.encoder_ctx, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
    step, opt = make_train_step(cfg, accum_steps=2)
    state = opt.init(dict(model.named_parameters()))
    with FlopCounterMode(display=False) as fc:
        _, state, m = step(model, state, {"tokens": toks, **extras})
    assert m["loss"].is_meta and m["loss"].shape == () \
        and fc.get_total_flops() > 0
    logits = make_prefill_step(cfg)(model, {"tokens": toks, **extras})
    assert logits.shape == (B, S, cfg.vocab_size) and logits.is_meta
    cache = init_cache(cfg, B, 64, device="meta")
    tok = torch.empty((B,), dtype=torch.int32, device="meta")
    logits, cache = make_serve_step(cfg)(model, cache, tok, 63,
                                         extras or None)
    assert logits.shape == (B, cfg.vocab_size) and logits.is_meta
