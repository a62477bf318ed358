"""The port's remaining LM serving options against the JAX package's
(`repro.models.transformer`) on the CPU, in float32: MLA (reduced
minicpm3-4b, latent cache), the encoder-decoder (reduced whisper-large-v3:
frames in every step's extras, and the encoder run once by
`prepare_cross_cache` with cached cross K/V), the patch prefix (reduced
llava-next-34b with `patch_embeds`, decode at n_patches + P) and the int8
KV cache (reduced internlm2-20b, and mixtral-8x7b with its window of 64).
The `repro` parameters are carried over through
`interop.model_params_from_numpy`; inputs are drawn with numpy from a seed.
Prefill logits and four decode steps' logits agree to 1e-4 with the same
greedy tokens, and the int8 caches hold the reference's codes and scales.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import transformer as jt

from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt

# case -> (config, the fields replaced in its reduced form). internlm2's
# and llava's reduced kv_heads would be 1 (MQA).
CASES = {
    "minicpm3-4b": ("minicpm3-4b", {}),
    "whisper-large-v3": ("whisper-large-v3", {}),
    "whisper-large-v3-cross-cache": ("whisper-large-v3",
                                     dict(cross_kv_cache=True)),
    "llava-next-34b": ("llava-next-34b", dict(kv_heads=2)),
    "internlm2-20b-int8": ("internlm2-20b", dict(kv_heads=2,
                                                 kv_cache_int8=True)),
    "mixtral-8x7b-int8": ("mixtral-8x7b", dict(kv_cache_int8=True)),
}
B, PROMPT, STEPS = 2, 20, 4
TOL = dict(rtol=1e-4, atol=1e-4)
FRAME_SCALE, PATCH_SCALE = 0.1, 0.02


def configs(case):
    arch, kw = CASES[case]
    kw = dict(kw, dtype="float32")
    return jget(arch).reduced().replace(**kw), tget(arch).reduced().replace(
        **kw)


def extras_np(cfg, seed=3):
    """The non-token inputs of a case, drawn with numpy: encoder frames or
    projected patch embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.encoder_layers:
        return {"frame_embeds": (rng.standard_normal(
            (B, cfg.encoder_ctx, cfg.d_model)) * FRAME_SCALE).astype(
                np.float32)}
    if cfg.n_patches:
        return {"patch_embeds": (rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)) * PATCH_SCALE).astype(
                np.float32)}
    return {}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(JAX config, params), (port config, model) on the same weights."""
    cj, ct = configs(request.param)
    params = jt.init_model(jax.random.PRNGKey(0), cj)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return (cj, params), (ct, interop.model_params_from_numpy(
        tree, ct, device="cpu"))


def run_reference(cj, params, toks, ex):
    """Prefill plus STEPS greedy decode steps in `repro`: (prefill logits,
    [(token fed, logits)], final cache). Frames go to the prefill and to
    every step, or to `prepare_cross_cache` once on the cross-cache
    path."""
    P = toks.shape[1] + cj.n_patches * ("patch_embeds" in ex)
    cache = jt.init_cache(cj, B, P + STEPS)
    batch = {"tokens": jnp.asarray(toks)}
    step_ex = None
    if cj.cross_kv_cache:
        cache, _ = jt.prepare_cross_cache(params, cj, cache,
                                          jnp.asarray(ex["frame_embeds"]))
    else:
        batch.update({k: jnp.asarray(v) for k, v in ex.items()})
        if "frame_embeds" in ex:
            step_ex = {"frame_embeds": batch["frame_embeds"]}
    logits, cache = jax.jit(lambda p, c, b: jt.prefill(p, cj, b, c))(
        params, cache, batch)
    step = jax.jit(lambda p, c, t, pos, e: jt.serve_step(p, cj, c, t, pos,
                                                         e))
    tok, dec = jnp.argmax(logits[:, -1], -1), []
    for i in range(STEPS):
        d, cache = step(params, cache, tok, jnp.asarray(P + i), step_ex)
        dec.append((np.asarray(tok), np.asarray(d)))
        tok = jnp.argmax(d, -1)
    return np.asarray(logits), dec, cache


def run_port(ct, model, toks, ex):
    """The same in the port: (prefill logits, [(token fed, logits)], final
    cache)."""
    P = toks.shape[1] + ct.n_patches * ("patch_embeds" in ex)
    cache = tt.init_cache(ct, B, P + STEPS, device="cpu")
    batch = {"tokens": torch.tensor(toks)}
    step_ex = None
    if ct.cross_kv_cache:
        cache, _ = tt.prepare_cross_cache(
            model, ct, cache, torch.tensor(ex["frame_embeds"]))
    else:
        batch.update({k: torch.tensor(v) for k, v in ex.items()})
        if "frame_embeds" in ex:
            step_ex = {"frame_embeds": batch["frame_embeds"]}
    logits, cache = tt.prefill(model, ct, batch, cache)
    tok, dec = logits[:, -1].argmax(-1), []
    for i in range(STEPS):
        d, cache = tt.serve_step(model, ct, cache, tok, P + i, step_ex)
        dec.append((tok.numpy(), d.numpy()))
        tok = d.argmax(-1)
    return logits.numpy(), dec, cache


@pytest.fixture(scope="module")
def runs(pair):
    (cj, params), (ct, model) = pair
    toks = np.random.default_rng(0).integers(0, cj.vocab_size, (B, PROMPT))
    ex = extras_np(cj)
    return run_reference(cj, params, toks, ex), run_port(ct, model, toks, ex)


def test_prefill_logits_match(pair, runs):
    (cj, _), _ = pair
    (lj, _, _), (lt, _, _) = runs
    n_pre = cj.n_patches if cj.n_patches else 0
    assert lt.shape == lj.shape == (B, PROMPT + n_pre, cj.vocab_size)
    np.testing.assert_allclose(lt, lj, **TOL)


def test_decode_logits_and_greedy_tokens_match(runs):
    (_, dec_j, _), (_, dec_t, _) = runs
    for (tj, dj), (tk, dt) in zip(dec_j, dec_t):
        np.testing.assert_array_equal(tk, tj)
        np.testing.assert_allclose(dt, dj, **TOL)


def cache_leaves_np(cache_t):
    """The port's cache as the reference lays it out: each leaf stacked
    over periods, keyed by slot and field."""
    out = {}
    for nm in cache_t[0]:
        entry = cache_t[0][nm]
        entry = entry["self"] if isinstance(entry, dict) else entry
        for field in entry._fields:
            out[(nm, field)] = np.stack([getattr(
                (c[nm]["self"] if isinstance(c[nm], dict) else c[nm]), field)
                .numpy() for c in cache_t])
    return out


def test_filled_caches_match(pair, runs):
    """After the prefill and the decode steps, every cache leaf equals the
    reference's: MLA latents and roped keys, K/V (the patch prefix's
    included), and for the int8 caches the codes exactly. A scale is
    max |k| / 127 of a key that the two packages form by float32 products
    summed in different orders (a few ulps apart, as the logits are), so
    the scales agree to 1e-5 relative;
    `test_quantize_and_fill_match_reference` holds them bitwise on equal
    inputs."""
    _, (ct, _) = pair
    (_, _, cache_j), (_, _, cache_t) = runs
    ours = cache_leaves_np(cache_t)
    for (nm, field), got in ours.items():
        ref = cache_j[nm]
        ref = ref["self"] if isinstance(ref, dict) else ref
        ref = np.asarray(getattr(ref, field))
        assert got.shape == ref.shape, (nm, field)
        if got.dtype == np.int8:
            np.testing.assert_array_equal(got, ref, err_msg=f"{nm}.{field}")
        elif field.endswith("scale"):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0,
                                       err_msg=f"{nm}.{field}")
        else:
            np.testing.assert_allclose(got, ref, **TOL,
                                       err_msg=f"{nm}.{field}")
    assert any(f in ("qk", "c_kv", "k") for _, f in ours)
    if ct.kv_cache_int8:
        assert {f for _, f in ours} == {"qk", "qv", "k_scale", "v_scale"}


@pytest.mark.parametrize("window", [None, 8])
def test_quantize_and_fill_match_reference(window):
    """The same roped K/V into an int8 cache in both packages: codes and
    scales bitwise equal, a ring cache (8 slots, 20 positions) included,
    with a row of zeros (the scale's floor of 1e-8) and rows whose largest
    element dwarfs the rest."""
    rng = np.random.default_rng(11)
    S, KV, hd = 20, 2, 16
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    k[0, 3] = 0.0
    v[1, 5, 1, :2] = [254.0, -0.5]
    slots = window or S
    cj = jattn.init_kv_cache(B, slots, KV, hd, jnp.float32, quantized=True)
    cj = jattn._fill_cache(cj, jnp.asarray(k), jnp.asarray(v))
    ct = tattn.init_kv_cache(B, slots, KV, hd, torch.float32, quantized=True,
                             device="cpu")
    ct = tattn._fill_cache(ct, torch.tensor(k), torch.tensor(v))
    for field in ("qk", "qv", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(ct, field).numpy(),
                                      np.asarray(getattr(cj, field)),
                                      err_msg=field)
    q, s = tattn._quantize(torch.tensor(k))
    back = tattn._dequantize(q, s, torch.float32).numpy()
    np.testing.assert_allclose(back, k, rtol=0,
                               atol=float(s.max()) / 2 * (1 + 1e-6))


def test_whisper_cross_cache_path_matches_frames_path():
    """`prepare_cross_cache` then prefill and decode without frames gives
    the logits of feeding the frames to the prefill and every step."""
    _, ct = configs("whisper-large-v3-cross-cache")
    model = tt.init_model(ct, 0, "cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, ct.vocab_size, (B, PROMPT)))
    ex = extras_np(ct)
    a = run_port(ct, model, toks.numpy(), ex)
    b = run_port(ct.replace(cross_kv_cache=False), model, toks.numpy(), ex)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-5)
    for (ta, da), (tb, db) in zip(a[1], b[1]):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-5)


def test_cross_attention_needs_an_encoder_output():
    _, ct = configs("whisper-large-v3")
    model = tt.init_model(ct, 0, "cpu")
    toks = torch.zeros((B, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="no encoder output"):
        tt.prefill(model, ct, {"tokens": toks},
                   tt.init_cache(ct, B, 4, device="cpu"))
    with pytest.raises(ValueError, match="cross_kv_cache"):
        tt.prepare_cross_cache(model, ct, tt.init_cache(ct, B, 4, "cpu"),
                               torch.zeros((B, ct.encoder_ctx, ct.d_model)))


@pytest.mark.parametrize("case", ["minicpm3-4b",
                                  "whisper-large-v3-cross-cache",
                                  "llava-next-34b"])
def test_decode_cache_hands_over(case):
    """Decoding token t after a prefill of P positions gives the
    last-position logits of a prefill over the P + 1 (the MLA latent
    cache, the cached cross K/V, the patch prefix's slots)."""
    _, ct = configs(case)
    model = tt.init_model(ct, 0, "cpu")
    toks = torch.tensor(np.random.default_rng(5).integers(
        0, ct.vocab_size, (B, PROMPT + 1)))
    ex = {k: torch.tensor(v) for k, v in extras_np(ct).items()}
    n = PROMPT + 1 + ct.n_patches * ("patch_embeds" in ex)

    def fresh():
        cache = tt.init_cache(ct, B, n, device="cpu")
        if ct.cross_kv_cache:
            tt.prepare_cross_cache(model, ct, cache, ex["frame_embeds"])
        return cache

    batch = {} if ct.cross_kv_cache else ex
    _, cache = tt.prefill(model, ct, {"tokens": toks[:, :PROMPT], **batch},
                          fresh())
    dec, _ = tt.serve_step(model, ct, cache, toks[:, PROMPT], n - 1)
    full, _ = tt.prefill(model, ct, {"tokens": toks, **batch}, fresh())
    torch.testing.assert_close(dec, full[:, -1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "whisper-large-v3",
                                  "llava-next-34b"])
def test_serve_main_runs_on_the_cpu(arch, capsys):
    stats = {}
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "24", "--gen", "5"]
    gen = serve.main(argv, stats=stats)
    assert gen.shape == (2, 5) and gen.dtype == torch.int64
    assert bool(torch.isfinite(stats["prefill_last_logits"]).all())
    assert not any(stats["prefill_launches"].values())
    assert not any(stats["decode_launches"].values())
    assert "prefill 24 toks" in capsys.readouterr().out
    assert torch.equal(gen, serve.main(argv))


def test_serve_main_takes_an_int8_cache(capsys):
    cfg = tget("internlm2-20b").reduced().replace(kv_cache_int8=True)
    argv = ["--device", "cpu", "--batch", "2", "--prompt-len", "24",
            "--gen", "5"]
    gen = serve.main(argv, cfg=cfg)
    assert gen.shape == (2, 5)
    assert torch.equal(gen, serve.main(argv, cfg=cfg))
    cache = tt.init_cache(cfg, 2, 29, device="cpu")
    assert isinstance(cache[0]["s0_attn"], tattn.QuantKVCache)
    assert cache[0]["s0_attn"].qk.dtype == torch.int8
