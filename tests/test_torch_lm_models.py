"""The port's LM serving path (`repro_torch.models`, `repro_torch.launch`)
against the JAX package's (`repro.models.transformer`) on the CPU, in
float32: reduced internlm2-20b (dense GQA, with kv_heads 2 so that both the
group size and the KV head count exceed 1), reduced rwkv6-1.6b, reduced
jamba-1.5-large-398b (Mamba, MoE and attention layers; kv_heads 2),
reduced mixtral-8x7b (attention + MoE, sliding window), reduced qwen2-72b
(QKV bias, untied embeddings; kv_heads 2), reduced granite-34b (MQA),
reduced dbrx-132b at its real routing (16 experts, top 4; kv_heads 2) and
mixtral-8x7b with a window of 8, shorter than the prompt, so that the
ring cache wraps. The `repro` parameters are carried over through
`interop.model_params_from_numpy`; prefill logits and four decode steps'
logits agree to 1e-4 with the same greedy tokens. The prompt length (20)
is not a multiple of the reduced rwkv chunk (16); jamba's (32) is a
multiple of its reduced ssm chunk, because the reference's prefill with a
cache asserts it (the port's does not, `test_decode_cache_hands_over`).
The other families (MLA, the encoder-decoder, the patch prefix, the int8
cache) are held against `repro` in tests/test_torch_lm_families.py; their
parameter names and init statistics here.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.models import layers as jlayers
from repro.models import transformer as jt

from repro_torch import interop
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt

# case -> (config, the fields replaced in its reduced form), float32;
# internlm2's, jamba's, qwen2's and dbrx's reduced kv_heads would be 1
# (MQA), and dbrx's reduced routing top 2 of 4
CASES = {"internlm2-20b": ("internlm2-20b", dict(kv_heads=2)),
         "rwkv6-1.6b": ("rwkv6-1.6b", {}),
         "jamba-1.5-large-398b": ("jamba-1.5-large-398b", dict(kv_heads=2)),
         "mixtral-8x7b": ("mixtral-8x7b", {}),
         "qwen2-72b": ("qwen2-72b", dict(kv_heads=2)),
         "granite-34b": ("granite-34b", {}),
         "dbrx-132b": ("dbrx-132b", dict(kv_heads=2, n_experts=16,
                                         top_k=4)),
         "mixtral-8x7b-window8": ("mixtral-8x7b", dict(sliding_window=8))}
# the families tests/test_torch_lm_families.py serves, for the parameter
# and init tests here
FAMILIES = {"minicpm3-4b": ("minicpm3-4b", {}),
            "whisper-large-v3": ("whisper-large-v3", {}),
            "llava-next-34b": ("llava-next-34b", dict(kv_heads=2))}
B, PROMPT, STEPS = 2, 20, 4
# the reference's mamba prefill with a cache needs S % ssm_chunk == 0
PROMPTS = {"jamba-1.5-large-398b": 32}
TOL = dict(rtol=1e-4, atol=1e-4)


def configs(case):
    arch, kw = {**CASES, **FAMILIES}[case]
    kw = dict(kw, dtype="float32")
    return jget(arch).reduced().replace(**kw), tget(arch).reduced().replace(
        **kw)


def stacked_name(keys, i):
    """The port's parameter name of layer i's leaf at the reference path
    `keys` (under "layers" or "encoder", stacked on axis 0)."""
    return ".".join([keys[0], str(i), *keys[1:]])


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(JAX config, params), (port config, model) on the same weights."""
    cj, ct = configs(request.param)
    params = jt.init_model(jax.random.PRNGKey(0), cj)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return (cj, params), (ct, interop.model_params_from_numpy(
        tree, ct, device="cpu"))


@pytest.fixture(scope="module")
def runs(pair):
    """Prefill plus STEPS greedy decode steps in both packages."""
    (cj, params), (ct, model) = pair
    P = PROMPTS.get(cj.name, PROMPT)
    toks = np.random.default_rng(0).integers(0, cj.vocab_size, (B, P))
    cache_j = jt.init_cache(cj, B, P + STEPS)
    lj, cache_j = jax.jit(lambda p, c, b: jt.prefill(p, cj, b, c))(
        params, cache_j, {"tokens": jnp.asarray(toks)})
    cache_t = tt.init_cache(ct, B, P + STEPS, device="cpu")
    lt, cache_t = tt.prefill(model, ct, {"tokens": torch.tensor(toks)},
                             cache_t)
    step = jax.jit(lambda p, c, t, pos: jt.serve_step(p, cj, c, t, pos))
    tj, tk = jnp.argmax(lj[:, -1], -1), lt[:, -1].argmax(-1)
    dec = []
    for i in range(STEPS):
        dj, cache_j = step(params, cache_j, tj, jnp.asarray(P + i))
        dt, cache_t = tt.serve_step(model, ct, cache_t, tk, P + i)
        dec.append((np.asarray(tj), tk.numpy(), np.asarray(dj), dt.numpy()))
        tj, tk = jnp.argmax(dj, -1), dt.argmax(-1)
    return np.asarray(lj), lt.numpy(), dec


def test_configs_match_reference():
    assert sorted(TARCHS) == sorted(JARCHS)
    for name in JARCHS:
        fj, ft = dataclasses.asdict(jget(name)), dataclasses.asdict(
            tget(name))
        assert fj == ft, name
        assert dataclasses.asdict(jget(name).reduced()) == \
            dataclasses.asdict(tget(name).reduced()), name
    assert tget("internlm2-20b").torch_dtype == torch.bfloat16
    assert tget("rwkv6-1.6b").replace(dtype="float32").torch_dtype \
        == torch.float32


@pytest.mark.parametrize("arch", sorted(CASES) + sorted(FAMILIES))
def test_param_names_and_shapes_mirror_reference(arch):
    cj, ct = configs(arch)
    shapes = jax.eval_shape(lambda: jt.init_model(jax.random.PRNGKey(0), cj))
    model = tt.init_model(ct, 0, "cpu")
    ours = dict(model.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    stacked = {"layers": cj.n_periods, "encoder": cj.encoder_layers}
    assert len(ours) == sum(stacked.get(str(p[0].key), 1) for p, _ in flat)
    assert (cj.encoder_layers > 0) == any(n.startswith("encoder.")
                                          for n in ours)
    for path, leaf in flat:
        keys = [str(k.key) for k in path]
        if keys[0] in stacked:
            for i in range(stacked[keys[0]]):
                name = stacked_name(keys, i)
                assert tuple(ours[name].shape) == leaf.shape[1:], name
        else:
            assert tuple(ours[".".join(keys)].shape) == leaf.shape


@pytest.mark.parametrize("arch", sorted(CASES) + sorted(FAMILIES))
def test_init_matches_reference_statistics(arch):
    """Weights come from a torch.Generator, so they match the reference in
    distribution, not bit for bit: same means, scales and constants (the
    encoder's layers and MLA's sd of 0.02 included)."""
    cj, ct = configs(arch)
    params = jt.init_model(jax.random.PRNGKey(1), cj)
    tree = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    model = tt.init_model(ct, 1, "cpu")
    ours = dict(model.named_parameters())
    for path, leaf in tree.items():
        keys = [str(k.key) for k in path]
        layered = keys[0] in ("layers", "encoder")
        name = stacked_name(keys, 0) if layered else ".".join(keys)
        ref = np.asarray(leaf[0] if layered else leaf, np.float64)
        got = ours[name].double().numpy()
        if ref.std() == 0:
            np.testing.assert_array_equal(got, ref)
        elif keys[-1] == "a_log":     # log(1..N) in every channel
            np.testing.assert_allclose(got, ref, rtol=1e-6)
        elif ref.size >= 1024:
            assert got.std() == pytest.approx(ref.std(), rel=0.1), name
            assert abs(got.mean()) < 4 * ref.std() / np.sqrt(ref.size)
            if cj.attention == "mla" and keys[-2] == "attn":
                assert got.std() == pytest.approx(0.02, rel=0.1), name


def test_prefill_logits_match(runs):
    lj, lt, _ = runs
    assert lt.shape == lj.shape == (B, lj.shape[1], lt.shape[-1])
    assert lj.shape[1] in (PROMPT, *PROMPTS.values())
    np.testing.assert_allclose(lt, lj, **TOL)


def test_decode_logits_and_greedy_tokens_match(runs):
    _, _, dec = runs
    for tj, tk, dj, dt in dec:
        np.testing.assert_array_equal(tk, tj)
        np.testing.assert_allclose(dt, dj, **TOL)


def test_prefill_step_matches_prefill(pair):
    """`launch.steps.make_prefill_step` (no cache) gives the prefill's
    logits."""
    from repro_torch.launch.steps import make_prefill_step

    _, (ct, model) = pair
    toks = torch.randint(0, ct.vocab_size, (B, 9),
                         generator=torch.Generator().manual_seed(4))
    cache = tt.init_cache(ct, B, 9, device="cpu")
    with torch.no_grad():
        a = make_prefill_step(ct)(model, {"tokens": toks})
    b, _ = tt.prefill(model, ct, {"tokens": toks}, cache)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_decode_cache_hands_over(pair):
    """The logits of decoding token t after a prefill of P tokens equal
    the last-position logits of a prefill over the P + 1 tokens. P = 20 is
    no multiple of jamba's reduced ssm chunk: the port's mamba prefill
    hands its state over at any length. A MoE may drop the last token of
    the longer prefill past an expert's capacity, where the one-token
    decode step (capacity 1) never drops: the capacity factor here lets
    every token in (C = S), so the comparison is of the caches alone."""
    _, (ct, model) = pair
    if ct.n_experts:
        ct = ct.replace(capacity_factor=ct.n_experts / ct.top_k)
    toks = torch.randint(0, ct.vocab_size, (B, PROMPT + 1),
                         generator=torch.Generator().manual_seed(5))
    cache = tt.init_cache(ct, B, PROMPT + 1, device="cpu")
    _, cache = tt.prefill(model, ct, {"tokens": toks[:, :PROMPT]}, cache)
    dec, _ = tt.serve_step(model, ct, cache, toks[:, PROMPT], PROMPT)
    full, _ = tt.prefill(model, ct, {"tokens": toks},
                         tt.init_cache(ct, B, PROMPT + 1, device="cpu"))
    # the rwkv token shift is cached in bfloat16 (as in the reference), so
    # the decode step sees its inputs rounded where the prefill does not
    # (measured 1.6e-3 on logits of magnitude ~1)
    tol = 5e-3 if "rwkv" in ct.block_pattern else 1e-4
    torch.testing.assert_close(dec, full[:, -1], rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", sorted({a for a, _ in CASES.values()}))
def test_serve_main_runs_on_the_cpu(arch, capsys):
    stats = {}
    gen = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "24", "--gen", "5"],
                     stats=stats)
    assert gen.shape == (2, 5) and gen.dtype == torch.int64
    assert bool(torch.isfinite(stats["prefill_last_logits"]).all())
    # on the CPU the plain versions run: no kernel launch in either phase
    assert not any(stats["prefill_launches"].values())
    assert not any(stats["decode_launches"].values())
    out = capsys.readouterr().out
    assert "prefill 24 toks" in out and "decoded 5 toks" in out
    again = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "24", "--gen", "5"])
    assert torch.equal(gen, again)


def test_serve_main_serves_a_given_config(capsys):
    """`cfg=` replaces `--arch`'s config: here the reduced jamba cut to its
    first five layers (every layer kind), as chip_smoke.py serves the
    full-width cut."""
    red = tget("jamba-1.5-large-398b").reduced()
    cut = red.replace(n_layers=5, block_pattern=red.block_pattern[:5])
    argv = ["--device", "cpu", "--batch", "2", "--prompt-len", "24",
            "--gen", "3"]
    gen = serve.main(argv, cfg=cut)
    assert gen.shape == (2, 3)
    assert capsys.readouterr().out.startswith(
        "jamba-1.5-large-398b: prefill 24 toks")
    with pytest.raises(ValueError, match="both given"):
        serve.main(["--arch", "internlm2-20b", *argv], cfg=cut)


def test_layer_units_match_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.tensor(x), torch.tensor(scale)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)
    pos = np.arange(5)[None].repeat(2, 0)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlayers.rope_freqs(16, 1e4).numpy(),
                               np.asarray(jlayers.rope_freqs(16, 1e4)),
                               rtol=1e-6)
