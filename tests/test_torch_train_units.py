"""The port's training units against the JAX package's on the CPU:
`optim` (AdamW, SGD, the schedules, the global-norm clip) fed the
reference's gradients, the token pipeline (`data`) bit for bit, the
checkpoint's leaf files (`checkpoint`) byte for byte and its manifest's
content, and each LM kernel's `torch.autograd.Function` (`kernels.ops`)
against autograd straight through its plain version.

Tolerances: the optimizer to 1e-7 relative (both compute in float32 in
the same order; b^step is a pow that may differ in its last bit); the
schedules' values alone to two float32 ulps (2.4e-7 relative: XLA's
float32 cos is its own approximation, as its exp is, ROADMAP Queue 3); the
kernel Functions' outputs and input gradients to 1e-5 of each tensor's
largest magnitude, in float32 (the backward goes through the training
formulation, the plain version through the kernel's own form: the same
function summed in other orders).
"""
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import checkpoint as jckpt
from repro import data as jdata
from repro import optim as joptim
from repro.configs import get_config as jget
from repro.models import transformer as jt

from repro_torch import checkpoint as tckpt
from repro_torch import data as tdata
from repro_torch import interop
from repro_torch import optim as toptim
from repro_torch.configs import get_config as tget
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt

from _torch_train import params_from_tree

OPT_TOL = 1e-7
SCHEDULE_TOL = 2.4e-7
FN_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small tensors: with several
    test workers on the machine, PyTorch's default of one thread a core
    oversubscribes it, and these ops then wait on each other's threads
    (a 0.6 s test took 90 s in a 6-worker run)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tree_np(seed, shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(dtype) for k, s in shapes.items()}


SHAPES = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}


def as_torch(d):
    return {k: torch.tensor(v) for k, v in d.items()}


@pytest.mark.parametrize("make", [
    lambda m, lr: m.AdamW(lr=lr),
    lambda m, lr: m.AdamW(lr=lr, b1=0.8, b2=0.99, weight_decay=0.0),
    lambda m, lr: m.SGD(lr=lr),
    lambda m, lr: m.SGD(lr=lr, momentum=0.9)])
@pytest.mark.parametrize("schedule", ["const", "cosine", "linear"])
def test_optimizers_match_reference(make, schedule):
    """Four steps on the reference's gradients: parameters and moments."""
    def lr(m):
        if schedule == "const":
            return 3e-3
        sched = getattr(m, f"{schedule}_schedule")
        return sched(3e-3, 2, 4)

    params = tree_np(0, SHAPES)
    jopt, topt = make(joptim, lr(joptim)), make(toptim, lr(toptim))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = as_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(4):
        g = tree_np(10 + i, SHAPES)
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        ts = topt.update(as_torch(g), ts, tp)
    assert int(ts.step) == int(js.step) == 4
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=OPT_TOL, atol=OPT_TOL * 1e-3)
        for f in ("mu", "nu"):
            jm, tm = getattr(js, f), getattr(ts, f)
            assert (jm is None) == (tm is None)
            if jm is not None:
                np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                           rtol=OPT_TOL, atol=1e-12)


@pytest.mark.parametrize("name", ["cosine_schedule", "linear_schedule"])
def test_schedules_match_reference(name):
    jf, tf = getattr(joptim, name)(1e-2, 5, 50), getattr(toptim, name)(
        1e-2, 5, 50)
    steps = np.arange(0, 60)
    got = np.array([float(tf(torch.tensor(s, dtype=torch.int32)))
                    for s in steps])
    ref = np.array([float(jf(jnp.asarray(s, jnp.int32))) for s in steps])
    np.testing.assert_allclose(got, ref, rtol=SCHEDULE_TOL, atol=1e-12)


def test_adamw_bf16_params_keep_float32_state_and_fold_the_clip():
    """bf16 parameters: the update in float32, cast back once; the clip
    scale folded into update(grad_scale=) equals the reference's clipped
    (float32) gradients fed to its update."""
    p32 = tree_np(1, SHAPES)
    g32 = tree_np(2, SHAPES)
    tp = {k: torch.tensor(v).bfloat16() for k, v in p32.items()}
    tg = {k: torch.tensor(v).bfloat16() for k, v in g32.items()}
    jp = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
          for k, v in tp.items()}
    jg = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
          for k, v in tg.items()}
    jopt, topt = joptim.AdamW(lr=1e-2), toptim.AdamW(lr=1e-2)
    jclipped, jnorm = joptim.clip_by_global_norm(jg, 0.5)
    jp2, js = jopt.update(jclipped, jopt.init(jp), jp)
    norm = toptim.global_norm(tg)
    ts = topt.init(tp)
    assert all(m.dtype == torch.float32 for m in ts.mu.values())
    ts = topt.update(tg, ts, tp, grad_scale=toptim.clip_scale(norm, 0.5))
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    for k in SHAPES:
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp[k].float().numpy(), np.asarray(jp2[k].astype(jnp.float32)))
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                   rtol=OPT_TOL, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = tree_np(3, SHAPES)
    jc, jn = joptim.clip_by_global_norm({k: jnp.asarray(v)
                                         for k, v in g.items()}, max_norm)
    tc, tn = toptim.clip_by_global_norm(as_torch(g), max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6, atol=1e-12)
    if max_norm > 1e2:     # no clip: the leaves come back unchanged
        assert all(np.array_equal(tc[k].numpy(), g[k]) for k in SHAPES)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("host_count", [1, 2])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_pipeline_tokens_match_reference_bit_for_bit(seed, host_count,
                                                     prefetch):
    for host in range(host_count):
        kw = dict(seed=seed, host_index=host, host_count=host_count,
                  prefetch=prefetch)
        a = jdata.make_pipeline(1000, 8, 64, **kw)
        b = tdata.make_pipeline(1000, 8, 64, **kw)
        for _ in range(3):
            x, y = next(a)["tokens"], next(b)["tokens"]
            assert x.dtype == y.dtype == np.int32
            assert x.shape == y.shape == (8 // host_count, 64)
            np.testing.assert_array_equal(y, x)
    sa = next(iter(jdata.SyntheticLM(500, 4, 32, seed=seed)))
    sb = next(iter(tdata.SyntheticLM(500, 4, 32, seed=seed)))
    np.testing.assert_array_equal(sb["tokens"], sa["tokens"])
    halves = [tdata.shard_for_host(sb, i, 2)["tokens"] for i in range(2)]
    np.testing.assert_array_equal(np.concatenate(halves), sb["tokens"])


@pytest.fixture(scope="module")
def trees():
    """The reduced rwkv6-1.6b's parameters in bf16 (the reference's init)
    and float32, AdamW states of both after one update on the same
    gradients: the reference's trees and the port's, on equal values."""
    out = {}
    for dtype in ("bfloat16", "float32"):
        cj = jget("rwkv6-1.6b").reduced().replace(dtype=dtype)
        ct = tget("rwkv6-1.6b").reduced().replace(dtype=dtype)
        params = jt.init_model(jax.random.PRNGKey(0), cj)
        model = interop.model_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), ct, device="cpu")
        grads = jax.tree_util.tree_map(
            lambda p: (jnp.ones_like(p) * 1e-3).astype(p.dtype), params)
        jopt, topt = joptim.AdamW(lr=1e-3), toptim.AdamW(lr=1e-3)
        jp, js = jopt.update(grads, jopt.init(params), params)
        named = dict(model.named_parameters())
        ts = topt.update(
            params_from_tree(model, jax.tree_util.tree_map(
                lambda g: torch.tensor(np.asarray(g, np.float32)), grads)),
            topt.init(named), named)
        ttree = {"params": tt.param_tree(model),
                 "opt": toptim.AdamWState(ts.step, tt.param_tree(model, ts.mu),
                                          tt.param_tree(model, ts.nu))}
        jtree = {"params": jp, "opt": js}
        out[dtype] = (jtree, ttree, model)
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_checkpoint_leaf_files_match_reference_byte_for_byte(trees, dtype,
                                                             tmp_path):
    jtree, ttree, _ = trees[dtype]
    jckpt.save(str(tmp_path / "ref"), jtree, step=1)
    tckpt.save(str(tmp_path / "port"), ttree, step=1)
    ref_files = sorted(f for f in os.listdir(tmp_path / "ref")
                       if f.endswith(".bin"))
    port_files = sorted(f for f in os.listdir(tmp_path / "port")
                        if f.endswith(".bin"))
    assert port_files == ref_files
    assert "params__layers__s0_rwkv__rwkv__tm_r_proj.bin" in port_files
    assert "opt__step.bin" in port_files and "opt__mu__embed__tokens.bin" \
        in port_files
    for f in ref_files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes(), f
    msgpack = pytest.importorskip("msgpack")
    ref_manifest = msgpack.unpackb(
        (tmp_path / "ref" / "manifest.msgpack").read_bytes())
    port_manifest = json.loads((tmp_path / "port" /
                                tckpt.checkpoint.MANIFEST).read_text())
    assert port_manifest == ref_manifest
    assert port_manifest["leaves"]["params/embed/tokens"]["dtype"] == dtype


def test_checkpoint_restore_round_trip(trees, tmp_path):
    _, ttree, model = trees["bfloat16"]
    tckpt.save(str(tmp_path), ttree, step=7)
    assert tckpt.latest_step(str(tmp_path)) == 7
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    back = tckpt.restore(str(tmp_path), ttree)
    assert isinstance(back["opt"], toptim.AdamWState)
    flat_a = dict(tckpt.checkpoint._flatten(ttree))
    flat_b = dict(tckpt.checkpoint._flatten(back))
    assert sorted(flat_a) == sorted(flat_b)
    for k, a in flat_a.items():
        assert flat_b[k].dtype == a.dtype and torch.equal(flat_b[k], a), k
    # the parameters go back into a model by name
    named = params_from_tree(model, back["params"])
    for n, p in model.named_parameters():
        assert torch.equal(named[n], p.detach())


def test_param_tree_inverts_interop():
    """param_tree gives the reference's own tree back from a model built
    by interop.model_params_from_numpy (every leaf, stacked over periods
    and encoder layers)."""
    for arch in ("whisper-large-v3", "jamba-1.5-large-398b"):
        cj = jget(arch).reduced().replace(dtype="float32")
        params = jax.tree_util.tree_map(
            np.asarray, jt.init_model(jax.random.PRNGKey(1), cj))
        model = interop.model_params_from_numpy(
            params, tget(arch).reduced().replace(dtype="float32"),
            device="cpu")
        back = tt.param_tree(model)
        ref = dict(jax.tree_util.tree_flatten_with_path(params)[0])
        got = dict(tckpt.checkpoint._flatten(back))
        assert len(got) == len(ref)
        for path, leaf in ref.items():
            name = "/".join(str(k.key) for k in path)
            np.testing.assert_array_equal(got[name].numpy(), leaf)


# ---------------------------------------------------------------------------
# the kernel Functions against autograd through the plain versions
# ---------------------------------------------------------------------------

def check_function(fn, plain, inputs, seed=0):
    """Outputs and every input gradient of `fn` (a kernels.ops entry)
    against autograd through `plain`, on a random cotangent."""
    g = torch.Generator().manual_seed(seed)
    res = {}
    for name, f in (("fn", fn), ("plain", plain)):
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = f(*xs)
        out = out if isinstance(out, tuple) else (out,)
        if name == "fn":
            co = torch.randn(out[0].shape, generator=g)
        grads = torch.autograd.grad(out[0], xs, co)
        res[name] = ([o.detach() for o in out], grads)
    (o1, g1), (o2, g2) = res["fn"], res["plain"]
    for a, b in zip(o1, o2):
        assert torch.equal(a, b)     # the CPU forward is the plain version
    for i, (a, b) in enumerate(zip(g1, g2)):
        scale = float(b.abs().max())
        assert scale > 0, i
        assert float((a - b).abs().max()) <= FN_TOL * scale, i


def qkv(B, H, KV, S, T, hd, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, H, S, hd), generator=g),
            torch.randn((B, KV, T, hd), generator=g),
            torch.randn((B, KV, T, hd), generator=g))


@pytest.mark.parametrize("causal, window, S, T", [
    (True, None, 37, 37), (True, 8, 37, 37), (False, None, 21, 30)])
def test_flash_function_matches_autograd_through_plain(causal, window, S, T):
    """GQA 3:1, ragged lengths; the chunked formulation at a chunk of 16
    so that several query chunks (the last one short) are differentiated."""
    back = functools.partial(_chunked_heads_first, chunk=16)
    inputs = qkv(2, 6, 2, S, T, 16)
    check_function(
        lambda q, k, v: kops.flash_attention(q, k, v, causal=causal,
                                             window=window, scale=0.3,
                                             backward=back),
        lambda q, k, v: fa.flash_attention_ref(q, k, v, causal=causal,
                                               window=window, scale=0.3),
        inputs)


def _chunked_heads_first(q, k, v, *, causal, window, scale, chunk):
    return tattn._chunked_attn(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window, scale=scale,
                               chunk=chunk).transpose(1, 2)


def test_flash_function_in_the_model_uses_512_query_chunks():
    """The model's formulation (`_chunked_attn_heads_first`, chunk 512)
    differentiates a sequence longer than one chunk."""
    check_function(
        lambda q, k, v: kops.flash_attention(
            q, k, v, causal=True, window=None, scale=0.25,
            backward=tattn._chunked_attn_heads_first),
        lambda q, k, v: fa.flash_attention_ref(q, k, v, causal=True,
                                               scale=0.25),
        qkv(1, 2, 1, 600, 600, 16, seed=1))


def rwkv_inputs(B, T, H, K, seed=2):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, K), generator=g) * 0.5
               for _ in range(3))
    logw = -torch.exp(torch.randn((B, T, H, K), generator=g) * 0.5 - 0.6)
    u = torch.randn((H, K), generator=g) * 0.1
    return r, k, v, logw, u


@pytest.mark.parametrize("T, chunk", [(37, 16), (32, 16), (5, 16),
                                      (300, 16)])
def test_rwkv6_function_matches_autograd_through_plain(T, chunk):
    """A ragged tail, a whole number of chunks, less than one chunk, and 19
    chunks: `_wkv_chunked` forms its state-free terms 8 chunks at a time,
    so its groups are joined (8 + 8 + 3) under the gradient."""
    check_function(
        lambda *xs: kops.rwkv6_scan(*xs, chunk=chunk,
                                    backward=tssm._wkv_chunked),
        lambda *xs: rw.rwkv6_scan_ref(*xs, chunk=chunk),
        rwkv_inputs(2, T, 2, 8))


def mamba_inputs(B, T, D, N, seed=3):
    g = torch.Generator().manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn((B, T, D), generator=g)
                                      - 2.0)
    A = -torch.exp(torch.randn((D, N), generator=g) * 0.5)
    Bt, Ct, x = (torch.randn(s, generator=g) for s in
                 ((B, T, N), (B, T, N), (B, T, D)))
    return dt, A, Bt, Ct, x


@pytest.mark.parametrize("T, chunk", [(37, 16), (8, 16)])
def test_mamba_function_matches_autograd_through_plain(T, chunk):
    check_function(
        lambda *xs: kops.mamba_scan(*xs, backward=functools.partial(
            tssm._ssm_chunked, chunk=chunk)),
        ms.mamba_scan_ref, mamba_inputs(2, T, 12, 4))


def test_training_formulations_equal_the_plain_versions():
    """Forward: each training formulation computes its kernel's function
    (outputs and final states)."""
    q, k, v = qkv(2, 4, 2, 33, 33, 8, seed=5)
    o = tattn._chunked_attn(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, window=5,
                            scale=0.3, chunk=8).transpose(1, 2)
    torch.testing.assert_close(o, fa.flash_attention_ref(
        q, k, v, causal=True, window=5, scale=0.3), rtol=1e-5, atol=1e-6)
    xs = rwkv_inputs(1, 29, 2, 8, seed=6)
    for a, b in zip(tssm._wkv_chunked(*xs, chunk=16),
                    rw.rwkv6_scan_ref(*xs, chunk=16)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    xs = mamba_inputs(2, 29, 6, 4, seed=7)
    for a, b in zip(tssm._ssm_chunked(*xs, chunk=8), ms.mamba_scan_ref(*xs)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_final_states_are_not_differentiable_and_no_formulation_raises():
    xs = [x.requires_grad_(True) for x in rwkv_inputs(1, 9, 1, 4)]
    o, S = kops.rwkv6_scan(*xs, chunk=16, backward=tssm._wkv_chunked)
    assert o.requires_grad and not S.requires_grad
    with pytest.raises(RuntimeError):
        S.sum().backward()
    ys = [x.requires_grad_(True) for x in mamba_inputs(1, 5, 3, 2)]
    y, h = kops.mamba_scan(*ys)
    assert not h.requires_grad
    with pytest.raises(RuntimeError, match="no backward formulation"):
        y.sum().backward()
    q, k, v = (x.requires_grad_(True) for x in qkv(1, 2, 1, 4, 4, 8))
    with pytest.raises(RuntimeError, match="no backward formulation"):
        kops.flash_attention(q, k, v).sum().backward()
