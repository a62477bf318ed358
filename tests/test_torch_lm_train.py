"""The port's LM training path (`models.transformer.lm_loss`, the train
mode of every layer kind, `launch.steps.make_train_step`,
`launch.train.main`) against the JAX package's on the CPU, in float32.

Seven reduced families, the reference's parameters carried over through
`interop.model_params_from_numpy`: internlm2-20b (kv_heads 2), rwkv6-1.6b
(S = 20 is no multiple of its reduced chunk 16), jamba-1.5-large-398b
(kv_heads 2; S no multiple of its ssm chunk 32: the reference pads, the
port's last chunk is short), minicpm3-4b (MLA), whisper-large-v3 (with
frames), llava-next-34b (kv_heads 2, with patches: the loss drops their
logits) and mixtral-8x7b with a window of 8. On the CPU the kernels' plain
versions run forward and their gradients go through the same
`torch.autograd.Function`s, and the same training formulations, as on the
card.

Tolerances: the loss to 1e-5 relative; each gradient leaf to 1e-4 of its
largest magnitude (the two packages sum the same float32 terms in other
orders, through sequences of 10^2-10^3 operations); a train step's loss
and grad_norm to 1e-5 relative, its parameters to 1e-5 (+ 1e-5 relative)
wherever the reference's gradient exceeds 1e-6 in size. AdamW's first
step moves every weight by about lr whatever its gradient's size, so a
gradient within ~1e-6 of zero whose sign differs between the packages
moves its weight the other way: those entries are counted, each bounded
by 2 lr, and their number bounded.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import transformer as jt
from repro.optim import AdamW as JAdamW

from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.data import make_pipeline
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tt

from _torch_train import params_from_tree
from repro_torch.optim import AdamW

# case -> (config, the fields replaced in its reduced form), float32
CASES = {"internlm2-20b": ("internlm2-20b", dict(kv_heads=2)),
         "rwkv6-1.6b": ("rwkv6-1.6b", {}),
         "jamba-1.5-large-398b": ("jamba-1.5-large-398b", dict(kv_heads=2)),
         "minicpm3-4b": ("minicpm3-4b", {}),
         "whisper-large-v3": ("whisper-large-v3", {}),
         "llava-next-34b": ("llava-next-34b", dict(kv_heads=2)),
         "mixtral-8x7b-window8": ("mixtral-8x7b", dict(sliding_window=8))}
B, S = 2, 20
LR = 1e-3
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest magnitude
PARAM_TOL = 1e-5
SMALL_GRAD = 1e-6


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


def configs(case, **kw):
    arch, over = CASES[case]
    over = dict(over, dtype="float32", **kw)
    return jget(arch).reduced().replace(**over), \
        tget(arch).reduced().replace(**over)


def batch_np(cfg, seed=0, batch=B, seq=S):
    """Tokens, and frames (x 0.1) or patches (x 0.02), from `seed`."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq))}
    if cfg.encoder_layers:
        out["frame_embeds"] = 0.1 * rng.standard_normal(
            (batch, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        out["patch_embeds"] = 0.02 * rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def port_model(tree, ct):
    return interop.model_params_from_numpy(tree, ct, device="cpu")


def flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_flat(model, values=None):
    return {k: v.detach().numpy() for k, v in flat_t(
        tt.param_tree(model, values)).items()}


def flat_t(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(flat_t(v, name) if isinstance(v, dict) else {name: v})
    return out


def loss_and_grads(model, ct, batch):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = tt.lm_loss(model, ct, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(params, grads))


def assert_leaves_close(got, ref, tol=GRAD_TOL):
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        scale = float(np.abs(r).max())
        err = float(np.abs(got[name] - r).max())
        assert err <= tol * scale + 1e-12, (name, err, scale)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The reference's loss, gradients and one train step (AdamW lr 1e-3,
    clip 1.0), jitted together, and the port's model on its weights."""
    cj, ct = configs(request.param)
    params = jt.init_model(jax.random.PRNGKey(0), cj)
    tree = jax.tree_util.tree_map(np.asarray, params)
    b = batch_np(cj)
    opt = JAdamW(lr=LR)
    step, _ = jmake_train_step(cj, opt)

    @jax.jit
    def ref(p, batch):
        loss, grads = jax.value_and_grad(jt.lm_loss)(p, cj, batch)
        new_p, _, m = step(p, opt.init(p), batch)
        return loss, grads, new_p, m

    loss, grads, new_p, m = ref(params, to_jax(b))
    return dict(cj=cj, ct=ct, tree=tree, batch=b, loss=float(loss),
                grads=flat(grads), new_params=flat(new_p),
                step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))


def test_lm_loss_and_every_gradient_match_reference(case):
    ct = case["ct"]
    model = port_model(case["tree"], ct)
    loss, grads = loss_and_grads(model, ct, to_torch(case["batch"]))
    assert float(loss) == pytest.approx(case["loss"], rel=LOSS_TOL)
    got = port_flat(model, grads)
    assert_leaves_close(got, case["grads"])
    # every parameter gets a gradient that is not all zero (a kernel output
    # cut off from the graph would leave its projections at zero)
    zero = [n for n, g in got.items() if not np.any(g)]
    assert not zero, zero


def test_train_step_matches_reference(case):
    ct = case["ct"]
    model = port_model(case["tree"], ct)
    step, opt = make_train_step(ct, AdamW(lr=LR))
    state = opt.init(dict(model.named_parameters()))
    model, state, m = step(model, state, to_torch(case["batch"]))
    assert float(m["loss"]) == pytest.approx(case["step_loss"], rel=LOSS_TOL)
    assert float(m["grad_norm"]) == pytest.approx(case["grad_norm"],
                                                  rel=LOSS_TOL)
    assert int(state.step) == 1
    got = port_flat(model)
    flipped = total = 0
    for name, ref in case["new_params"].items():
        g = np.abs(case["grads"][name])
        gap = np.abs(got[name] - ref)
        big = g > SMALL_GRAD
        assert np.all(gap[big] <= PARAM_TOL * (1 + np.abs(ref[big]))), name
        assert np.all(gap <= 2 * LR * (1 + 1e-3) + PARAM_TOL), name
        flipped += int((gap[~big] > PARAM_TOL * (1 + np.abs(ref[~big]))).sum())
        total += gap.size
    assert flipped <= 1e-3 * total, (flipped, total)


def test_grad_accumulation_matches_full_batch_and_reference():
    """accum_steps=2 against 1 (the same mean gradient, up to summation
    order) and against the reference's accumulated step."""
    cj, ct = configs("internlm2-20b")
    params = jt.init_model(jax.random.PRNGKey(0), cj)
    tree = jax.tree_util.tree_map(np.asarray, params)
    b = batch_np(cj, seed=1, batch=4, seq=16)
    opt = JAdamW(lr=LR)
    jstep, _ = jmake_train_step(cj, opt, accum_steps=2)
    jp, _, jm = jax.jit(jstep)(params, opt.init(params), to_jax(b))
    ref = flat(jp)
    runs = {}
    for accum in (1, 2):
        model = port_model(tree, ct)
        grads = {}
        step, topt = make_train_step(ct, AdamW(lr=LR), accum_steps=accum)
        model, _, m = step(model, topt.init(dict(model.named_parameters())),
                           to_torch(b), grads)
        runs[accum] = (m, port_flat(model), port_flat(model, grads))
    (m1, p1, g1), (m2, p2, g2) = runs[1], runs[2]
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m2["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_TOL)
    assert float(m2["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=LOSS_TOL)
    assert all(g.dtype == np.float32 for g in g2.values())
    assert_leaves_close(g2, g1)
    for name, r in ref.items():
        assert np.abs(p2[name] - r).max() <= 2 * LR * (1 + 1e-3) + PARAM_TOL
    close = sum(int((np.abs(p2[n] - r) <= PARAM_TOL * (1 + np.abs(r))).sum())
                for n, r in ref.items())
    assert close >= (1 - 1e-3) * sum(r.size for r in ref.values())


def test_grad_accumulation_rejects_a_batch_it_cannot_split():
    """A batch whose axis 0 is not a multiple of accum_steps raises, as
    the reference's reshape does, instead of leaving rows out."""
    _, ct = configs("internlm2-20b")
    model = tt.init_model(ct, 0, "cpu")
    step, topt = make_train_step(ct, AdamW(lr=LR), accum_steps=2)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="not a multiple of accum_steps=2"):
        step(model, topt.init(dict(model.named_parameters())),
             to_torch(batch_np(ct, seed=1, batch=3, seq=16)))
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n


@pytest.mark.parametrize("case_name", ["internlm2-20b", "jamba-1.5-large-398b",
                                       "rwkv6-1.6b"])
def test_remat_dots_equals_full_and_no_remat(case_name):
    """Checkpointing each period ("full", or saving the matrix products'
    outputs, "dots") gives the gradients of no remat, bit for bit up to
    the recompute's own rounding (none on the CPU)."""
    _, ct = configs(case_name)
    b = to_torch(batch_np(ct, seed=2))
    out = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = ct.replace(remat=remat, remat_policy=policy)
        model = tt.init_model(cfg, 3, "cpu")
        loss, grads = loss_and_grads(model, cfg, b)
        out[(remat, policy)] = (loss, grads)
    base_loss, base = out[(False, "full")]
    for key in ((True, "full"), (True, "dots")):
        loss, grads = out[key]
        assert torch.equal(loss, base_loss), key
        for name, g in grads.items():
            torch.testing.assert_close(g, base[name], rtol=1e-6, atol=1e-7)


def test_router_gets_a_gradient():
    _, ct = configs("mixtral-8x7b-window8")
    model = tt.init_model(ct, 4, "cpu")
    _, grads = loss_and_grads(model, ct, to_torch(batch_np(ct, seed=4)))
    routers = [n for n in grads if n.endswith("moe.router")]
    assert routers
    for n in routers:
        assert float(grads[n].norm()) > 0, n


def test_loss_decreases_reduced_lm():
    """Mirror of tests/test_archs.py::test_loss_decreases_reduced_lm: the
    reduced internlm2-20b, bf16, learns the pipeline's structure in 30
    steps of 4 x 64."""
    cfg = tget("internlm2-20b").reduced()
    assert cfg.torch_dtype == torch.bfloat16
    model = tt.init_model(cfg, 4, "cpu")
    step, opt = make_train_step(cfg, AdamW(lr=3e-3))
    state = opt.init(dict(model.named_parameters()))
    losses = []
    for i, b in enumerate(make_pipeline(cfg.vocab_size, 4, 64, prefetch=0)):
        if i >= 30:
            break
        model, state, m = step(model, state,
                               {"tokens": torch.from_numpy(b["tokens"])})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses[:3] + losses[-3:]
    # the optimizer state stays float32 beside the bf16 weights
    assert all(v.dtype == torch.float32 for v in state.mu.values())
    assert model.embed.tokens.dtype == torch.bfloat16


@pytest.mark.parametrize("case_name", sorted(CASES))
def test_train_main_runs_on_the_cpu(case_name, tmp_path, capsys):
    _, ct = configs(case_name)
    ref = tt.init_model(ct, 0, "cpu")
    stats = {}
    losses = train.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "24", "--log-every", "1", "--ckpt",
                         str(tmp_path)], stats=stats, cfg=ct)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert stats["step1_grads"]["params"] == len(list(ref.parameters()))
    assert not any(stats["step1_grads"][k]
                   for k in ("missing", "nonfinite", "zero"))
    assert all(np.isfinite(stats["grad_norm"]))
    # on the CPU the plain versions run: no kernel launch
    assert not any(v for d in stats["step_launches"] for v in d.values())
    moved = [n for n, p in stats["model"].named_parameters()
             if not torch.equal(p, dict(ref.named_parameters())[n])]
    assert len(moved) == len(list(ref.parameters()))
    from repro_torch.checkpoint import latest_step, restore

    assert latest_step(str(tmp_path)) == 3
    back = restore(str(tmp_path), {"params": tt.param_tree(stats["model"])})
    for n, t in params_from_tree(stats["model"], back["params"]).items():
        assert torch.equal(t, dict(stats["model"].named_parameters())[n])
    out = capsys.readouterr().out
    assert "step 3: loss=" in out and "checkpoint written" in out
