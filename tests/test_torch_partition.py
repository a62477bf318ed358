"""The port's LM sharding rules (`repro_torch.sharding.partition`) against
`repro.sharding.partition`: the specs of every parameter of the port's
meta `param_tree` and of its meta decode cache, leaf by leaf, equal to the
reference's on `jax.eval_shape(init_model)` and `init_cache`; the DTensor
placements of those specs; and mirrors of tests/test_model_units.py's
sharding tests. The port's cache is a list with one dict per period; each
period's leaf takes the reference's stacked spec less its "layers" entry.
`shard` on DTensors runs in subprocesses over a fake process group, which
is process-wide and must not live in a pytest worker."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import PartitionSpec

from repro.configs import ARCHS as R_ARCHS
from repro.models.transformer import init_cache as r_init_cache
from repro.models.transformer import init_model as r_init_model
from repro.sharding import partition as rp

from repro_torch.configs import ARCHS
from repro_torch.models.transformer import (init_cache, init_model,
                                            param_tree)
from repro_torch.sharding import partition as tp

CACHE_BATCH, CACHE_LEN = 128, 4096
SIZES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})

# every arch, plus the variants whose cache leaves differ: the int8 KV
# cache (qk, qv, scales) and whisper's cross K/V (a {"self", "cross"} slot)
CASES = [(a, {}) for a in sorted(ARCHS)] + [
    ("internlm2-20b", dict(kv_cache_int8=True)),
    ("whisper-large-v3", dict(cross_kv_cache=True)),
]


def paths(tree):
    return dict(tp._iter_paths(tree))


def ref_paths(tree):
    out = {}

    def walk(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(t, PartitionSpec):
            out[prefix] = tuple(t)
        elif hasattr(t, "_fields"):
            for k in t._fields:
                walk(getattr(t, k), f"{prefix}/{k}" if prefix else k)
        else:
            out[prefix] = t
    walk(tree)
    return out


@pytest.fixture(scope="module")
def built():
    """Both packages' abstract parameters and caches for every case."""
    out = {}
    for arch, kw in CASES:
        rcfg, tcfg = R_ARCHS[arch].replace(**kw), ARCHS[arch].replace(**kw)
        key = jax.random.PRNGKey(0)
        rparams = jax.eval_shape(lambda k: r_init_model(k, rcfg), key)
        rcache = jax.eval_shape(lambda: r_init_cache(rcfg, CACHE_BATCH,
                                                     CACHE_LEN))
        model = init_model(tcfg, 0, "meta")
        out[(arch, tuple(kw))] = (rparams, rcache, param_tree(model),
                                  init_cache(tcfg, CACHE_BATCH, CACHE_LEN,
                                             device="meta"))
    return out


@pytest.mark.parametrize("arch, kw", CASES,
                         ids=[a + "".join(f"-{k}" for k in kw)
                              for a, kw in CASES])
def test_param_and_cache_specs_match_reference(built, arch, kw):
    rparams, rcache, tparams, tcache = built[(arch, tuple(kw))]
    rleaves, tleaves = ref_paths(rparams), paths(tparams)
    assert sorted(tleaves) == sorted(rleaves)
    for p, leaf in tleaves.items():
        assert tuple(leaf.shape) == tuple(rleaves[p].shape), p
    rcl = ref_paths(rcache)
    assert len(tcache) == ARCHS[arch].n_periods
    for period in tcache:
        tcl = paths(period)
        assert sorted(tcl) == sorted(rcl), "a cache leaf without counterpart"
        for p, leaf in tcl.items():
            assert tuple(leaf.shape) == tuple(rcl[p].shape[1:]), p
    for multi_pod, sizes in zip((False, True), SIZES):
        for ep in (True, False):
            for seq_dec in (False, True):
                rules = tp.fsdp_tp_rules(multi_pod, ep, seq_dec)
                assert rules == rp.fsdp_tp_rules(multi_pod, ep, seq_dec)
                for sz in (None, sizes):
                    want = ref_paths(rp.param_pspecs(rparams, rules, sz))
                    got = paths(tp.param_pspecs(tparams, rules, sz))
                    assert got == want, (multi_pod, ep, seq_dec, sz)
                    want = ref_paths(rp.param_pspecs(rcache, rules, sz))
                    specs = tp.param_pspecs(tcache, rules, sz)
                    assert isinstance(specs, list)
                    for period in specs:
                        got = paths(period)
                        assert {p: s[1:] for p, s in want.items()} == got
                        assert all(s[0] is None for s in want.values())


def test_param_shardings_are_the_specs_placements():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    cfg = ARCHS["internlm2-20b"]
    tree = param_tree(init_model(cfg, 0, "meta"))
    rules = tp.fsdp_tp_rules(True)
    pl = tp.param_shardings(tree, Mesh(), rules)
    # embed/tokens (vocab, embed): vocab over model, embed over data
    assert pl["embed"]["tokens"] == (Replicate(), Shard(1), Shard(0))
    # wk (layers, embed, kv_heads=8, head_dim): model relocated to head_dim
    assert pl["layers"]["s0_attn"]["attn"]["wk"] == (Replicate(), Shard(1),
                                                     Shard(3))
    # the batch over ("pod", "data"): one tensor dim on two mesh dims
    assert tp.spec_placements((("pod", "data"), None),
                              Mesh.mesh_dim_names) == (Shard(0), Shard(0),
                                                       Replicate())
    assert pl["final_norm"]["scale"] == (Replicate(),) * 3
    assert tp.spec_placements(("data", None), ("data", "model")) == \
        (Shard(0), Replicate())


def test_shard_is_identity_without_rules_or_dtensor():
    x = torch.ones(4, 8)
    assert tp.shard(x, "batch", "embed") is x
    with tp.use_rules(tp.fsdp_tp_rules(False), {"data": 16, "model": 16}):
        assert tp.active_rules() is not None
        assert tp.shard(x, "batch", "embed") is x
    assert tp.active_rules() is None and tp.active_axis_sizes() is None


def run_on_fake_mesh(body, multi_pod):
    """`body` in a fresh process whose default group is the dry run's fake
    one, with `mesh`, `sizes` and `rules` (fsdp_tp_rules) of the
    production mesh bound."""
    code = textwrap.dedent("""
        import torch
        import torch.distributed as dist
        from torch.distributed.tensor import (Partial, Replicate, Shard,
                                              distribute_tensor)
        from repro_torch.launch.dryrun import fake_group
        from repro_torch.launch.mesh import (make_production_mesh,
                                             mesh_axis_sizes)
        from repro_torch.sharding import partition as tp
        fake_group()
        mesh = make_production_mesh(multi_pod=MULTI_POD, device_type="cpu")
        sizes = mesh_axis_sizes(mesh)
        rules = tp.fsdp_tp_rules(MULTI_POD)
        """).replace("MULTI_POD", str(multi_pod)) + textwrap.dedent(body) + \
        "\ndist.destroy_process_group()\nprint('ok')\n"
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0 and out.stdout.splitlines()[-1] == "ok", \
        out.stdout + out.stderr


@pytest.mark.parametrize("multi_pod", [False, True])
def test_shard_redistributes_a_dtensor_under_rules(multi_pod):
    """Under active rules, `shard` moves a meta DTensor to the placements
    of the shape-aware spec (repair off), or of the plain spec without
    axis sizes; outside them it returns its input."""
    run_on_fake_mesh("""
        R = (Replicate(),) * len(sizes)
        cases = [((32, 4096, 6144), ("batch", "seq", "embed_act")),
                 ((32, 4096, 6144), ("batch", "seq_outer", "embed")),
                 ((3, 64, 8), ("batch", "heads", None)),   # batch 3: dropped
                 ((4, 8, 4096, 128), ("batch", "kv_heads", "kv_seq",
                                      "head_dim"))]
        for shape, axes in cases:
            x = distribute_tensor(torch.empty(shape, device="meta"), mesh, R)
            assert tp.shard(x, *axes) is x
            for sz in (sizes, None):
                with tp.use_rules(rules, sz):
                    y = tp.shard(x, *axes)
                spec = (tp.shape_aware_spec(axes, shape, rules, sz,
                                            repair=False)
                        if sz else tp.logical_to_spec(axes, rules))
                want = tp.spec_placements(spec, mesh.mesh_dim_names)
                assert y.placements == want, (shape, axes, sz, y.placements)
                local = list(shape)      # rank 0's: torch.chunk's first
                for p, n in zip(want, mesh.shape):
                    if isinstance(p, Shard):
                        local[p.dim] = -(-local[p.dim] // n)
                assert tuple(y.to_local().shape) == tuple(local)
        """, multi_pod)


def test_model_shard_sites_place_their_outputs():
    """Two of the models' `shard` sites on DTensor inputs (batch over
    "data", weights replicated): the MLP's hidden goes over "model", so
    its output projection comes out a partial sum there; the logits come
    out with the vocab over "model". Without rules both stay replicated
    on "model"."""
    run_on_fake_mesh("""
        from repro_torch.models import layers

        R = (Replicate(), Replicate())

        def replicated(module):
            for n, w in list(module.named_parameters()):
                setattr(module, n, torch.nn.Parameter(
                    distribute_tensor(w, mesh, R), requires_grad=False))
            return module

        gen = layers.MetaGenerator()
        mlp = replicated(layers.MLP(gen, 256, 1024, torch.bfloat16))
        head = replicated(layers.LMHead(gen, 256, 4096, torch.bfloat16))
        x = distribute_tensor(torch.empty(32, 64, 256, device="meta",
                                          dtype=torch.bfloat16), mesh,
                              (Shard(0), Replicate()))
        assert layers.apply_mlp(mlp, x).placements == (Shard(0), Replicate())
        assert layers.lm_logits(None, head, x).placements == (Shard(0),
                                                              Replicate())
        with tp.use_rules(rules, sizes):
            y = layers.apply_mlp(mlp, x)
            z = layers.lm_logits(None, head, x)
        assert y.placements == (Shard(0), Partial("sum")), y.placements
        assert z.placements == (Shard(0), Shard(2)), z.placements
        assert tuple(z.to_local().shape) == (2, 64, 256)
        assert z.dtype == torch.float32
        """, False)


# mirrors of tests/test_model_units.py, on the port

def test_shape_aware_divisibility_repair():
    rules = tp.fsdp_tp_rules(False)
    sizes = {"data": 16, "model": 16}
    spec = tp.shape_aware_spec(("layers", "embed", "kv_heads", "head_dim"),
                               (48, 6144, 8, 128), rules, sizes)
    assert spec == (None, "data", None, "model")
    spec2 = tp.shape_aware_spec(("layers", "embed", "kv_heads", "head_dim"),
                                (48, 6144, 8, 100), rules, sizes)
    assert spec2[0] is None


def test_axes_for_path_known_params():
    assert tp.axes_for_path("layers/s0_attn/attn/wq", 4) == \
        ("layers", "embed", "heads", "head_dim")
    assert tp.axes_for_path("embed/tokens", 2) == ("vocab", "embed")
    assert tp.axes_for_path("layers/s0_attn/moe/wi", 4) == \
        ("layers", "experts", "embed", "expert_mlp")
    assert tp.axes_for_path("something/unknown", 2) == (None, None)


def test_logical_rules_no_duplicate_axis():
    rules = tp.fsdp_tp_rules(True)
    spec = tp.logical_to_spec(("batch", "pod_batch"), rules)
    flat = []
    for part in spec:
        if isinstance(part, tuple):
            flat += list(part)
        elif part:
            flat.append(part)
    assert len(flat) == len(set(flat))


def test_patterns_and_logical_axes_match_reference():
    assert tp.PARAM_AXIS_PATTERNS == rp.PARAM_AXIS_PATTERNS
    tree = param_tree(init_model(ARCHS["jamba-1.5-large-398b"], 0, "meta"))
    rcfg = R_ARCHS["jamba-1.5-large-398b"]
    rtree = jax.eval_shape(lambda k: r_init_model(k, rcfg),
                           jax.random.PRNGKey(0))
    assert tp.param_logical_axes(tree) == rp.param_logical_axes(rtree)
