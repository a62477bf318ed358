"""The port's launch specs (`repro_torch.launch.specs`), meshes and roofline
(`repro_torch.roofline`) against `repro`'s, and the mirrors of
tests/test_launch_and_roofline.py's specs and roofline tests on the port.
The roofline's formulas are the reference's; its constants are the H100's,
so each term times its constant is compared."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs import ARCHS as R_ARCHS
from repro.launch import specs as rspecs
from repro.roofline import analysis as rroof

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.launch.specs import (LONG_WINDOW, SHAPES, adapt_config,
                                      batch_specs, decode_cache_len,
                                      supported)
from repro_torch.roofline import analysis as troof
from repro_torch.roofline import analytic_costs, roofline_terms

SRC = Path(__file__).resolve().parents[1] / "src"
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}


def config_pairs(arch):
    """Both packages' configs of `arch` and its variants the specs branch
    on: whisper's cross-cache path."""
    out = [(R_ARCHS[arch], ARCHS[arch])]
    if ARCHS[arch].encoder_layers:
        out.append((R_ARCHS[arch].replace(cross_kv_cache=True),
                    ARCHS[arch].replace(cross_kv_cache=True)))
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_match_reference(arch):
    assert tspecs.SHAPES == rspecs.SHAPES
    assert tspecs.LONG_WINDOW == rspecs.LONG_WINDOW
    for rcfg, tcfg in config_pairs(arch):
        for shape in SHAPES:
            assert supported(tcfg, shape) == rspecs.supported(rcfg, shape)
            if not supported(tcfg, shape):
                with pytest.raises(ValueError):
                    adapt_config(tcfg, shape)
                continue
            ra, ta = rspecs.adapt_config(rcfg, shape), adapt_config(tcfg,
                                                                   shape)
            assert ta.sliding_window == ra.sliding_window
            assert decode_cache_len(ta, shape) == \
                rspecs.decode_cache_len(ra, shape)
            want = rspecs.batch_specs(ra, shape)
            got = batch_specs(ta, shape)
            assert sorted(got) == sorted(want), (arch, shape)
            for k, sds in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(sds.shape), (arch, k)
                assert got[k].dtype == DTYPES[jnp.dtype(sds.dtype)], (arch, k)


def costs_close(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x == pytest.approx(y, rel=1e-12, abs=0.0), f.name


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_roofline_costs_and_terms_match_reference(arch):
    """Every Costs field to 1e-12 over each supported shape x mesh x EP x
    accum_steps; each term times the port's constant equals the
    reference's term times the reference's constant."""
    assert troof.params_total(ARCHS[arch]) == \
        pytest.approx(rroof.params_total(R_ARCHS[arch]), rel=1e-12)
    assert troof.params_active(ARCHS[arch]) == \
        pytest.approx(rroof.params_active(R_ARCHS[arch]), rel=1e-12)
    consts = {"t_compute_s": "PEAK_FLOPS", "t_memory_s": "HBM_BW",
              "t_collective_s": "LINK_BW"}
    for shape in SHAPES:
        if not supported(ARCHS[arch], shape):
            continue
        for mp in (False, True):
            for ep in (True, False):
                for acc in (1, 8):
                    kw = dict(expert_parallel=ep, accum_steps=acc)
                    costs_close(analytic_costs(arch, shape, mp, **kw),
                                rroof.analytic_costs(arch, shape, mp, **kw))
                    t = roofline_terms(arch, shape, mp, **kw)
                    r = rroof.roofline_terms(arch, shape, mp, **kw)
                    for key, const in consts.items():
                        assert t[key] * getattr(troof, const) == \
                            pytest.approx(r[key] * getattr(rroof, const),
                                          rel=1e-12)
                    for key in ("arch", "shape", "mesh", "model_flops",
                                "exec_flops", "useful_ratio", "tokens"):
                        assert t[key] == pytest.approx(r[key], rel=1e-12)
                    assert t["dominant"] == max(
                        ("compute", "memory", "collective"),
                        key=lambda k: t[f"t_{k}_s"])


def test_constants_are_the_cards():
    assert troof.PEAK_FLOPS == 989e12
    assert troof.HBM_BW == 3.35e12
    assert troof.LINK_BW == 50e9


def test_cfg_overrides_match_reference():
    kw = dict(cfg_overrides=dict(n_layers=8, sliding_window=1024))
    costs_close(analytic_costs("qwen2-72b", "prefill_32k", **kw),
                rroof.analytic_costs("qwen2-72b", "prefill_32k", **kw))


def test_compiler_record_and_tables(tmp_path):
    rec = dict(arch="internlm2-20b", shape="prefill_32k", mesh="16x16",
               flops=1.0, hbm_bytes=2.0, collectives=None, temp_bytes=None,
               compile_s=None, lower_s=3.0)
    path = tmp_path / "dry.jsonl"
    path.write_text(json.dumps(rec) + "\n")
    recs = troof.load_dryrun(str(path))
    assert list(recs) == [("internlm2-20b", "prefill_32k", "16x16")]
    rows = troof.full_table(str(path))
    want = [(a, s) for a in R_ARCHS for s in rspecs.SHAPES
            if rspecs.supported(R_ARCHS[a], s)]
    assert [(r["arch"], r["shape"]) for r in rows] == want
    hit = [r for r in rows if "compiler" in r]
    assert len(hit) == 1 and hit[0]["compiler"]["flops"] == 1.0
    assert hit[0]["compiler"]["collective_bytes"] is None
    table = troof.markdown_table(rows)
    assert table.count("\n") == len(rows) + 1
    assert table.splitlines()[0] == rroof.markdown_table([]).splitlines()[0]


def test_mesh_module_touches_no_process_group_and_reads_sizes():
    """Importing the mesh, sharding and dry-run modules makes no process
    group (in a fresh interpreter: pytest workers share one)."""
    code = ("import torch.distributed as dist, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun, repro_torch.sharding; "
            "raise SystemExit(int(dist.is_initialized()))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

    class FakeMesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    assert tmesh.mesh_axis_sizes(FakeMesh()) == dict(pod=2, data=16,
                                                     model=16)


# mirrors of tests/test_launch_and_roofline.py, on the port

def test_shapes_table_matches_assignment():
    assert SHAPES["train_4k"] == dict(kind="train", seq=4096, batch=256)
    assert SHAPES["prefill_32k"] == dict(kind="prefill", seq=32768, batch=32)
    assert SHAPES["decode_32k"] == dict(kind="decode", seq=32768, batch=128)
    assert SHAPES["long_500k"] == dict(kind="decode", seq=524288, batch=1)


def test_supported_matrix():
    skips = [(a, s) for a in ARCHS for s in SHAPES
             if not supported(get_config(a), s)]
    assert skips == [("whisper-large-v3", "long_500k")]


def test_long_500k_forces_sliding_window_on_dense():
    cfg = adapt_config(get_config("qwen2-72b"), "long_500k")
    assert cfg.sliding_window == LONG_WINDOW
    cfg2 = adapt_config(get_config("mixtral-8x7b"), "long_500k")
    assert cfg2.sliding_window == 4096
    cfg3 = adapt_config(get_config("rwkv6-1.6b"), "long_500k")
    assert cfg3.sliding_window is None


def test_batch_specs_shapes():
    cfg = adapt_config(get_config("llava-next-34b"), "train_4k")
    sp = batch_specs(cfg, "train_4k")
    assert sp["tokens"].shape == (256, 4096 - cfg.n_patches)
    assert sp["patch_embeds"].shape == (256, cfg.n_patches, cfg.d_model)
    wcfg = adapt_config(get_config("whisper-large-v3"), "decode_32k")
    assert "frame_embeds" in batch_specs(wcfg, "decode_32k")
    assert "frame_embeds" not in batch_specs(
        wcfg.replace(cross_kv_cache=True), "decode_32k")


def test_decode_cache_len_ring_vs_full():
    mix = adapt_config(get_config("mixtral-8x7b"), "long_500k")
    assert decode_cache_len(mix, "long_500k") == 4096
    qw = adapt_config(get_config("qwen2-72b"), "decode_32k")
    assert decode_cache_len(qw, "decode_32k") == 32768


def test_roofline_terms_positive_and_dominant():
    for arch in ["qwen2-72b", "mixtral-8x7b", "rwkv6-1.6b"]:
        for shape in ["train_4k", "decode_32k"]:
            r = roofline_terms(arch, shape)
            assert r["t_compute_s"] > 0 and r["t_memory_s"] > 0
            assert r["dominant"] in ("compute", "memory", "collective")
            assert 0 < r["useful_ratio"] <= 1.05


def test_roofline_multipod_scales_compute_down():
    s1 = roofline_terms("qwen2-72b", "train_4k", multi_pod=False)
    s2 = roofline_terms("qwen2-72b", "train_4k", multi_pod=True)
    assert s2["t_compute_s"] == pytest.approx(s1["t_compute_s"] / 2, rel=0.01)


def test_ep_only_when_divisible():
    mix_ep = analytic_costs("mixtral-8x7b", "train_4k", expert_parallel=True)
    mix_noep = analytic_costs("mixtral-8x7b", "train_4k",
                              expert_parallel=False)
    assert mix_ep.coll_bytes_dev == pytest.approx(mix_noep.coll_bytes_dev)
    dbrx_ep = analytic_costs("dbrx-132b", "train_4k", expert_parallel=True)
    dbrx_noep = analytic_costs("dbrx-132b", "train_4k", expert_parallel=False)
    assert dbrx_ep.coll_bytes_dev > 3 * dbrx_noep.coll_bytes_dev


def test_accum_reduces_nothing_but_fsdp():
    a1 = analytic_costs("dbrx-132b", "train_4k", expert_parallel=False)
    a8 = analytic_costs("dbrx-132b", "train_4k", expert_parallel=False,
                        accum_steps=8)
    assert a8.flops_global == pytest.approx(a1.flops_global)
    assert a8.coll_bytes_dev > a1.coll_bytes_dev
