"""`repro_torch.launch.dryrun` in subprocesses (its fake process group must
not live in a pytest worker): the per-device argument bytes of reduced
pairs against the sum over `repro`'s specs at the same axis sizes, the
per-device counts and collectives of their partitioned passes, and the
command line's records, skip lines, summary and exit code."""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro.configs import ARCHS as R_ARCHS
from repro.launch.specs import (adapt_config, batch_specs, decode_cache_len,
                                SHAPES)
from repro.models.transformer import init_cache, init_model
from repro.optim import AdamW
from repro.sharding.partition import fsdp_tp_rules, param_pspecs

SRC = Path(__file__).resolve().parents[1] / "src"
PAIRS = [("internlm2-20b", "train_4k", False),
         ("jamba-1.5-large-398b", "decode_32k", True),
         ("whisper-large-v3", "prefill_32k", True)]


def run(code, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)


def reduced_overrides(cfg):
    r = cfg.reduced()
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
            if getattr(r, f.name) != getattr(cfg, f.name)}


def local_bytes(shape, dtype, spec, sizes):
    n = np.dtype(dtype).itemsize
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for dim, ax in zip(shape, spec):
        flat = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        n *= dim // math.prod(sizes[a] for a in flat)
    return n


def tree_bytes(tree, specs, sizes):
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(local_bytes(l.shape, l.dtype, s, sizes)
               for l, s in zip(leaves, spec_leaves))


def reference_argument_bytes(arch, shape, multi_pod):
    """The sum over `repro`'s shape-aware specs of every argument's
    per-device bytes, as `repro.launch.dryrun` shards them."""
    rcfg = R_ARCHS[arch]
    cfg = adapt_config(rcfg, shape).replace(**reduced_overrides(rcfg))
    kind = SHAPES[shape]["kind"]
    sizes = dict(pod=2, data=16, model=16) if multi_pod \
        else dict(data=16, model=16)
    rules = fsdp_tp_rules(multi_pod, seq_shard_decode=(kind == "decode"))
    params = jax.eval_shape(lambda k: init_model(k, cfg),
                            jax.random.PRNGKey(0))
    psp = param_pspecs(params, rules, sizes)
    total = tree_bytes(params, psp, sizes)
    data = ("pod", "data") if multi_pod else "data"
    for v in batch_specs(cfg, shape).values():
        spec = () if v.shape == () or v.shape[0] == 1 else (data,)
        total += local_bytes(v.shape, v.dtype, spec, sizes)
    if kind == "train":
        st = jax.eval_shape(AdamW().init, params)
        total += np.dtype(st.step.dtype).itemsize
        total += tree_bytes(st.mu, psp, sizes) + tree_bytes(st.nu, psp, sizes)
    elif kind == "decode":
        cache = jax.eval_shape(lambda: init_cache(
            cfg, SHAPES[shape]["batch"], decode_cache_len(cfg, shape)))
        total += tree_bytes(cache, param_pspecs(cache, rules, sizes), sizes)
    return total


def test_reduced_pairs_argument_bytes_match_reference_specs():
    code = (
        "import dataclasses, json\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch import dryrun\n"
        f"for arch, shape, mp in {PAIRS!r}:\n"
        "    cfg = get_config(arch); r = cfg.reduced()\n"
        "    ov = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)\n"
        "          if getattr(r, f.name) != getattr(cfg, f.name)}\n"
        "    rec = dryrun.lower_pair(arch, shape, mp, cfg_overrides=ov,\n"
        "                            verbose=False)\n"
        "    print(json.dumps(rec))\n")
    out = run(code)
    assert out.returncode == 0, out.stdout + out.stderr
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert len(recs) == len(PAIRS)
    for (arch, shape, mp), rec in zip(PAIRS, recs):
        assert (rec["arch"], rec["shape"]) == (arch, shape)
        assert rec["mesh"] == ("2x16x16" if mp else "16x16")
        assert rec["n_devices"] == (512 if mp else 256)
        assert rec["argument_bytes"] == reference_argument_bytes(arch, shape,
                                                                 mp)
        assert rec["flops"] > 0 and rec["hbm_bytes"] > 0
        assert rec["output_bytes"] > 0 and rec["lower_s"] > 0
        # per device: at most the unsharded step's, at least its share
        assert rec["flops_global"] / rec["n_devices"] <= rec["flops"] \
            < rec["flops_global"]
        assert 0 < rec["hbm_bytes"] < rec["hbm_bytes_global"]
        assert rec["compile_s"] is None
        assert rec["peak_bytes"] == rec["argument_bytes"] + rec["temp_bytes"]
        coll = rec["collectives"]
        kinds = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute")
        assert set(coll) == set(kinds) | {"total_bytes"}
        assert coll["total_bytes"] == sum(coll[k]["bytes"] for k in kinds) > 0


def test_command_line_records_skips_and_summary(tmp_path):
    out_file = tmp_path / "dry.jsonl"
    code = ("import sys; from repro_torch.launch import dryrun; "
            "sys.exit(dryrun.main(sys.argv[1:]))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-c", code, "--arch", "rwkv6-1.6b", "--shape",
         "decode_32k", "--multi-pod", "both", "--out", str(out_file)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "dry-run summary: 2 ok, 0 skipped, 0 failed" in res.stdout
    recs = [json.loads(line) for line in out_file.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    # the multi-pod mesh halves the data-sharded leaves' bytes per device
    assert recs[1]["argument_bytes"] < recs[0]["argument_bytes"]
    # and each device's share of the step (batch 128 over 16, then 32)
    assert recs[1]["flops"] == pytest.approx(recs[0]["flops"] / 2, rel=0.02)
    assert recs[0]["flops_global"] == recs[1]["flops_global"]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-large-v3", "--shape", "long_500k"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "-- skip whisper-large-v3 x long_500k" in res.stdout
    assert "dry-run summary: 0 ok, 1 skipped, 0 failed" in res.stdout
