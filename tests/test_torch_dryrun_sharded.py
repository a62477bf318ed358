"""The dry run's per-device record (`repro_torch.launch.dryrun`): the step
on meta DTensors over the production meshes, counted on one device, held
against `repro.launch.dryrun`'s record of the partitioned XLA program on
reduced internlm2-20b x prefill_32k, on 16 x 16 and 2 x 16 x 16; and the
three LM ops' DTensor sharding rules (`kernels.ops.register_sharding_rules`).

Both dry runs run in subprocesses, side by side: the port's fake process
group is process-wide, and `repro.launch.dryrun` sets XLA's device count
when it is imported. What is held against the reference is what the two
counts share: how each changes from one mesh to the other (the batch
splits over twice the devices), the collectives' form. Their absolute
values differ by design: XLA's cost analysis counts a while loop's body
once (the reference's layer scan and its 64-chunk attention scan), counts
elementwise operations, and its attention materializes float32 scores
that the flash op never writes. The port's own count is held exactly:
where every split divides (heads made 16), each device does 1 / n of the
unsharded FLOPs."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_partition import run_on_fake_mesh

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH, SHAPE = "internlm2-20b", "prefill_32k"
KEYS = ("mesh", "n_devices", "flops", "hbm_bytes", "collectives")

REDUCED = """
import dataclasses, json
from {pkg}.configs import get_config
cfg = get_config({arch!r}); r = cfg.reduced()
ov = {{f.name: getattr(r, f.name) for f in dataclasses.fields(r)
      if getattr(r, f.name) != getattr(cfg, f.name)}}
"""

REFERENCE = REDUCED + """
from repro.launch import dryrun
for mp in (False, True):
    rec = dryrun.lower_pair({arch!r}, {shape!r}, mp, cfg_overrides=ov,
                            verbose=False)
    print(json.dumps({{k: rec[k] for k in {keys!r}}}))
"""

PORT = REDUCED + """
from repro_torch.launch import dryrun, specs, steps
from repro_torch.models.transformer import init_model
for heads in (None, 16):
    o = dict(ov, n_heads=heads, kv_heads=heads) if heads else ov
    for mp in (False, True):
        rec = dryrun.lower_pair({arch!r}, {shape!r}, mp, cfg_overrides=o,
                                verbose=False)
        print(json.dumps(dict(rec, heads=heads)))
cfg = specs.adapt_config(cfg, {shape!r}).replace(**ov)
_, flops, nbytes = dryrun.count_step(
    steps.make_prefill_step(cfg), init_model(cfg, 0, "meta"),
    specs.batch_specs(cfg, {shape!r}))
print(json.dumps(dict(unsharded_flops=flops, unsharded_bytes=nbytes)))
"""


def records(code, pkg):
    return subprocess.Popen(
        [sys.executable, "-c", code.format(pkg=pkg, arch=ARCH, shape=SHAPE,
                                           keys=KEYS)],
        env=dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def parsed(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, out + err
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def runs():
    """(repro's two records, the port's records: two meshes at the reduced
    heads, two at 16 heads, then the unsharded pass's counts)."""
    ref, port = records(REFERENCE, "repro"), records(PORT, "repro_torch")
    return parsed(ref), parsed(port)


def test_per_device_flops_halve_as_the_reference(runs):
    ref, port = runs
    assert [r["mesh"] for r in ref] == [r["mesh"] for r in port[:2]] \
        == ["16x16", "2x16x16"]
    want = ref[1]["flops"] / ref[0]["flops"]
    got = port[1]["flops"] / port[0]["flops"]
    assert abs(got / want - 1) <= 0.02, (got, want)
    for rec in port[:2]:
        assert 0 < rec["flops"] < rec["flops_global"]


def test_per_device_bytes_halve_as_the_reference(runs):
    ref, port = runs
    want = ref[1]["hbm_bytes"] / ref[0]["hbm_bytes"]
    got = port[1]["hbm_bytes"] / port[0]["hbm_bytes"]
    assert abs(got / want - 1) <= 0.1, (got, want)
    for rec in port[:2]:
        assert 0 < rec["hbm_bytes"] < rec["hbm_bytes_global"]


def test_collectives_in_the_reference_form(runs):
    ref, port = runs
    for r, p in zip(ref, port[:2]):
        coll = p["collectives"]
        assert set(coll) == set(r["collectives"])
        kinds = [k for k in coll if k != "total_bytes"]
        assert all(set(coll[k]) == {"count", "bytes"} for k in kinds)
        assert coll["total_bytes"] == sum(coll[k]["bytes"] for k in kinds) > 0
        # DTensor's redistributions issue no point-to-point permutes
        assert coll["collective-permute"] == {"count": 0, "bytes": 0}
    want = ref[1]["collectives"]["total_bytes"] \
        / ref[0]["collectives"]["total_bytes"]
    got = port[1]["collectives"]["total_bytes"] \
        / port[0]["collectives"]["total_bytes"]
    assert abs(got / want - 1) <= 0.1, (got, want)


def test_global_counts_are_the_unsharded_pass(runs):
    _, port = runs
    unsharded = port[4]
    for rec in port[:2]:
        assert rec["flops_global"] == unsharded["unsharded_flops"]
        assert rec["hbm_bytes_global"] == unsharded["unsharded_bytes"]
        assert rec["compile_s"] is None
        assert rec["temp_bytes"] > 0
        assert rec["peak_bytes"] == rec["argument_bytes"] + rec["temp_bytes"]


def test_each_device_does_its_share_where_every_split_divides(runs):
    """16 heads: batch 32 over the data axes (16, or 2 x 16), heads, MLP
    and vocabulary over "model": FLOPs a device = the unsharded FLOPs over
    the device count, exactly, with no op repaired."""
    _, port = runs
    for rec in port[2:4]:
        assert rec["heads"] == 16
        assert rec["flops"] * rec["n_devices"] == rec["flops_global"]
        assert rec["reshards"] == {}
    assert port[3]["flops"] * 2 == port[2]["flops"]


OP_CASE = """
from repro_torch.kernels import ops as kops
from repro_torch.launch.dryrun import LocalCounter
kops.register_sharding_rules()


def dt(shape, *placements, dtype=torch.bfloat16):
    return distribute_tensor(torch.empty(shape, device="meta", dtype=dtype),
                             mesh, placements)


S0, R = Shard(0), Replicate()
"""


def check_op(body):
    run_on_fake_mesh(OP_CASE + body + """
for o, p in zip(outs, want):
    assert o.placements == p, (o.placements, p)
assert all(c["count"] == 0 for c in lc.collectives.values()), lc.collectives
assert lc.flops == flops, (lc.flops, flops)
""", False)


def test_flash_attention_keeps_batch_and_head_splits():
    check_op("""
q = dt((32, 16, 64, 96), S0, Shard(1))
k = dt((32, 16, 80, 96), S0, Shard(1))
v = dt((32, 16, 80, 64), S0, Shard(1))
with LocalCounter() as lc:
    outs = [kops.flash_attention_op(q, k, v, True, None, None)]
want = [(S0, Shard(1))]
assert tuple(outs[0].to_local().shape) == (2, 1, 64, 64)
flops = kops.flash_attention_flops(2, 1, 64, 80, 96, 64, True, None)
""")


def test_rwkv6_scan_keeps_batch_and_head_splits():
    check_op("""
r, k, v, logw = (dt((32, 64, 16, 64), S0, Shard(2), dtype=torch.float32)
                 for _ in range(4))
u = dt((16, 64), R, S0, dtype=torch.float32)
with LocalCounter() as lc:
    outs = kops.rwkv6_scan_op(r, k, v, logw, u, 16)
want = [(S0, Shard(2)), (S0, Shard(1))]
assert tuple(outs[1].to_local().shape) == (2, 1, 64, 64)
flops = kops.rwkv6_scan_flops(2, 64, 1, 64)
""")


def test_mamba_scan_keeps_batch_and_channel_splits():
    check_op("""
dt_, x = (dt((32, 64, 256), S0, Shard(2), dtype=torch.float32)
          for _ in range(2))
A = dt((256, 16), R, S0, dtype=torch.float32)
Bt, Ct = (dt((32, 64, 16), S0, R, dtype=torch.float32) for _ in range(2))
with LocalCounter() as lc:
    outs = kops.mamba_scan_op(dt_, A, Bt, Ct, x)
want = [(S0, Shard(2)), (S0, Shard(1))]
assert tuple(outs[1].to_local().shape) == (2, 16, 16)
flops = kops.mamba_scan_flops(2, 64, 16, 16)
""")


def test_an_op_without_a_sharding_strategy_runs_replicated():
    """`Reshard`'s last resort (some ops, such as `flip` in a gradient,
    have no DTensor strategy in older PyTorch releases): an op with none
    runs on the gathered local tensors, one all-gather per split mesh
    dimension counted, its result replicated."""
    run_on_fake_mesh("""
from repro_torch.launch import dryrun
lib = torch.library.Library("dryrun_case", "DEF")
lib.define("twice(Tensor x) -> Tensor")
lib.impl("twice", lambda x: x * 2, "CPU")
torch.library.register_fake("dryrun_case::twice",
                            lambda x: x.new_empty(x.shape), lib=lib)
x = distribute_tensor(torch.empty(32, 64, device="meta"), mesh,
                      (Shard(0), Shard(1)))
lc = dryrun.LocalCounter()
with lc, dryrun.Reshard(lc) as rs:
    y = torch.ops.dryrun_case.twice(x)
assert y.placements == (Replicate(), Replicate())
assert tuple(y.to_local().shape) == (32, 64)
assert rs.repaired == {"twice": 1}
# gathered over "model" to (2, 64), then over "data" to (32, 64), float32
assert lc.collectives["all-gather"] == {"count": 2,
                                        "bytes": (2 + 32) * 64 * 4}
""", False)


def test_passes_with_other_top_k_on_the_same_shapes():
    """Reduced mixtral-8x7b x prefill_32k routed to 2, then 3 of its 4
    experts, one process: DTensor caches topk's sharding without its k, so
    the second pass ran on the first's output shapes (an IndexError)
    until each pass starts with DTensor's caches empty. More experts a
    token, more capacity slots: more FLOPs a device."""
    code = REDUCED.format(pkg="repro_torch", arch="mixtral-8x7b") + """
from repro_torch.launch import dryrun
flops = [dryrun.lower_pair("mixtral-8x7b", "prefill_32k", False,
                           cfg_overrides=dict(ov, top_k=k),
                           verbose=False)["flops"] for k in (2, 3)]
print(json.dumps(flops))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stdout + out.stderr
    two, three = json.loads(out.stdout.splitlines()[-1])
    assert three > two > 0
