"""The port's cost model (`repro_torch.core.costmodel`) against `repro`'s,
and the mirrors of tests/test_costmodel.py on the port."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax

import repro.core.channel as rchannel
from repro.configs import ARCHS as R_ARCHS
from repro.core import costmodel as rcm

import repro_torch as rt
import repro_torch.core.channel as tchannel
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import costmodel as tcm
from repro_torch.core.energy import feasible
from repro_torch.roofline import params_active, params_total


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_from_config_matches_reference(arch):
    got, want = tcm.from_config(ARCHS[arch]), rcm.from_config(R_ARCHS[arch])
    assert got.name == want.name
    for f in ("flops_per_token", "params_active", "params_total"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12)
    for tokens in (1, 100, 4096):
        for training in (True, False):
            assert got.cycles_per_standard_sample(tokens, training) == \
                pytest.approx(want.cycles_per_standard_sample(tokens,
                                                              training),
                              rel=1e-12)


def test_constants_and_helpers_match_reference():
    assert tcm.FLOPS_PER_CYCLE == rcm.FLOPS_PER_CYCLE
    assert tcm.PATCH == rcm.PATCH
    for s in (16, 100, 160, 320, 640, 1000):
        assert tcm.tokens_for_resolution(s) == rcm.tokens_for_resolution(s)
    args = (4096, 14336, 32, 8, 128, 2048)
    assert tcm.dense_layer_flops(*args) == rcm.dense_layer_flops(*args)


@pytest.mark.parametrize("arch, kw", [
    ("internlm2-20b", {}),
    ("rwkv6-1.6b", dict(device_flops_per_cycle=1024.0, samples_per_device=8,
                        local_iters=3)),
    ("jamba-1.5-large-398b", dict(p_max=0.5)),
])
def test_arch_system_cycle_bounds_exactly(monkeypatch, arch, kw):
    """arch_system hands make_system the reference's keywords, the cycle
    bounds bit for bit."""
    seen = {}

    def spy(name, real):
        def make_system(gen, n_devices=None, **k):
            seen[name] = k
            return real(gen, n_devices=n_devices, **k)
        return make_system

    monkeypatch.setattr(rchannel, "make_system",
                        spy("repro", rchannel.make_system))
    monkeypatch.setattr(tchannel, "make_system",
                        spy("port", tchannel.make_system))
    rcm.arch_system(jax.random.PRNGKey(0), arch, n_devices=5, **kw)
    sysp = tcm.arch_system(0, arch, n_devices=5, device="cpu",
                           dtype=torch.float64, **kw)
    port = dict(seen["port"])
    assert port.pop("device") == "cpu" and port.pop("dtype") == torch.float64
    assert port == seen["repro"]
    lo, hi = port["cycles_lo"], port["cycles_hi"]
    assert sysp.cycles.shape == (5,)
    assert bool(((sysp.cycles >= lo) & (sysp.cycles <= hi)).all())


# mirrors of tests/test_costmodel.py, on the port

def test_param_counts_match_model_cards():
    expected = {
        "qwen2-72b": 72e9, "mixtral-8x7b": 47e9, "dbrx-132b": 132e9,
        "internlm2-20b": 20e9, "jamba-1.5-large-398b": 398e9,
        "minicpm3-4b": 4e9, "llava-next-34b": 34e9,
    }
    for arch, exp in expected.items():
        got = params_total(get_config(arch))
        assert abs(got - exp) / exp < 0.1, (arch, got, exp)


def test_active_less_than_total_for_moe():
    for arch in ["mixtral-8x7b", "dbrx-132b", "jamba-1.5-large-398b"]:
        cfg = get_config(arch)
        assert params_active(cfg) < 0.6 * params_total(cfg)
    cfg = get_config("qwen2-72b")
    assert params_active(cfg) == pytest.approx(params_total(cfg), rel=0.01)


def test_tokens_for_resolution_quadratic():
    assert tcm.tokens_for_resolution(320) == 4 * tcm.tokens_for_resolution(160)


def test_arch_system_allocates_feasibly():
    sysp = tcm.arch_system(0, "rwkv6-1.6b", n_devices=6, device="cpu")
    res = rt.solve(rt.Problem(system=sysp, weights=rt.Weights(0.5, 0.5, 1.0)),
                   rt.SolverSpec(max_iters=4))
    assert feasible(sysp, res.allocation)


def test_heavier_arch_prefers_lower_resolution():
    rho = 2e4
    s_light = tcm.arch_system(1, "rwkv6-1.6b", n_devices=6, device="cpu")
    s_heavy = tcm.arch_system(1, "internlm2-20b", n_devices=6, device="cpu")
    w, spec = rt.Weights(0.5, 0.5, rho), rt.SolverSpec(max_iters=4)
    r_light = rt.solve(rt.Problem(system=s_light, weights=w), spec)
    r_heavy = rt.solve(rt.Problem(system=s_heavy, weights=w), spec)
    assert float(r_heavy.allocation.resolution.mean()) <= \
        float(r_light.allocation.resolution.mean()) + 1e-6


def test_arch_system_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcm.arch_system(0, "rwkv6-1.6b", n_devices=4)
    assert dataclasses.is_dataclass(
        tcm.arch_system(0, "rwkv6-1.6b", n_devices=4, device="cpu"))
