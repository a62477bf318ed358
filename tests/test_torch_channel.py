"""The port's system generators (`repro_torch.core.channel`): the paper's
§VII-A parameterisation drawn from a `torch.Generator`. They cannot give
`jax.random`'s numbers, so they are checked on their statistics and their
seeding, and the drawn gains against `repro`'s on distribution.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro

from repro_torch import make_fleet, make_system, stack_systems
from repro_torch.core.types import DEFAULTS, SYS_SCALARS


def test_system_parameters_follow_the_paper():
    s = make_system(0, n_devices=500, device="cpu", dtype=torch.float64)
    assert s.gain.shape == (500,) and s.dtype == torch.float64
    assert s.device.type == "cpu" and s.cells is None and s.n == 500
    assert torch.all(s.samples == DEFAULTS["samples_per_device"])
    assert torch.all(s.bits == DEFAULTS["upload_bits"])
    for k in SYS_SCALARS:
        assert getattr(s, k).shape == ()
        assert float(getattr(s, k)) == pytest.approx(float(DEFAULTS[k]),
                                                     rel=1e-15)
    assert s.resolutions == DEFAULTS["resolutions"]
    assert float(s.zeta) == 1.0 / 160.0 ** 2


def test_cycles_are_uniform_on_the_paper_range():
    c = make_system(1, n_devices=20000, device="cpu",
                    dtype=torch.float64).cycles
    assert float(c.min()) >= 1e4 and float(c.max()) <= 3e4
    assert float(c.mean()) == pytest.approx(2e4, rel=0.01)
    assert float(c.std()) == pytest.approx(2e4 / math.sqrt(12), rel=0.03)


def test_gains_follow_the_pathloss_model():
    """Distances are uniform in the 500 m square: the gain is bounded by
    the corner (353.6 m) and the 1 m floor, and its distribution matches
    the reference generator's."""
    n = 20000
    g = make_system(2, n_devices=n, device="cpu", dtype=torch.float64).gain
    shadow = math.exp((8.0 * math.log(10.0) / 10.0) ** 2 / 2.0)

    def gain_at(d_m):
        return 10.0 ** (-(128.1 + 37.6 * math.log10(d_m / 1000.0)) / 10.0) \
            * shadow

    assert float(g.min()) >= gain_at(250.0 * math.sqrt(2.0)) * (1 - 1e-12)
    assert float(g.max()) <= gain_at(1.0)
    ref = np.asarray(repro.make_system(jax.random.PRNGKey(2),
                                       n_devices=n).gain)
    qs = [0.1, 0.25, 0.5, 0.75, 0.9]
    np.testing.assert_allclose(np.quantile(np.log10(g.numpy()), qs),
                               np.quantile(np.log10(ref), qs), atol=0.03)


def test_seeding_is_reproducible():
    a = make_system(7, n_devices=64, device="cpu")
    b = make_system(7, n_devices=64, device="cpu")
    c = make_system(8, n_devices=64, device="cpu")
    assert torch.equal(a.gain, b.gain) and torch.equal(a.cycles, b.cycles)
    assert not torch.equal(a.gain, c.gain)
    gen = torch.Generator().manual_seed(7)
    first = make_system(gen, n_devices=64, device="cpu")
    second = make_system(gen, n_devices=64, device="cpu")
    assert torch.equal(first.gain, a.gain)
    assert not torch.equal(second.gain, first.gain)


def test_dtype_is_a_cast_of_the_same_draw():
    a = make_system(3, n_devices=64, device="cpu", dtype=torch.float64)
    b = make_system(3, n_devices=64, device="cpu", dtype=torch.float32)
    assert b.dtype == torch.float32 and b.bandwidth_total.dtype == torch.float32
    assert torch.equal(b.gain, a.gain.float())


def test_fleet_stacks_independent_cells():
    f = make_fleet(5, 3, 40, device="cpu", bandwidth_total=[1e7, 2e7, 4e7])
    assert f.gain.shape == (3, 40) and f.cells == 3
    for k in SYS_SCALARS:
        assert getattr(f, k).shape == (3, 1)
    assert f.bandwidth_total[:, 0].tolist() == [1e7, 2e7, 4e7]
    assert not torch.equal(f.gain[0], f.gain[1])
    gen = torch.Generator().manual_seed(5)
    first = make_system(gen, n_devices=40, device="cpu")
    assert torch.equal(f.cell(0).gain, first.gain)
    assert f.cell(2).bandwidth_total.shape == ()
    again = stack_systems([f.cell(c) for c in range(3)])
    assert torch.equal(again.gain, f.gain)
    assert torch.equal(again.bandwidth_total, f.bandwidth_total)


def test_fleet_rejects_bad_overrides():
    with pytest.raises(ValueError, match="per-cell override"):
        make_fleet(0, 3, 8, device="cpu", p_max=[0.01, 0.02])
    a = make_system(0, n_devices=8, device="cpu")
    b = make_system(1, n_devices=8, device="cpu", resolutions=(160.0, 320.0))
    with pytest.raises(ValueError, match="resolutions"):
        stack_systems([a, b])
