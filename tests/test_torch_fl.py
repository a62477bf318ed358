"""The port's FL stack (`repro_torch.fl`, `models/cnn.py`,
`launch/flmar.py`, `diff.fit_from_training`) against `repro`, on the CPU
in float64.

Datasets, eval sets, initial parameters and the rounds' draws are the
reference's `jax.random` draws, rebuilt by splitting its keys
(`tests/_torch_fl.py`) and carried over through `interop`; the port's own
generators are held to their statistics. Most comparisons share one
dataset shape, `simulate`'s default for 4 devices (DS), and one eval-set
size, so the reference compiles each of its functions about once per
resolution.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_stub import given, settings, st

import repro.fl as flj
from repro.core import Weights as WeightsJ
from repro.core import make_system as make_system_j
from repro.dynamics import RoundsConfig as RoundsConfigJ
from repro.models import cnn as cnn_j

import repro_torch as rt
from repro_torch import fl
from repro_torch.models import cnn

import _torch_fl as H
from _torch_rounds import to_port

KEY = jax.random.PRNGKey(3)
RES = (4, 8, 12, 16, 24, 32)
DS = dict(n_clients=4, per_client=256, num_classes=8, base_resolution=32)
EVAL_N = 512


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def small_ds():
    """(repro's dataset, the port's) of shape DS."""
    return (flj.make_federated_dataset(KEY, **DS),
            fl.make_federated_dataset(H.dataset_draws(KEY, **DS)))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split,unbalanced", [
    ("iid", False), ("iid", True), ("noniid-1", False),
    ("noniid-2", True)])
def test_dataset_matches_repro(split, unbalanced):
    dj = flj.make_federated_dataset(KEY, split=split, unbalanced=unbalanced,
                                    **DS)
    dt = fl.make_federated_dataset(H.dataset_draws(KEY, split=split, **DS),
                                   unbalanced=unbalanced)
    np.testing.assert_array_equal(dt.labels.numpy(), np.asarray(dj.labels))
    np.testing.assert_allclose(dt.templates.numpy(),
                               np.asarray(dj.templates), rtol=0, atol=1e-12)
    np.testing.assert_allclose(dt.images.numpy(), np.asarray(dj.images),
                               rtol=0, atol=1e-12)
    assert (dt.base_resolution, dt.num_classes, dt.noise) == \
        (dj.base_resolution, dj.num_classes, dj.noise)


def test_render_and_eval_set_match_repro(small_ds):
    dj, dt = small_ds
    for r in RES:      # 24 does not divide 32: the top-left 24 x 24 crop
        np.testing.assert_allclose(fl.render(dt.images, r).numpy(),
                                   np.asarray(flj.render(dj.images, r)),
                                   rtol=0, atol=1e-12)
    x = torch.arange(16.0).reshape(1, 4, 4, 1)
    np.testing.assert_allclose(fl.render(x, 2)[0, :, :, 0].numpy(),
                               [[2.5, 4.5], [10.5, 12.5]])
    assert torch.equal(fl.render(dt.images, 32), dt.images)
    k = jax.random.PRNGKey(9)
    ij, lj = flj.make_eval_set(k, dj, n=EVAL_N)
    it, lt = fl.make_eval_set(H.eval_draws(k, EVAL_N, 8, 32), dt)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=0,
                               atol=1e-12)


def test_port_generators_statistics():
    """The port's own draws (torch.Generator, not jax.random): labels,
    shifts, noise, Dirichlet fractions and parameters on their laws, and
    the same seed gives the same dataset."""
    d = fl.dataset_draws(0, n_clients=16, per_client=256, num_classes=8,
                         base_resolution=16, device="cpu",
                         dtype=torch.float64)
    counts = torch.bincount(d.labels.ravel(), minlength=8).double()
    assert float((counts / counts.sum() - 1 / 8).abs().max()) < 0.02
    assert set(d.sample.shift.unique().tolist()) == {-1, 0, 1}
    pix = d.sample.pix
    assert abs(float(pix.mean())) < 0.01 and abs(float(pix.std()) - 1) < 0.01
    assert [z.shape[1] for z in d.templates] == [4, 8, 16]
    assert abs(float(d.frac.sum()) - 1.0) < 1e-12 and bool((d.frac > 0).all())
    non = fl.dataset_draws(1, n_clients=64, per_client=32, num_classes=8,
                           split="noniid-2", device="cpu")
    owned = [len(row.unique()) for row in non.labels]
    assert max(owned) == 2 and np.mean(owned) > 1.9
    one = fl.dataset_draws(1, n_clients=8, per_client=32, num_classes=8,
                           split="noniid-1", device="cpu")
    assert all(len(row.unique()) == 1 for row in one.labels)
    with pytest.raises(ValueError, match="unknown split"):
        fl.dataset_draws(1, split="dirichlet", device="cpu")
    a = fl.make_federated_dataset(5, 2, 4, base_resolution=8, device="cpu")
    b = fl.make_federated_dataset(5, 2, 4, base_resolution=8, device="cpu")
    assert torch.equal(a.images, b.images)
    p = cnn.init_cnn(0, num_classes=8, widths=(64, 64), device="cpu",
                     dtype=torch.float64)
    w = p["conv1"]["w"]
    assert w.shape == (64, 64, 3, 3)
    assert abs(float(w.std()) / (2.0 / (9 * 64)) ** 0.5 - 1) < 0.05
    assert float(p["head"]["b"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the model and one client
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", RES)
def test_apply_cnn_matches_repro(small_ds, r):
    dj, _ = small_ds
    pj = cnn_j.init_cnn(jax.random.PRNGKey(1), num_classes=8)
    x = flj.render(dj.images[0], r)
    want = np.asarray(cnn_j.apply_cnn(pj, x))
    got = cnn.apply_cnn(H.cnn_params(pj), t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_xent_loss_gradient_and_module_match_repro(small_ds):
    dj, _ = small_ds
    pj = cnn_j.init_cnn(jax.random.PRNGKey(2), num_classes=8)
    x, y = flj.render(dj.images[1], 12), dj.labels[1]
    lj, gj = jax.value_and_grad(cnn_j.xent_loss)(pj, x, y)
    params = {k: {kk: vv.requires_grad_(True) for kk, vv in v.items()}
              for k, v in H.cnn_params(pj).items()}
    loss = cnn.xent_loss(params, t(x), t(y))
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(lj)) <= 1e-12 * abs(float(lj))
    H.params_close({k: {kk: vv.grad for kk, vv in v.items()}
                    for k, v in params.items()}, gj, rtol=1e-10)
    assert float(cnn.accuracy(params, t(x), t(y))) == float(
        cnn_j.accuracy(pj, x, y))
    module = cnn.CNN(H.cnn_params(pj))
    assert torch.equal(module(t(x)), cnn.apply_cnn(H.cnn_params(pj), t(x)))
    assert sorted(module.params()) == ["conv0", "conv1", "conv2", "head"]


def test_local_train_matches_repro(small_ds):
    dj, _ = small_ds
    pj = cnn_j.init_cnn(jax.random.PRNGKey(4), num_classes=8)
    x, y = flj.render(dj.images[2], 4), dj.labels[2]
    pnj, lossj = flj.local_train(pj, x, y, 0.05, 2)
    p0 = H.cnn_params(pj)
    pnt, losst = fl.local_train(p0, t(x), t(y), 0.05, 2)
    # the loss of the last step's start, before its update
    assert abs(float(losst) - float(lossj)) <= 1e-10 * abs(float(lossj))
    H.params_close(pnt, pnj, rtol=1e-10)
    # the input parameters are left as they were, and no leaf keeps a graph
    H.params_close(p0, pj, rtol=0)
    assert not any(x.requires_grad for v in pnt.values() for x in v.values())
    delta = fl.client_delta(p0, pnt)
    assert torch.equal(delta["head"]["b"], pnt["head"]["b"] - p0["head"]["b"])
    same, zero = fl.local_train(p0, t(x), t(y), 0.05, 0)
    assert float(zero) == 0.0 and torch.equal(same["head"]["w"],
                                              p0["head"]["w"])


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def test_fedavg_and_staleness_weights_match_repro():
    pjs = [cnn_j.init_cnn(jax.random.PRNGKey(i), num_classes=8)
           for i in range(3)]
    pts = [H.cnn_params(p) for p in pjs]
    w = [3.0, 1.0, 2.5]
    H.params_close(fl.fedavg(pts, w), flj.fedavg(pjs, jnp.asarray(w)),
                   rtol=1e-15)
    H.params_close(fl.fedavg_stale(pts[0], pts[1:], [2.0, 1.0], 6.0),
                   flj.fedavg_stale(pjs[0], pjs[1:], [2.0, 1.0], 6.0),
                   rtol=1e-15)
    assert fl.fedavg_stale(pts[0], [], [], 4.0) is pts[0]
    # full on-time participation is plain fedavg, bit for bit
    full = fl.fedavg_stale(pts[0], pts[1:], [2.0, 2.0], 4.0)
    plain = fl.fedavg(pts[1:] + [pts[0]], [2.0, 2.0, 0.0])
    assert torch.equal(full["conv1"]["w"], plain["conv1"]["w"])
    for k in range(4):
        assert float(fl.stale_weights(64.0, k, 0.5)) == float(
            flj.stale_weights(jnp.asarray(64.0), k, 0.5))
    assert fl.resolve_eval_resolution(None, torch.tensor([16, 4, 8])) == 8
    assert fl.resolve_eval_resolution(4, [4, 8, 16]) == 4
    with pytest.raises(ValueError, match="eval_resolution"):
        fl.resolve_eval_resolution(0, [4, 8, 16])


def test_run_federated_with_staleness_matches_repro():
    key = jax.random.PRNGKey(21)
    dj = flj.make_federated_dataset(key, **DS)
    dt = fl.make_federated_dataset(H.dataset_draws(key, **DS))
    stale = np.zeros((4, 4), np.int32)
    stale[0, 1], stale[1, 2], stale[2, 0], stale[3, 1] = 1, -1, 2, 1
    run = dict(global_rounds=4, local_iters=2, lr=0.05, eval_n=EVAL_N)
    # one resolution, so the reference compiles one local_train
    rj = flj.run_federated(jax.random.PRNGKey(22), dj, [4] * 4,
                           staleness=stale, **run)
    rp = fl.run_federated(H.run_draws(jax.random.PRNGKey(22), 8, 32, EVAL_N),
                          dt, [4] * 4, staleness=torch.tensor(stale), **run)
    np.testing.assert_allclose(rp.round_loss, rj.round_loss, rtol=1e-10)
    assert rp.round_accuracy == rj.round_accuracy
    H.params_close(rp.params, rj.params, rtol=1e-10)
    # every update lost in a round: NaN loss, the model frozen
    lost = fl.run_federated(3, dt, [4] * 4, staleness=-np.ones((2, 4)),
                            global_rounds=2, local_iters=1, eval_n=16)
    assert np.isnan(lost.round_loss[0])
    assert lost.round_accuracy[0] == lost.round_accuracy[1]


# ---------------------------------------------------------------------------
# the simulator and the entry points
# ---------------------------------------------------------------------------

def test_map_resolution_to_dataset_matches_repro():
    sj = make_system_j(jax.random.PRNGKey(20), n_devices=4)
    st_ = to_port(sj)
    s = np.array([150.0, 320.0, 400.0, 500.0, 640.0])
    for grid in ((4, 8, 12, 16), (4, 8), (4, 8, 12, 16, 20, 24)):
        got = fl.map_resolution_to_dataset(st_, torch.tensor(s), grid)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(flj.map_resolution_to_dataset(
                sj, jnp.asarray(s), grid)))
    sj6 = sj.replace(resolutions=(100.0, 200.0, 300.0, 400.0, 500.0, 600.0))
    st6 = st_.replace(resolutions=sj6.resolutions)
    s6 = np.array([100.0, 290.0, 350.0, 610.0])
    np.testing.assert_array_equal(
        fl.map_resolution_to_dataset(st6, torch.tensor(s6),
                                     (4, 8, 12, 16)).numpy(),
        np.asarray(flj.map_resolution_to_dataset(sj6, jnp.asarray(s6),
                                                 (4, 8, 12, 16))))


def test_simulate_ledger_matches_repro():
    """N = 4 devices over 2 rounds of Markov fading with stale
    participation and dropout: the reference's draws for the dataset, the
    FL run and the rounds."""
    key = jax.random.PRNGKey(6)
    sj = make_system_j(key, n_devices=4)
    cfg = dict(rounds=2, channel_mode="markov", drift_rho=0.9, bcd_iters=3,
               bcd_tol=1e-3, participation="stale", dropout_prob=0.2,
               deadline_slack=0.99)
    sim = dict(dataset_resolutions=(4, 8, 12, 16), global_rounds=2,
               local_iters=2)
    kj = jax.random.fold_in(key, 1)
    res_j = flj.simulate(kj, sj, WeightsJ(0.5, 0.5, 10.0),
                         dynamics=RoundsConfigJ(**cfg), **sim)
    res_t = fl.simulate(H.sim_draws(kj, 4, RoundsConfigJ(**cfg), 8, 32),
                        to_port(sj), rt.Weights(0.5, 0.5, 10.0),
                        dynamics=rt.RoundsConfig(**cfg), **sim)
    assert res_t.ledger.keys() == res_j.ledger.keys()
    for k, v in res_j.ledger.items():
        assert res_t.ledger[k] == pytest.approx(v, rel=1e-9, abs=1e-12), k
    np.testing.assert_array_equal(res_t.rounds.staleness.numpy(),
                                  np.asarray(res_j.rounds.staleness))
    np.testing.assert_allclose(res_t.fl.round_loss, res_j.fl.round_loss,
                               rtol=1e-9)
    assert res_t.fl.round_accuracy == res_j.fl.round_accuracy
    led = res_t.ledger
    assert led["energy_total_J"] == pytest.approx(
        led["energy_per_round_J"] * 2, rel=1e-6)


def test_simulate_static_from_a_seed():
    """The port's own draws from one seed, the static default: the
    allocate-once ledger, a run per device, and the same bits twice."""
    sysp = rt.make_system(6, n_devices=3, device="cpu", dtype=torch.float64)
    kw = dict(dataset_resolutions=(4, 8, 12, 16), global_rounds=2,
              local_iters=1)
    ds = fl.make_federated_dataset(1, n_clients=3, per_client=16,
                                   num_classes=4, base_resolution=16,
                                   device="cpu", dtype=torch.float64)
    a = fl.simulate(2, sysp, rt.Weights(0.5, 0.5, 10.0), dataset=ds, **kw)
    b = fl.simulate(2, sysp, rt.Weights(0.5, 0.5, 10.0), dataset=ds, **kw)
    assert a.ledger == b.ledger
    assert torch.equal(a.fl.params["head"]["w"], b.fl.params["head"]["w"])
    assert a.rounds.staleness.abs().sum() == 0
    assert a.ledger["energy_total_J"] == pytest.approx(
        2 * a.ledger["energy_per_round_J"], rel=1e-12)
    with pytest.raises(ValueError, match="one device per FL client"):
        fl.simulate(2, rt.make_system(6, 4, device="cpu"),
                    rt.Weights(0.5, 0.5, 10.0), dataset=ds, **kw)


def test_flmar_main_on_the_cpu(capsys):
    from repro_torch.launch import flmar

    res = flmar.main(["--devices", "3", "--rounds", "2", "--local-iters",
                      "1", "--per-client", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "== proposed allocator" in out and "MinPixel" in out \
        and "RandPixel" in out
    assert all(np.isfinite(v) for v in res.ledger.values())


def test_fit_from_training_small():
    from repro_torch.diff import fit_from_training

    model = fit_from_training(0, menu=(160.0, 320.0, 480.0),
                              dataset_resolutions=(4, 8, 16), n_clients=2,
                              per_client=16, global_rounds=2, local_iters=1,
                              eval_n=32, device="cpu")
    assert np.all(np.diff(model.knots) > 0)
    assert np.all(np.diff(model.values) >= 0)
    assert np.isfinite(model.values).all() and model.menu == (160.0, 320.0,
                                                              480.0)


def test_fit_from_training_matches_reference():
    """`fit_from_training` on the reference's draws: the knots and fitted
    values of `repro.diff.fit_from_training` to 1e-9."""
    from repro.diff import fit_from_training as fit_j
    from repro_torch.diff import fit_from_training

    # DS's clients, classes and eval size and local_iters=2, as the
    # run_federated and simulate comparisons, so the reference reuses
    # their compiled local_train and eval at these shapes
    kw = dict(menu=(160.0, 480.0), dataset_resolutions=(4, 8),
              n_clients=4, per_client=256, num_classes=8, global_rounds=2,
              local_iters=2, eval_n=EVAL_N)
    ref = fit_j(5, **kw)
    draws = H.fit_draws(5, kw["dataset_resolutions"], kw["n_clients"],
                        kw["per_client"], kw["num_classes"], kw["eval_n"])
    got = fit_from_training(draws, **kw)
    np.testing.assert_allclose(got.knots, ref.knots, rtol=1e-9)
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-9,
                               atol=1e-12)
    assert got.menu == ref.menu
    with pytest.raises(ValueError, match="2 run draws for 3"):
        fit_from_training(draws, menu=(160.0, 320.0, 480.0),
                          dataset_resolutions=(4, 8, 12))


def test_deterministic_algorithms_scope_restores_the_mode():
    fill = torch.utils.deterministic.fill_uninitialized_memory
    assert not torch.are_deterministic_algorithms_enabled()
    with fl.deterministic_algorithms():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert not torch.utils.deterministic.fill_uninitialized_memory
    assert not torch.are_deterministic_algorithms_enabled()
    assert not torch.is_deterministic_algorithms_warn_only_enabled()
    assert torch.utils.deterministic.fill_uninitialized_memory == fill
    # a caller's warn-only mode comes back too
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with fl.deterministic_algorithms():
            assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
    finally:
        torch.use_deterministic_algorithms(False)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 1000))
def test_property_fedavg_stays_in_the_hull(seed):
    ps = [cnn.init_cnn(seed * 3 + i, num_classes=3, device="cpu",
                       dtype=torch.float64) for i in range(3)]
    w = torch.rand(3, generator=torch.Generator().manual_seed(seed)) + 0.1
    avg = fl.fedavg(ps, w)
    for layer in avg:
        for leaf in avg[layer]:
            xs = torch.stack([p[layer][leaf] for p in ps])
            assert bool((avg[layer][leaf] >= xs.amin(0) - 1e-12).all())
            assert bool((avg[layer][leaf] <= xs.amax(0) + 1e-12).all())
