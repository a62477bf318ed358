"""Shared helpers of the association and FL parity tests: systems and CNN
parameters carried over from `repro`, and the reference's `jax.random`
draws rebuilt by splitting the key exactly as `repro/fl/data.py`,
`repro/fl/server.py`, `repro/fl/simulator.py`,
`repro/diff/surrogate.py` and `repro/assoc/scenario.py` do."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.core.channel import device_positions
from repro.core.channel import make_system as make_system_j
from repro.models.cnn import init_cnn as init_cnn_j

from _torch_rounds import reference_draws, to_port
from repro_torch import interop
from repro_torch.diff import FitDraws
from repro_torch.fl import RunDraws, SimDraws

SCALES = (4, 8, 16, 32, 64)


def multicell_inputs(key, n_devices, area_m=1000.0, **overrides):
    """The base single-cell system (on the port, CPU) and the (N, 2)
    positions `repro.assoc.make_multicell(key, ...)` draws; `overrides`
    are the scalar (not per-cell) ones."""
    kp, ka = jax.random.split(key)
    base = make_system_j(ka, n_devices=n_devices, area_m=area_m,
                         **overrides)
    pos = np.asarray(device_positions(kp, n_devices, area_m))
    return to_port(base), pos


def sample_draws(key, shape, base):
    """One `repro.fl.data._sample` call's (shift, smooth, pix)."""
    k_shift, k_smooth, k_pix = jax.random.split(key, 3)
    shape = tuple(shape)
    return (np.asarray(jax.random.randint(k_shift, shape + (2,), -1, 2)),
            np.asarray(jax.random.normal(k_smooth, shape + (4, 4, 1))),
            np.asarray(jax.random.normal(k_pix, shape + (base, base, 1))))


def dataset_draws(key, n_clients=10, per_client=256, num_classes=8,
                  base_resolution=32, split="iid"):
    """The draws of `repro.fl.make_federated_dataset(key, ...)` as the
    port's `FLDraws` (CPU)."""
    k_tpl, k_lbl, k_draw, k_sizes = jax.random.split(key, 4)
    scales = [s for s in SCALES if s <= base_resolution]
    templates = [np.asarray(jax.random.normal(jax.random.fold_in(k_tpl, i),
                                              (num_classes, s, s, 1)))
                 for i, s in enumerate(scales)]
    if split == "iid":
        labels = np.asarray(jax.random.randint(
            k_lbl, (n_clients, per_client), 0, num_classes))
    else:
        per_cls = 1 if split == "noniid-1" else 2
        rng = np.random.default_rng(
            int(jax.random.randint(k_lbl, (), 0, 2 ** 31 - 1)))
        owned = np.stack([rng.choice(num_classes, size=per_cls,
                                     replace=False)
                          for _ in range(n_clients)])
        pick = rng.integers(0, per_cls, size=(n_clients, per_client))
        labels = np.take_along_axis(owned, pick, axis=1)
    shift, smooth, pix = sample_draws(k_draw, labels.shape, base_resolution)
    frac = np.asarray(jax.random.dirichlet(k_sizes, jnp.ones((n_clients,))))
    return interop.fl_draws_from_numpy(labels, shift, smooth, pix,
                                       templates=templates, frac=frac,
                                       device="cpu")


def eval_draws(key, n, num_classes, base):
    """The draws of `repro.fl.make_eval_set(key, ds, n)`."""
    k_lbl, k_draw = jax.random.split(key)
    labels = np.asarray(jax.random.randint(k_lbl, (n,), 0, num_classes))
    return interop.fl_draws_from_numpy(labels, *sample_draws(
        k_draw, labels.shape, base), device="cpu")


def cnn_params(params_j):
    """A reference parameter dict on the port (CPU)."""
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params_j.items()}
    return interop.cnn_params_from_numpy(tree, device="cpu")


def run_draws(key, num_classes, base, eval_n=512):
    """The draws of `repro.fl.run_federated(key, ds, ...)`."""
    k_init, k_eval = jax.random.split(key)
    return RunDraws(params=cnn_params(init_cnn_j(k_init,
                                                 num_classes=num_classes)),
                    eval=eval_draws(k_eval, eval_n, num_classes, base))


def sim_draws(key, n, cfg, num_classes, base, dataset=True, eval_n=512):
    """The draws of `repro.fl.simulate(key, sys, ...)` on an N-device
    cell whose rounds run under `cfg` (its `rounds` set to the run's):
    the dataset (its default sizes, when `dataset`), the run, the rounds."""
    k_ds, k_fl = jax.random.split(key)
    k_dyn = jax.random.fold_in(key, 2)
    return SimDraws(
        dataset=dataset_draws(k_ds, n_clients=n) if dataset else None,
        run=run_draws(k_fl, num_classes, base, eval_n),
        rounds=reference_draws(k_dyn, n, cfg, jnp.float64))


def fit_draws(key, dataset_resolutions, n_clients, per_client, num_classes,
              eval_n, split="iid"):
    """The draws of `repro.diff.fit_from_training(key, ...)` (an integer
    key) as the port's `FitDraws`: the dataset, then one run per dataset
    resolution."""
    k_ds, k_run = jax.random.split(jax.random.PRNGKey(key))
    base = int(max(dataset_resolutions))
    return FitDraws(
        dataset=dataset_draws(k_ds, n_clients, per_client, num_classes,
                              base, split),
        runs=[run_draws(jax.random.fold_in(k_run, i), num_classes, base,
                        eval_n)
              for i in range(len(dataset_resolutions))])


def params_close(a, b_j, rtol):
    """Port parameters `a` vs a reference dict `b_j`, leaf by leaf, to
    `rtol` of each leaf's largest magnitude."""
    b = cnn_params(b_j)
    for layer in b:
        for leaf in b[layer]:
            x, y = a[layer][leaf].numpy(), b[layer][leaf].numpy()
            np.testing.assert_allclose(
                x, y, rtol=rtol, atol=rtol * max(np.abs(y).max(), 1e-30),
                err_msg=f"{layer}.{leaf}")
