"""Shared problems and comparisons of the implicit-gradient parity tests:
the problems of tests/test_diff_grad.py (`_single`, `_padded`, `_fleet`),
built with `repro` in float64 and carried over to the port."""
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np

import repro
from repro.core.types import _SYS_ARRAYS, _SYS_SCALARS
from repro.region.batch import pad_system

import repro_torch as rt
from repro_torch import interop

SP1_LEAVES = ("kappa", "cycles", "samples")
CHANNEL_LEAVES = ("gain", "bandwidth_total")
LEAVES = SP1_LEAVES + CHANNEL_LEAVES
METRICS = ("objective", "energy", "time", "accuracy")
# the forward spec of both packages: the default SP1 sweep converged tight
# (84 BCD iterations on `_single`); the reference's FD checks run the
# bisect engine (tests/test_diff_grad.py::SPEC), which costs the port ~1e5
# small ops per BCD iteration
SPEC = dict(tol=1e-11, max_iters=300)
FD_SPEC = dict(sp1_method="bisect", tol=1e-11, max_iters=300)
# values: both packages evaluate the same metrics at the same fixed point
VALUE_TOL = 1e-9
# gradients, relative to each gradient's largest entry. Measured on the
# problems here: <= 5.4e-11 for the weights, <= 5.2e-8 for the SP1-side
# leaves, <= 1.2e-7 for the channel-side leaves (the sweep's secant T
# moves the forward's last iterate by ~1e-10 between the packages, and
# the channel-side KKT derivative amplifies it most)
GRAD_TOL = {"weights": 1e-6, **{k: 1e-6 for k in SP1_LEAVES},
            **{k: 1e-6 for k in CHANNEL_LEAVES}}


def cast64(sysp):
    d = {}
    for f in dataclasses.fields(sysp):
        v = getattr(sysp, f.name)
        d[f.name] = v if f.name in ("resolutions", "active") or v is None \
            else jnp.asarray(v, jnp.float64)
    return type(sysp)(**d)


def to_port(sj):
    leaves = {k: np.asarray(getattr(sj, k)) for k in _SYS_ARRAYS + _SYS_SCALARS}
    if sj.active is not None:
        leaves["active"] = np.asarray(sj.active)
    return interop.system_from_numpy(leaves, sj.resolutions, device="cpu")


def problems(name):
    """(repro Problem, port Problem) of tests/test_diff_grad.py's `name`."""
    if name == "single":
        sj = cast64(repro.make_system(jax.random.PRNGKey(3), n_devices=8))
        ws = (0.4, 0.6, 0.3)
    elif name == "padded":
        sj = pad_system(cast64(repro.make_system(jax.random.PRNGKey(3),
                                                 n_devices=6)), 8)
        ws = (0.4, 0.6, 0.3)
    else:
        cells = [cast64(repro.make_system(jax.random.PRNGKey(k),
                                          n_devices=8)) for k in (3, 5, 9)]
        sj = jtu.tree_map(lambda *xs: jnp.stack(xs), *cells)
        ws = [(0.4, 0.6, 0.3), (0.5, 0.5, 0.2), (0.3, 0.7, 0.4)]
    if isinstance(ws, list):
        wj = [repro.Weights(*w) for w in ws]
        wt = [rt.Weights(*w) for w in ws]
    else:
        wj, wt = repro.Weights(*ws), rt.Weights(*ws)
    return (repro.Problem(system=sj, weights=wj),
            rt.Problem(system=to_port(sj), weights=wt))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def compare_grads(gt, gj, leaves, grad_tol=GRAD_TOL):
    """Port GradResult vs repro's: every metric's value to VALUE_TOL and
    every gradient to its GRAD_TOL, all finite; the accuracy metric's
    gradient is the a.e. zero subgradient in both."""
    for m in METRICS:
        v = gt.value[m].numpy()
        np.testing.assert_allclose(v, np.asarray(gj.value[m]),
                                   rtol=VALUE_TOL, err_msg=m)
        for k in ("weights",) + tuple(leaves):
            a = gt.grads[m][k].numpy()
            b = np.asarray(gj.grads[m][k]).reshape(a.shape)
            assert np.isfinite(a).all(), (m, k)
            if m == "accuracy":
                assert not a.any() and not b.any(), (m, k)
                continue
            assert rel(a, b) <= grad_tol[k], (m, k, rel(a, b))
