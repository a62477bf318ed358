"""The slice as a whole: examples/fedavg_lm.py's flow (the allocator sets
each LM client's token budget and (p, B) schedule from the cost model's
c_n, then FedAvg rounds of local SGD) through `repro` and through
`repro_torch.launch.fedavg_lm`, on the same system, initial weights and
`SyntheticLM` batches: reduced internlm2-20b in float32, 2 clients x 2
rounds x 2 local steps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import Problem, SolverSpec, Weights, solve
from repro.configs import ARCHS as R_ARCHS
from repro.core.costmodel import arch_system
from repro.core.energy import e_cmp, e_trans, round_time
from repro.data import SyntheticLM
from repro.launch.steps import make_train_step
from repro.models.transformer import init_model
from repro.optim import SGD

from repro_torch import interop
from repro_torch.configs import ARCHS
from repro_torch.core.energy import feasible
from repro_torch.core.types import SYS_ARRAYS, SYS_SCALARS
from repro_torch.launch import fedavg_lm
from repro_torch.models.transformer import param_tree

CLIENTS, ROUNDS, STEPS = 2, 2, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def reference_flow(cfg, key):
    """examples/fedavg_lm.py with repro, cut to CLIENTS x ROUNDS x STEPS."""
    system = arch_system(key, "internlm2-20b", n_devices=CLIENTS)
    res = solve(Problem(system=system, weights=Weights(0.5, 0.5, 3e4)),
                SolverSpec(max_iters=4))
    alloc = res.allocation
    grid = list(system.resolutions)
    budgets = [32 * (1 + grid.index(float(s))) for s in alloc.resolution]
    params = init_model(key, cfg)
    init = jax.tree_util.tree_map(np.asarray, params)
    opt = SGD(lr=0.3)
    step_fn = jax.jit(make_train_step(cfg, opt)[0])
    streams = [iter(SyntheticLM(cfg.vocab_size, 4, max(budgets), seed=i))
               for i in range(CLIENTS)]
    losses = []
    for _ in range(ROUNDS):
        updated, ls = [], []
        for c in range(CLIENTS):
            p_c, o_c = params, opt.init(params)
            for _ in range(STEPS):
                toks = jnp.asarray(next(streams[c])["tokens"][:, :budgets[c]])
                p_c, o_c, m = step_fn(p_c, o_c, {"tokens": toks})
            updated.append(p_c)
            ls.append(float(m["loss"]))
        params = jax.tree_util.tree_map(
            lambda *leaves: sum(l.astype(jnp.float32) for l in leaves).astype(
                leaves[0].dtype) / len(leaves), *updated)
        losses.append(ls)
    energy = float(jnp.sum(e_trans(system, alloc.bandwidth, alloc.power)
                           + e_cmp(system, alloc.freq, alloc.resolution)))
    return dict(system=system, alloc=alloc, budgets=budgets, init=init,
                params=params, losses=losses, energy=energy,
                makespan=float(round_time(system, alloc)))


@pytest.fixture(scope="module")
def flows():
    cfg_r = R_ARCHS["internlm2-20b"].reduced().replace(dtype="float32")
    cfg_t = ARCHS["internlm2-20b"].reduced().replace(dtype="float32")
    ref = reference_flow(cfg_r, jax.random.PRNGKey(0))
    sj = ref["system"]
    leaves = {k: np.asarray(getattr(sj, k)) for k in SYS_ARRAYS + SYS_SCALARS}
    system = interop.system_from_numpy(leaves, sj.resolutions, device="cpu")
    al = fedavg_lm.allocate(system)
    model = interop.model_params_from_numpy(ref["init"], cfg_t, device="cpu")
    rounds = []
    losses = fedavg_lm.train_rounds(
        model, cfg_t, al.budgets, rounds=ROUNDS, local_steps=STEPS,
        on_round=lambda r, m, clients: rounds.append(
            (r, {n: p.clone() for n, p in m.named_parameters()}, clients)))
    return ref, dict(system=system, al=al, model=model, losses=losses,
                     rounds=rounds)


def test_allocation_and_budgets_match_reference(flows):
    ref, port = flows
    a, ra = port["al"].result.allocation, ref["alloc"]
    for f in ("bandwidth", "power", "freq"):
        np.testing.assert_allclose(getattr(a, f).numpy(),
                                   np.asarray(getattr(ra, f)), rtol=1e-6)
    np.testing.assert_array_equal(a.resolution.numpy(),
                                  np.asarray(ra.resolution))
    assert feasible(port["system"], a)
    assert port["al"].budgets == ref["budgets"]
    assert port["al"].energy_per_round == pytest.approx(ref["energy"],
                                                        rel=1e-6)
    assert port["al"].makespan == pytest.approx(ref["makespan"], rel=1e-6)


def test_client_losses_and_final_weights_match_reference(flows):
    ref, port = flows
    np.testing.assert_allclose(np.asarray(port["losses"]),
                               np.asarray(ref["losses"]), rtol=1e-4)
    got = param_tree(port["model"])
    want = jax.tree_util.tree_map(np.asarray, ref["params"])
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: 0, got)))
    for path, w in flat_w:
        g = got
        for k in path:
            g = g[k.key]
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * scale, path


def test_fedavg_is_the_float32_mean_each_round(flows):
    _, port = flows
    assert [r for r, _, _ in port["rounds"]] == list(range(ROUNDS))
    for _, glob, clients in port["rounds"]:
        assert len(clients) == CLIENTS
        for name, g in glob.items():
            mean = sum(c[name].float() for c in clients) / CLIENTS
            assert torch.equal(g, mean.to(g.dtype)), name


def test_main_runs_the_example_flow(capsys):
    """`main` is the example's fixed flow (4 clients, 5 rounds, 3 local
    steps, the reduced internlm2-20b): finite losses that fall from the
    first round to the last, and the budgets, energy and makespan of the
    allocation for 4 clients."""
    losses = fedavg_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert np.asarray(losses).shape == (fedavg_lm.ROUNDS,
                                        fedavg_lm.N_CLIENTS)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-1]) < np.mean(losses[0])
    al = fedavg_lm.allocate(fedavg_lm.arch_system(
        0, "internlm2-20b", n_devices=fedavg_lm.N_CLIENTS, device="cpu"))
    assert f"(from allocated s_n): {al.budgets}" in out
    energy = al.energy_per_round * fedavg_lm.ROUNDS
    assert (f"{fedavg_lm.ROUNDS} rounds: {energy:.4g} J; round makespan "
            f"{al.makespan:.3f} s") in out
