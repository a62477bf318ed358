"""The float64 reference (`reference/alg2.py`) against the port's own
float64 solve at a small size: C = 2 cells of N = 16 devices, each of the
three mixes. The reference is a frozen copy of the allocator's arithmetic
with full-depth searches where the port carries brackets and takes Newton
steps, so in float64 the two agree to the searches' precision."""
import pytest
import torch

from harness import fleet, program
from reference import alg2

C, N = 2, 16
TOL = 1e-6                 # the BCD tolerance both sides run at
GAP = 1e-9                 # float64 agreement: the searches' resolution
# the deadline split is a golden-section argmin of a smooth energy, which
# places its minimum only to about the square root of its inputs' rounding:
# SP2's Newton (port) and bisection (reference) differ by ~1e-15, the split
# by ~1e-8 after it
GAP_SPLIT = 1e-6
W = (0.5, 0.5, 1.0)

CFG = dict(cells=C, devices_per_cell=N, area_m=500.0,
           bandwidth_total_hz=20e6 * N / 50, noise_psd_dbm_per_hz=-174.0,
           p_min_dbm=0.0, p_max_dbm=12.0, f_min_hz=1e3, f_max_hz=2e9,
           kappa=1e-28, cycles_lo=1e4, cycles_hi=3e4, samples_per_device=500,
           upload_bits=28.1e3, local_iters=10, global_rounds=100,
           resolutions=[160.0, 320.0, 480.0, 640.0], s_standard=160.0,
           shadowing_db=8.0)


@pytest.fixture(params=[3, 11])
def system(request):
    g = fleet.generator(request.param, "cpu")
    return fleet.draw(CFG, 1, g, "cpu", torch.float64)[0]


def deadline_problem(system, w, deadline_total):
    """The port's deadline problem: deadline_total (C,) each cell's budget
    over all global rounds."""
    rt = program.port()
    return rt.Problem(system=program.system_params(system),
                      weights=rt.Weights(*w), deadline=deadline_total)


def rounds_answer(system, w, draws, rounds_config):
    """The port's rounds solve: the final allocation and per round (C, R)
    its ledger columns and (C, R, N) resolutions."""
    rt = program.port()
    from repro_torch.dynamics import RoundDraws
    res = rt.solve(rt.Problem(system=program.system_params(system),
                              weights=rt.Weights(*w),
                              rounds=rt.RoundsConfig(**rounds_config),
                              key=RoundDraws(**draws)))
    a = res.allocation
    out = dict(B=a.bandwidth, p=a.power, f=a.freq, T=a.T.reshape(-1),
               rounds_s=res.resolutions)
    for col in ("objective", "energy", "time", "accuracy", "arrived_frac",
                "n_late", "n_dropped", "bcd_iters"):
        out[col] = res.col(col)
    return out


def close(a, b, gap=GAP):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float(((a - b).abs() / b.abs().clamp_min(1e-300)).max()) <= gap


def test_free_matches_port(system):
    rt = program.port()
    res = rt.solve(program.free_problem(system, W),
                   rt.SolverSpec(max_iters=8, tol=TOL))
    ref = alg2.free(system, W, 8, TOL)
    a = res.allocation
    assert torch.equal(res.iters.long(), ref["iters"])
    assert torch.equal(a.resolution, ref["s"])
    for got, want in ((a.bandwidth, ref["B"]), (a.power, ref["p"]),
                      (a.freq, ref["f"]), (a.T, ref["T"][:, 0]),
                      (res.objective, ref["objective"][:, 0])):
        assert close(got, want)


def test_deadline_matches_port(system):
    rt = program.port()
    free = alg2.free(system, W, 8, TOL)
    _, T, _ = alg2.totals(system, free["B"], free["p"], free["f"],
                          free["s"])
    deadline = 1.2 * T[:, 0]
    w = (0.99, 0.01, 1.0)
    res = rt.solve(deadline_problem(system, w, deadline),
                   rt.SolverSpec(max_iters=8, tol=TOL))
    ref = alg2.deadline(system, w, deadline[:, None], 8, TOL)
    a = res.allocation
    assert torch.equal(res.iters.long(), ref["iters"])
    assert torch.equal(a.resolution, ref["s"])
    for got, want in ((a.bandwidth, ref["B"]), (a.power, ref["p"]),
                      (a.freq, ref["f"]),
                      (res.objective, ref["objective"][:, 0])):
        assert close(got, want, GAP_SPLIT)


def test_rounds_match_port(system):
    R = 3
    rc = dict(rounds=R, channel_mode="markov", drift_rho=0.9,
              participation="stale", dropout_prob=0.05, bcd_iters=8,
              bcd_tol=TOL)
    g = torch.Generator().manual_seed(5)
    draws = dict(shadow0=torch.randn((C, N), generator=g,
                                     dtype=torch.float64),
                 z=torch.randn((C, R, N), generator=g, dtype=torch.float64),
                 drop=torch.rand((C, R, N), generator=g) < 0.05)
    ans = rounds_answer(system, W, draws, rc)
    ref = alg2.rounds(system, W, draws["shadow0"], draws["z"], draws["drop"],
                      R, 8, TOL, 0.9, 8.0, 4, 0.5, 1.0)
    assert torch.equal(ans["bcd_iters"].long(), ref["iters"])
    assert torch.equal(ans["rounds_s"], ref["s"])
    assert torch.equal(ans["n_late"].long(), ref["late"])
    assert torch.equal(ans["n_dropped"].long(), ref["dropped"])
    for got, want in ((ans["objective"], ref["objective"]),
                      (ans["energy"], ref["energy"]),
                      (ans["time"], ref["time"]),
                      (ans["accuracy"], ref["arrived_u"]),
                      (ans["arrived_frac"], ref["arrived_w"]),
                      (ans["B"], ref["B"]), (ans["p"], ref["p"]),
                      (ans["f"], ref["f"]), (ans["T"], ref["T"][:, 0])):
        assert close(got, want)
