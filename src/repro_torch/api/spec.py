"""`SolverSpec` — the single, hashable description of *how* to solve.

Port of `repro/api/spec.py`: the same fields, validation and tolerance
floor rules, so that one spec means the same solve in both packages. Every
static solver option (`max_iters`/`tol`/`sp1_method`/`sp2_method`/
`sp2_iters`/`keep_history`/`lockstep`/dtype policy) lives here, once.

Tolerance validation happens at construction: the BCD convergence check
floors the relative-step tolerance at 64 ulps of the carry dtype (see
`core.bcd._bcd_while`), so a tol below that floor cannot buy a tighter
solution — in f32 anything below ~7.6e-6 just runs at the floor. An
explicit `dtype` makes that a hard error; with the default follow-the-system
policy a sub-f32-floor tol warns once (the system might still be f64).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

_SP1_METHODS = ("sweep", "bisect")
_SP2_METHODS = ("direct", "jong")
_DTYPES = ("float32", "float64")

#: the BCD rel-step tolerance floor, in ulps of the solve dtype
REL_STEP_FLOOR_ULPS = 64

#: the library-default tol. Effectively "64-ulp floor or 1e-6, whichever is
#: looser": the BCD loop clamps at the floor, and `warn_tol_floor` stays
#: silent for this exact value so a default-configured f32 solve does not
#: warn about a tolerance nobody chose. Any OTHER sub-floor tol warns.
DEFAULT_TOL = 1e-6


class TolFloorWarning(UserWarning):
    """The requested tol sits below the solve dtype's rel-step floor: the
    solve runs, but convergence is effectively decided at the floor.
    Filterable: ``warnings.simplefilter("ignore", TolFloorWarning)``."""

# one warning per distinct (tol, dtype) per process: repeating the warning
# thousands of times in a request loop would bury it
_TOL_WARNED: set = set()


def _np_dtype(dtype):
    """numpy's name for a torch dtype; other dtypes pass through."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return dtype


def rel_step_floor(dtype) -> float:
    """The smallest meaningful BCD tolerance for `dtype`: 64 ulps. Movement
    below this is solver bracketing noise, not progress. f32: ~7.6e-6,
    f64: ~1.4e-14. `dtype` may be a torch or a numpy dtype."""
    return float(REL_STEP_FLOOR_ULPS * np.finfo(_np_dtype(dtype)).eps)


def _validate_tol(tol: float, dtype: Optional[str]) -> None:
    if tol <= 0.0:
        raise ValueError(f"SolverSpec: tol must be positive, got {tol}")
    if dtype is not None:
        floor = rel_step_floor(dtype)
        if tol < floor:
            raise ValueError(
                f"SolverSpec: tol={tol:g} is below the {dtype} rel-step "
                f"floor of {REL_STEP_FLOOR_ULPS} ulps = {floor:.3g}; the BCD "
                f"convergence check cannot resolve steps below it, so this "
                f"tol can never report a tighter solution. Raise tol to "
                f">= {floor:.3g} or set dtype='float64'.")
        return
    # dtype follows the system (resolved at solve() time — see
    # `warn_tol_floor`); a tol below even the f64 floor can never converge
    # under ANY dtype, so that much is a construction-time error
    f64_floor = rel_step_floor(np.float64)
    if tol < f64_floor:
        raise ValueError(
            f"SolverSpec: tol={tol:g} is below the float64 rel-step floor "
            f"of {REL_STEP_FLOOR_ULPS} ulps = {f64_floor:.3g} — no dtype "
            f"can report convergence at this tolerance.")


def warn_tol_floor(tol: float, dtype) -> None:
    """Solve-time companion of the construction check: once the solve dtype
    is known, warn (once per (tol, dtype) per process) when `tol` sits below
    its rel-step floor — the solve will run, but convergence is effectively
    decided at the floor, not at `tol` (in f32, any tol below ~7.6e-6
    behaves like 7.6e-6). The library default
    `DEFAULT_TOL` is exempt: it is documented as floor-or-1e-6, and warning
    on a tolerance the user never chose would train everyone to filter
    `TolFloorWarning` away."""
    if tol == DEFAULT_TOL:
        return
    dtype = np.dtype(_np_dtype(dtype))
    key = (float(tol), dtype.name)
    if key in _TOL_WARNED:
        return
    floor = rel_step_floor(dtype)
    if tol >= floor:
        return
    _TOL_WARNED.add(key)
    warnings.warn(
        f"SolverSpec: tol={tol:g} is below the {dtype.name} rel-step floor "
        f"of {REL_STEP_FLOOR_ULPS} ulps = {floor:.3g}; the BCD convergence "
        f"check is floored there, so the effective tolerance is "
        f"{floor:.3g}. Raise tol (or set SolverSpec.dtype='float64') to "
        f"silence this.", TolFloorWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Static solver configuration.

    Fields
    ------
    max_iters : outer BCD iteration cap (0 = return the init untouched,
        objective NaN).
    tol : relative-step convergence tolerance, floored at
        `rel_step_floor(dtype)` inside the loop (validated here). The
        default (`DEFAULT_TOL`) means "the floor or 1e-6, whichever is
        looser"; any explicitly chosen sub-floor tol warns
        `TolFloorWarning` once at solve time.
    sp1_method : "sweep" (batched T-grid dual sweep, default) or "bisect"
        (nested bisection, the sweep's parity oracle). The fixed-deadline
        variant has no T search, so this field is inert there.
    sp2_method : "direct" (exact boundary-power convex solve, default) or
        "jong" (the paper's Algorithm 1).
    sp2_iters : inner iteration cap for sp2_method="jong".
    keep_history : materialize the per-iteration ledger host-side
        (single-cell results only; False skips the device->host copy — the
        serving hot path).
    lockstep : region meshes only — True keeps the pure-jit GSPMD path
        whose BCD while_loop all-reduces across shards; False (default)
        runs shard_map with shard-local convergence exit.
    dtype : None (follow the system's leaf dtype, default), "float32", or
        "float64" — an explicit policy casts system/init leaves before the
        solve and makes the tol floor check a hard error.

    The spec accepts every value `repro`'s does, and `repro_torch.solve`
    runs every engine; `lockstep=True` is rejected until the mesh topology
    is ported (ROADMAP.md Queue 1).
    """
    max_iters: int = 20
    tol: float = DEFAULT_TOL
    sp1_method: str = "sweep"
    sp2_method: str = "direct"
    sp2_iters: int = 30
    keep_history: bool = True
    lockstep: bool = False
    dtype: Optional[str] = None

    def __post_init__(self):
        if self.sp1_method not in _SP1_METHODS:
            raise ValueError(
                f"SolverSpec: sp1_method must be one of {_SP1_METHODS}, "
                f"got {self.sp1_method!r}")
        if self.sp2_method not in _SP2_METHODS:
            raise ValueError(
                f"SolverSpec: sp2_method must be one of {_SP2_METHODS}, "
                f"got {self.sp2_method!r}")
        if self.dtype is not None and self.dtype not in _DTYPES:
            raise ValueError(
                f"SolverSpec: dtype must be None or one of {_DTYPES}, "
                f"got {self.dtype!r}")
        if self.max_iters < 0:
            raise ValueError("SolverSpec: max_iters must be >= 0")
        if self.sp2_iters < 1:
            raise ValueError("SolverSpec: sp2_iters must be >= 1")
        _validate_tol(float(self.tol), self.dtype)

    def replace(self, **kw) -> "SolverSpec":
        return dataclasses.replace(self, **kw)
