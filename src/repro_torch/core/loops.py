"""Per-cell while loops: the port's form of `jax.vmap` over `lax.while_loop`.

Under `vmap`, a `while_loop` runs until every cell's condition is false,
and a cell whose condition is false keeps its carry unchanged while the
others go on. `while_cells` does the same over the leading cell axis of
its carry: each iteration evaluates the per-cell condition on the device
and reads "is any cell still running" back to the host once. Those reads
are counted in `while_cells.host_reads`, so a caller can tell how many
host synchronisations a solve took.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

Tensor = torch.Tensor


def _cells(run: Tensor, x: Tensor) -> Tensor:
    """The (C,) mask shaped to broadcast against a (C, ...) carry entry."""
    return run.reshape(run.shape + (1,) * (x.ndim - 1))


def while_cells(cond: Callable[[Tuple[Tensor, ...]], Tensor],
                body: Callable[[Tuple[Tensor, ...]], Tuple[Tensor, ...]],
                carry: Tuple[Tensor, ...]) -> Tuple[Tensor, ...]:
    """Run `body` while `cond(carry)` ((C,) bool) holds for any cell,
    freezing the carry of every cell whose condition is false."""
    while True:
        run = cond(carry)
        while_cells.host_reads += 1
        if not bool(run.any()):
            return carry
        new = body(carry)
        carry = tuple(torch.where(_cells(run, old), nxt, old)
                      for nxt, old in zip(new, carry))


while_cells.host_reads = 0
