"""The readings a cell's limits are set from, each over a short window that
calls every fleet of the pool once:

  --sound     the program, as the benchmark runs it (the lower readings);
  otherwise   the control: the reference put in the program's place and
              computed one precision below the configuration's (bfloat16
              for float32), held to the same float64 reference (the upper
              readings).

`--pool-seed` draws the pool from another seed than the mix's, so that the
lower readings cover other cell problems than the benchmark's pool.

    python3 cardbench/readings.py --workload fleet-n50.free --seed 7 \
        [--sound] [--pool-seed 12345]

Prints the run's result line (with `checks`) as its last line. Not part of
the benchmark's own runs.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import torch  # noqa: E402

from harness import cell, spec  # noqa: E402

LOWER = {"float32": torch.bfloat16}


def control_call(wl):
    """The unit of work of workload `wl` answered by its kind's reference
    in the precision below the configuration's."""
    low = LOWER[wl.cfg["dtype"]]
    return lambda sys: wl.kind.reference(sys, wl.cfg, wl.mix, low)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--sound", action="store_true")
    p.add_argument("--pool-seed", type=int, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("cardbench readings: no CUDA device", file=sys.stderr)
        return 2
    if args.pool_seed is not None:
        real = spec.traffic
        spec.traffic = lambda name: dict(real(name),
                                         pool_seed=args.pool_seed)
    result = cell.run(args.workload, args.seed, 0.0, False, T_START,
                      call=None if args.sound else control_call,
                      cover_pool=True)
    cell.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
