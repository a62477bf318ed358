"""The benchmark of the PyTorch/CUDA allocator (`src/repro_torch`): one run
of one cell.

    python3 cardbench/run.py --workload fleet-n50.free --seed 7 \
        --seconds 51 --trace 0

Prints the checks' lines on standard error and, as the last line of
standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), `device` and, traced, `breakdown`; then `checks`, each compared
number beside its limit. Without a CUDA device it exits non-zero and
prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from harness import cell, spec

    bench = spec.benchmark()
    chips = spec.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cardbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, bench=bench)
    cell.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
