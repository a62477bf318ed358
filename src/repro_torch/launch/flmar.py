"""FL-MAR end-to-end driver: the paper's full loop (Fig. 1).

Port of `repro/launch/flmar.py`, on CUDA unless `--device cpu` is given:

    PYTHONPATH=src python -m repro_torch.launch.flmar --devices 10 \
        --rounds 20 --w1 0.5 --w2 0.5 --rho 30
    PYTHONPATH=src python -m repro_torch.launch.flmar --devices 8 \
        --rounds 25 --rho 40 --per-client 64 --device cpu

Allocates (B, p, f, s) with Algorithm 2, runs FedAvg at the allocated
resolutions, and prints the energy / time / accuracy ledger against the
MinPixel and RandPixel benchmarks. Every draw comes from fixed integer
seeds (torch.Generators, not the reference's `jax.random` keys).
"""
from __future__ import annotations

import argparse

from ..core import Weights, default_accuracy, make_system, summarize
from ..core.baselines import min_pixel, rand_pixel
from ..core.types import resolve_device
from ..fl import make_federated_dataset, run_federated, simulate
from ..fl.simulator import map_resolution_to_dataset

DATASET_RESOLUTIONS = (4, 8, 12, 16)


def main(argv=None):
    """Run the driver once; returns the proposed allocator's `SimResult`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--local-iters", type=int, default=4)
    ap.add_argument("--w1", type=float, default=0.5)
    ap.add_argument("--w2", type=float, default=0.5)
    ap.add_argument("--rho", type=float, default=30.0)
    ap.add_argument("--split", default="iid",
                    choices=["iid", "noniid-1", "noniid-2"])
    ap.add_argument("--per-client", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    sysp = make_system(0, n_devices=args.devices, device=device)
    w = Weights(args.w1, args.w2, args.rho)
    ds = make_federated_dataset(1, n_clients=args.devices,
                                per_client=args.per_client,
                                base_resolution=16, split=args.split,
                                device=device)

    res = simulate(2, sysp, w, dataset=ds,
                   dataset_resolutions=DATASET_RESOLUTIONS,
                   global_rounds=args.rounds, local_iters=args.local_iters)
    print(f"== proposed allocator (w1={args.w1}, w2={args.w2}, "
          f"rho={args.rho})")
    for k, v in res.ledger.items():
        print(f"   {k}: {v:.5g}")

    for name, alloc in [("MinPixel", min_pixel(sysp, 3)),
                        ("RandPixel", rand_pixel(sysp, 4))]:
        ds_res = map_resolution_to_dataset(sysp, alloc.resolution,
                                           DATASET_RESOLUTIONS)
        fl = run_federated(2, ds, ds_res, global_rounds=args.rounds,
                           local_iters=args.local_iters)
        s = summarize(sysp, w.normalized(), default_accuracy(), alloc)
        print(f"== {name}: energy={s['energy_J']:.4g}J "
              f"time={s['time_s']:.4g}s FL-acc={fl.round_accuracy[-1]:.3f}")
    return res


if __name__ == "__main__":
    main()
