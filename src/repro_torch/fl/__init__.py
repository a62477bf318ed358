"""repro_torch.fl — the federated-learning substrate: FedAvg, the
synthetic resolution-sensitive datasets, and the system simulator.

Port of `repro.fl`. Each function that draws from `jax.random` in the
reference takes its draws as an input here (`FLDraws`, `RunDraws`,
`SimDraws`) or makes them from a `torch.Generator`.
"""
from .client import client_delta, deterministic_algorithms, local_train
from .data import (FLDataset, FLDraws, SampleDraws, dataset_draws,
                   eval_draws, make_eval_set, make_federated_dataset,
                   render)
from .server import (FLRunResult, RunDraws, fedavg, fedavg_stale,
                     resolve_eval_resolution, run_draws, run_federated,
                     stale_weights)
from .simulator import (SimDraws, SimResult, map_resolution_to_dataset,
                        simulate)

__all__ = ["client_delta", "deterministic_algorithms", "local_train",
           "FLDataset", "FLDraws", "SampleDraws", "dataset_draws",
           "eval_draws", "make_eval_set", "make_federated_dataset", "render",
           "FLRunResult", "RunDraws", "fedavg", "fedavg_stale",
           "resolve_eval_resolution", "run_draws", "run_federated",
           "stale_weights", "SimDraws", "SimResult",
           "map_resolution_to_dataset", "simulate"]
