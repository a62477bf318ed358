"""Entry points of the port: `python -m repro_torch.launch.serve` (LM
serving) and `python -m repro_torch.launch.flmar` (the FL-MAR loop)."""
