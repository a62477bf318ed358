"""The port's hand-written GPU kernels and their plain PyTorch versions."""
