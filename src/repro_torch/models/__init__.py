"""The LM stack of the port (serving): layers, GQA attention, RWKV6, the model."""
