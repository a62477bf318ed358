"""The port's models: the FL-MAR client CNN (`cnn`) and the LM stack
(serving): layers, GQA attention, RWKV6, Mamba, MoE, the model."""
