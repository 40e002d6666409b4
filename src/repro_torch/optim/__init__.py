"""Optimizer pieces of the port: int8 merge compression
(:mod:`repro_torch.optim.compress`)."""
