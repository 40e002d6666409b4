"""Optimizers of the port (the reference's names): SGD with and without
momentum, Adam, schedules, global-norm clipping and int8 merge
compression."""
from repro_torch.optim.sgd import sgd, sgd_momentum  # noqa: F401
from repro_torch.optim.adam import adam  # noqa: F401
from repro_torch.optim import schedules, clip, compress  # noqa: F401
