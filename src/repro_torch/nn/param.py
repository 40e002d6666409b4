"""Parameters: seeded initialisers and the containers that hold them.

Each ``init_*`` in the port returns modules whose leaves are
``nn.Parameter``s in the reference's layout (``[d_in, d_out]`` weights,
applied as ``x @ w``), made with ``requires_grad=False``, as serving
wants them.  ``LM.requires_grad_()`` turns gradients on for a caller that
differentiates the module itself; the trainer differentiates an
``LM.from_tree`` over its parameter tree (:mod:`repro_torch.train.trainer`).
There is no mesh yet, so no sharding specs either.
"""
from __future__ import annotations

import torch
from torch import nn


def normal(gen: torch.Generator, shape, scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in fp32 from ``gen`` on its device, then
    cast to ``dtype`` (the reference's ``pm.normal``)."""
    return (scale * torch.randn(shape, generator=gen, device=gen.device,
                                dtype=torch.float32)).to(dtype)


def make_norm(d: int, dtype: torch.dtype,
              device: torch.device) -> nn.Parameter:
    return frozen(torch.ones(d, dtype=dtype, device=device))


def frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def frozen_dict(**tensors: torch.Tensor) -> nn.ParameterDict:
    return nn.ParameterDict({k: frozen(t) for k, t in tensors.items()})
