"""Global-norm gradient clipping."""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """The fp32 L2 norm of every leaf together."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to a global norm of at most max_norm, norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm
