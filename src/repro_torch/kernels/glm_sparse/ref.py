"""Plain PyTorch version of the ELL sparse GLM gradient."""
from __future__ import annotations

import torch

from repro_torch.core import glm


def ell_glm_grad_ref(
    task: str,
    W: torch.Tensor,        # [R, d]
    values: torch.Tensor,   # [R, N, K]  zero-padded
    indices: torch.Tensor,  # [R, N, K]  (0-padded; padded values are 0)
    y: torch.Tensor,        # [R, N]
) -> torch.Tensor:
    """Sum GLM gradient of every replica on its ELL rows: gather + scatter-add."""
    W, values, y = W.float(), values.float(), y.float()
    n_rep = W.shape[0]
    flat = indices.long().reshape(n_rep, -1)
    wg = torch.gather(W, 1, flat).reshape(values.shape)
    margins = y * torch.sum(values * wg, dim=2)
    contrib = values * glm.PULLS[task](margins, y)[:, :, None]
    return torch.zeros_like(W).scatter_add_(1, flat, contrib.reshape(n_rep, -1))
