"""Plain PyTorch version of the fused dense mini-batch SGD epoch."""
from __future__ import annotations

import torch

from repro_torch.core import glm
from repro_torch.kernels import common


def glm_sgd_epoch_ref(
    task: str, W: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
    step: float, batch: int,
) -> torch.Tensor:
    """Sequential mini-batch SGD pass on every replica at once.

    ``W [R, d]``, ``X [R, n, d]``, ``y [R, n]``; each replica does
    ``w -= (step/|B|) * sum-grad`` per batch, in order.  batch=1 is exact
    incremental SGD (Algorithm 3).  A non-divisible remainder is one final
    smaller batch at ``step/|tail|``.
    """
    common.plain_fp32(X)
    W, X, y = W.float(), X.float(), y.float()
    pull = glm.PULLS[task]

    def update(W, Xk, yk):
        margins = yk * torch.bmm(Xk, W[:, :, None])[..., 0]            # [R, B]
        g = torch.bmm(Xk.transpose(1, 2), pull(margins, yk)[:, :, None])[..., 0]
        return W - (step / Xk.shape[1]) * g

    n = X.shape[1]
    for s in range(0, n, batch):
        W = update(W, X[:, s:s + batch], y[:, s:s + batch])
    return W
