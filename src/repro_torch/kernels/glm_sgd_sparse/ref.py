"""Plain PyTorch version of the fused sparse (ELL) mini-batch SGD epoch."""
from __future__ import annotations

import torch

from repro_torch.core import glm


def ell_sgd_epoch_ref(
    task: str,
    W: torch.Tensor,        # [R, d]
    values: torch.Tensor,   # [R, n, K]  zero-padded ELL
    indices: torch.Tensor,  # [R, n, K]  (0-padded; padded values are 0)
    y: torch.Tensor,        # [R, n]
    step: float,
    batch: int,
) -> torch.Tensor:
    """Sequential mini-batch SGD pass on ELL data, every replica at once.

    Gather + scatter-add per batch; batch=1 is exact incremental SGD; a
    non-divisible remainder is one final smaller batch at ``step/|tail|``.
    """
    W, values, y = W.float(), values.float(), y.float()
    idx = indices.long()
    n_rep = W.shape[0]
    pull = glm.PULLS[task]

    def update(W, vk, ik, yk):
        flat = ik.reshape(n_rep, -1)
        wg = torch.gather(W, 1, flat).reshape(ik.shape)           # [R, B, K]
        margins = yk * torch.sum(vk * wg, dim=2)                  # [R, B]
        contrib = vk * pull(margins, yk)[:, :, None]              # [R, B, K]
        g = torch.zeros_like(W).scatter_add_(1, flat, contrib.reshape(n_rep, -1))
        return W - (step / vk.shape[1]) * g

    n = values.shape[1]
    for s in range(0, n, batch):
        W = update(W, values[:, s:s + batch], idx[:, s:s + batch],
                   y[:, s:s + batch])
    return W


def live_lengths_ref(values: torch.Tensor) -> torch.Tensor:
    """The position after each row's last nonzero value, int32 over the
    leading axes of ``values`` ([..., K]); 0 for a row of padding.  The
    live-prefix kernels' length pass: a row's entries past it are padding,
    and a value-0 entry before it is skipped where it is read."""
    k = values.shape[-1]
    if k == 0:
        return torch.zeros(values.shape[:-1], dtype=torch.int32,
                           device=values.device)
    pos = torch.arange(1, k + 1, dtype=torch.int32, device=values.device)
    zero = torch.zeros((), dtype=torch.int32, device=values.device)
    return torch.where(values != 0, pos, zero).amax(-1)
