"""Plain PyTorch version of the fused GLM gradient."""
from __future__ import annotations

import torch

from repro_torch.core import glm
from repro_torch.kernels import common


def glm_grad_ref(task: str, w: torch.Tensor, X: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """Sum gradient of the GLM loss over the batch: X^T pull(y * Xw)."""
    common.plain_fp32(X)
    w, X, y = w.float(), X.float(), y.float()
    return X.T @ glm.PULLS[task](y * (X @ w), y)
