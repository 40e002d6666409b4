"""Plain PyTorch version of the fused ELL GLM scoring kernel."""
from __future__ import annotations

import torch

from repro_torch.core.glm import LINKS


def glm_score_ref(
    task: str,
    w: torch.Tensor,        # [d]
    values: torch.Tensor,   # [N, K]  zero-padded ELL
    indices: torch.Tensor,  # [N, K]  (0-padded; padded values are 0)
) -> torch.Tensor:
    """Served score of every row: ``link(sum_k values * w[indices])``.

    Padded entries (value 0) add exactly zero, so an all-zero filler row
    scores ``link(0)``: 0.5 for LR, 0.0 for SVM.
    """
    margins = torch.sum(values.float() * w.float()[indices.long()], dim=1)
    return LINKS[task](margins)
