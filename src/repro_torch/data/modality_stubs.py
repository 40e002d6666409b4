"""Stub modality frontends: the transformer backbone is what the audio and
vlm architectures specify, and their frontends are stand-ins.

They give shape- and dtype-faithful precomputed embeddings, drawn from a
numpy generator as the reference draws them (the same values for the same
generator state), then put on ``device`` (``cuda`` unless the caller says)
in ``dtype``:

  audio : EnCodec frame embeddings  [B, S, d_model]
  vlm   : ViT patch embeddings      [B, 1600, d_model]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import common


def _normal(rng: np.random.Generator, shape, dtype, device) -> torch.Tensor:
    x = rng.normal(0.0, 1.0, size=shape).astype(np.float32)
    return torch.from_numpy(x).to(common.device(device)).to(dtype)


def encodec_frames(rng: np.random.Generator, batch: int, seq: int,
                   d_model: int, dtype=torch.bfloat16,
                   device=None) -> torch.Tensor:
    """Stand-in for EnCodec encoder output at 50 Hz frame rate."""
    return _normal(rng, (batch, seq, d_model), dtype, device)


def vit_patches(rng: np.random.Generator, batch: int, n_patches: int,
                d_model: int, dtype=torch.bfloat16,
                device=None) -> torch.Tensor:
    """Stand-in for a ViT-H/14 vision tower output (1600 patches @ 448px)."""
    return _normal(rng, (batch, n_patches, d_model), dtype, device)
