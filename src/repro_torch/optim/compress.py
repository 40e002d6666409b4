"""int8 block quantization for the live learner's compressed merges.

The port's copy of the reference's leaf functions: per-block symmetric
int8 quantization with a per-block fp32 scale (the Buckwild low-precision
idea applied at the merge boundary; the learner carries the quantization
error forward per replica, so the merged model stays unbiased over time).
``torch.round`` rounds half to even, as ``jnp.round`` does, so a value
exactly halfway between two int8 steps lands where the reference puts it.
The tree functions of the reference wait for the LM substrate's optimizer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def _pad_amount(n: int) -> int:
    return (-n) % BLOCK


def quantize_leaf(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization.  Returns (q [Nb, B] int8,
    s [Nb, 1] fp32)."""
    flat = x.reshape(-1).float()
    blocks = F.pad(flat, (0, _pad_amount(flat.numel()))).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor,
                    like: torch.Tensor) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)[:like.numel()]
    return flat.reshape(like.shape).to(like.dtype)


def compression_ratio(leaves) -> float:
    """Bytes(original) / bytes(int8+scales) of a sequence of tensors."""
    orig = sum(x.numel() * x.element_size() for x in leaves)
    comp = sum(x.numel() + 4 * (x.numel() // BLOCK + 1) for x in leaves)
    return orig / comp
