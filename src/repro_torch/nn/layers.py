"""Basic layers: RMSNorm, rotary embeddings, FFN variants, embedding."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn import param as pm


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """fp32 inside, cast back to ``x``'s dtype, then scaled by ``w``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rotary(x: torch.Tensor, positions: torch.Tensor,
           theta: float = 10_000.0) -> torch.Tensor:
    """Apply RoPE.  x: [B, S, H, hd]; positions: [B, S] int32."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# FFN (gated SiLU / squared-ReLU)
# ---------------------------------------------------------------------------


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, dtype, *,
             gated: bool = True) -> nn.ParameterDict:
    w = {"w_up": pm.normal(gen, (d_model, d_ff), d_model ** -0.5, dtype),
         "w_down": pm.normal(gen, (d_ff, d_model), d_ff ** -0.5, dtype)}
    if gated:
        w["w_gate"] = pm.normal(gen, (d_model, d_ff), d_model ** -0.5, dtype)
    return pm.frozen_dict(**w)


def ffn(x: torch.Tensor, p: nn.ParameterDict, *, gated: bool = True
        ) -> torch.Tensor:
    h = x @ p["w_up"]
    if gated:
        h = torch.nn.functional.silu(x @ p["w_gate"]) * h
    else:
        h = torch.square(torch.relu(h))  # squared-ReLU (nemotron family)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embed(gen: torch.Generator, vocab: int, d_model: int,
               dtype) -> nn.Parameter:
    return pm.frozen(pm.normal(gen, (vocab, d_model), d_model ** -0.5, dtype))


def embed(tokens: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    return emb[tokens]
