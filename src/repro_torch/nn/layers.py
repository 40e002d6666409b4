"""Basic layers: RMSNorm, rotary embeddings, FFN variants, embedding."""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

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


def ffn_specs(gated: bool = True, fsdp: bool = False) -> dict:
    """The FFN's sharding: hidden dim over ``"model"``."""
    fa = pm.fsdp_axes(fsdp)
    specs = {"w_up": pm.P(fa, "model"), "w_down": pm.P("model", fa)}
    if gated:
        specs["w_gate"] = pm.P(fa, "model")
    return specs


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


#: the embedding's sharding: vocab rows over ``"model"``
EMBED_SPEC = pm.P("model", None)


def init_embed(gen: torch.Generator, vocab: int, d_model: int,
               dtype) -> nn.Parameter:
    return pm.frozen(pm.normal(gen, (vocab, d_model), d_model ** -0.5, dtype))


def embed(tokens: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Rows of ``emb`` (``F.embedding``: DTensor has its rules, forward
    and backward).  With the vocab sharded each rank looks up the rows it
    holds, and the partial rows are summed here (a vocab-parallel
    embedding's all-reduce), before anything else reads them."""
    out = torch.nn.functional.embedding(tokens, emb)
    if isinstance(out, DTensor) and any(p.is_partial() for p in
                                        out.placements):
        out = out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return out


def _xent_sum(hx: torch.Tensor, emb: torch.Tensor,
              lx: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one chunk: [B, c, V] fp32 logits inside."""
    logits = (hx @ emb.T).float()
    vocab = logits.ndim - 1   # a non-negative dim, as DTensor's rules want
    logz = torch.logsumexp(logits, dim=vocab, keepdim=True)
    gold = torch.gather(logits, vocab, lx.long().unsqueeze(vocab))
    return torch.sum(logz - gold)


def chunked_softmax_xent(
    h: torch.Tensor,       # [B, S, d]  final hidden states
    emb: torch.Tensor,     # [V, d]     tied unembedding
    labels: torch.Tensor,  # [B, S]     int
    *,
    chunk: int = 256,
) -> torch.Tensor:
    """Mean next-token cross-entropy, computed in sequence chunks so the
    [B, chunk, V] logits block is the peak — never the full [B, S, V].
    Under grad mode each chunk is checkpointed, so the backward recomputes
    its logits a chunk at a time and one block stays the peak there too."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for hx, lx in zip(h.split(chunk, dim=1), labels.split(chunk, dim=1)):
        total = total + (checkpoint(_xent_sum, hx, emb, lx,
                                    use_reentrant=False)
                         if remat else _xent_sum(hx, emb, lx))
    return total / (b * s)
