"""Attention: GQA self-attention (full / sliding-window) and the
single-token decode over a KV cache, both on the ``flash_attn`` kernel.

The reference computes prefill with ``chunked_attention`` (an XLA
online-softmax scan over query chunks) and decode with
``decode_attention`` (one masked matvec over the cache), and names its
Pallas kernel as the runtime path on a TPU.  Both are that kernel's
function at two shapes, so here both call :func:`flash_attention`:
prefill at ``Sq = Sk``, decode at ``Sq = 1`` over the cache's first
``valid`` keys.  In bf16 the port therefore follows the Pallas kernel's
precision (fp32 scores and P.V), not the XLA path's (bf16 scores and P).

Decode writes the new token's K/V into the caller's cache in place (a
ring buffer of ``min(max_len, window)`` slots), where the reference
returns an updated copy: one copy of the cache per step saved.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.nn import layers
from repro_torch.nn import param as pm


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, dtype) -> nn.ParameterDict:
    return pm.frozen_dict(
        wq=pm.normal(gen, (d_model, n_heads * head_dim), d_model ** -0.5, dtype),
        wk=pm.normal(gen, (d_model, n_kv * head_dim), d_model ** -0.5, dtype),
        wv=pm.normal(gen, (d_model, n_kv * head_dim), d_model ** -0.5, dtype),
        wo=pm.normal(gen, (n_heads * head_dim, d_model),
                     (n_heads * head_dim) ** -0.5, dtype))


def chunked_attention(
    q: torch.Tensor,   # [B, Hq, Sq, hd]
    k: torch.Tensor,   # [B, Hkv, Sk, hd]
    v: torch.Tensor,   # [B, Hkv, Sk, hd]
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Attention with the queries end-aligned to the keys.  The
    reference's query chunks and its static window slice are the kernel's
    tiling and tile skipping here, so there is no ``chunk_q``."""
    return flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(
    q: torch.Tensor,        # [B, Hq, 1, hd]
    k_cache: torch.Tensor,  # [B, Hkv, S, hd]
    v_cache: torch.Tensor,  # [B, Hkv, S, hd]
    valid_len: int,         # cache entries 0 .. valid_len - 1 are live
) -> torch.Tensor:
    """Single-token decode: the query sees every live cache entry and
    nothing else (the kernel at ``Sq = 1`` over the cache's prefix, read
    in place).  ``valid_len`` is a host integer, shared by the batch."""
    return flash_attention(q, k_cache[:, :, :valid_len],
                           v_cache[:, :, :valid_len], causal=False)


def self_attention(
    x: torch.Tensor,               # [B, S, d]
    p: nn.ParameterDict,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    positions: torch.Tensor,       # [B, S]
    causal: bool = True,
    window: int | None = None,
    cache: tuple | None = None,    # (k_cache, v_cache, index) for decode
):
    """Returns (out [B, S, d], cache).  With ``cache`` (decode, S = 1) the
    token's K/V are written into ``k_cache``/``v_cache`` in place at slot
    ``index % S_cache`` and the returned cache is ``(k_cache, v_cache,
    index + 1)``; without, it is the post-rotary ``(k, v)`` (prefill
    cache material)."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).view(b, s, n_heads, head_dim)
    k = (x @ p["wk"]).view(b, s, n_kv, head_dim)
    v = (x @ p["wv"]).view(b, s, n_kv, head_dim)
    q = layers.rotary(q, positions).transpose(1, 2)   # [B, H, S, hd]
    k = layers.rotary(k, positions).transpose(1, 2)
    v = v.transpose(1, 2)

    if cache is not None:
        if s != 1:
            raise ValueError(f"decode takes one token per step, got S={s}")
        k_cache, v_cache, idx = cache
        size = k_cache.shape[2]
        slot = idx % size   # ring buffer (identity if the cache is full-length)
        k_cache[:, :, slot] = k[:, :, 0]
        v_cache[:, :, slot] = v[:, :, 0]
        out = decode_attention(q, k_cache, v_cache, min(idx + 1, size))
        new_cache = (k_cache, v_cache, idx + 1)
    else:
        out = chunked_attention(q, k, v, causal=causal, window=window)
        new_cache = (k, v)

    out = out.transpose(1, 2).reshape(b, s, n_heads * head_dim)
    return out @ p["wo"], new_cache
