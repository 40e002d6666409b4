"""Attention: GQA self-attention (full / sliding-window), cross-attention
and the single-token decode over a KV cache, all on the ``flash_attn``
kernel.

The reference computes prefill with ``chunked_attention`` (an XLA
online-softmax scan over query chunks) and decode with
``decode_attention`` (one masked matvec over the cache), and names its
Pallas kernel as the runtime path on a TPU.  Both are that kernel's
function at two shapes, so here both call :func:`flash_attention`:
prefill at ``Sq = Sk``, decode at ``Sq = 1`` over the cache's first
``valid`` keys; so does cross-attention, with no mask, at any ``Sq``
against the memory's keys (a vlm's text queries may outnumber its 1,600
patches).  In bf16 the port therefore follows the Pallas kernel's
precision (fp32 scores and P.V), not the XLA path's (bf16 scores and P).

Decode writes the new token's K/V into the caller's cache in place (a
ring buffer of ``min(max_len, window)`` slots), where the reference
returns an updated copy: one copy of the cache per step saved.

:func:`attention_specs` gives the weights' sharding (heads over
``"model"``, the reference's).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.nn import layers
from repro_torch.nn import param as pm


def attention_specs(fsdp: bool = False) -> dict:
    fa = pm.fsdp_axes(fsdp)
    return {"wq": pm.dense_spec(fsdp_axis=fa), "wk": pm.dense_spec(fsdp_axis=fa),
            "wv": pm.dense_spec(fsdp_axis=fa), "wo": pm.P("model", fa)}


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, dtype) -> nn.ParameterDict:
    return pm.frozen_dict(
        wq=pm.normal(gen, (d_model, n_heads * head_dim), d_model ** -0.5, dtype),
        wk=pm.normal(gen, (d_model, n_kv * head_dim), d_model ** -0.5, dtype),
        wv=pm.normal(gen, (d_model, n_kv * head_dim), d_model ** -0.5, dtype),
        wo=pm.normal(gen, (n_heads * head_dim, d_model),
                     (n_heads * head_dim) ** -0.5, dtype))


def split_heads(t: torch.Tensor, n: int, head_dim: int) -> torch.Tensor:
    """``[B, S, n * head_dim] -> [B, S, n, head_dim]``.  A DTensor sharded
    on its last dim over mesh dims whose sizes do not divide ``n`` (8 kv
    heads over a model axis of 16) is gathered on them first: DTensor
    cannot split a shard's head across ranks."""
    if isinstance(t, DTensor):
        mesh, pl = t.device_mesh, list(t.placements)
        split = [i for i, p in enumerate(pl)
                 if isinstance(p, Shard) and p.dim == t.ndim - 1]
        if n % math.prod(mesh.size(i) for i in split):
            t = t.redistribute(mesh, [Replicate() if i in split else p
                                      for i, p in enumerate(pl)])
    return t.reshape(*t.shape[:-1], n, head_dim)


def heads_whole(w: torch.Tensor, n: int) -> torch.Tensor:
    """The output projection ``[n * head_dim, d]``, gathered on its rows
    where a DTensor's mesh dims sharding them do not divide ``n``: the
    gradient of the heads' flattened output then comes back unsharded on
    them, and unflattens (24 query heads over a model axis of 16)."""
    if isinstance(w, DTensor):
        mesh, pl = w.device_mesh, list(w.placements)
        split = [i for i, p in enumerate(pl)
                 if isinstance(p, Shard) and p.dim == 0]
        if n % math.prod(mesh.size(i) for i in split):
            w = w.redistribute(mesh, [Replicate() if i in split else p
                                      for i, p in enumerate(pl)])
    return w


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
    in place).  ``valid_len`` is a host integer, shared by the batch.  A
    cache sharded on its sequence (``"kvseq"``) is gathered on it alone
    first (the kernel's split-K partials could be combined across ranks
    instead: later work)."""
    return flash_attention(q, whole_seq(k_cache)[:, :, :valid_len],
                           whole_seq(v_cache)[:, :, :valid_len],
                           causal=False)


def whole_seq(t: torch.Tensor) -> torch.Tensor:
    """A ``[B, H, S, hd]`` DTensor gathered on ``S`` only (its other
    shards kept); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == 2 else p
        for p in t.placements])


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
    q = split_heads(x @ p["wq"], n_heads, head_dim)
    k = split_heads(x @ p["wk"], n_kv, head_dim)
    v = split_heads(x @ p["wv"], n_kv, head_dim)
    q = layers.rotary(q, positions).transpose(1, 2)   # [B, H, S, hd]
    k = layers.rotary(k, positions).transpose(1, 2)
    v = v.transpose(1, 2)

    if cache is not None:
        if s != 1:
            raise ValueError(f"decode takes one token per step, got S={s}")
        k_cache, v_cache, idx = cache
        size = k_cache.shape[2]
        slot = idx % size   # ring buffer (identity if the cache is full-length)
        pm.assign_slot(k_cache, 2, slot, k)
        pm.assign_slot(v_cache, 2, slot, v)
        out = decode_attention(q, k_cache, v_cache, min(idx + 1, size))
        new_cache = (k_cache, v_cache, idx + 1)
    else:
        out = chunked_attention(q, k, v, causal=causal, window=window)
        new_cache = (k, v)

    out = out.transpose(1, 2).reshape(b, s, n_heads * head_dim)
    return out @ heads_whole(p["wo"], n_heads), new_cache


def cross_attention(
    x: torch.Tensor,       # [B, S, d]  text stream
    memory: torch.Tensor,  # [B, M, d]  vision/audio embeddings
    p: nn.ParameterDict,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
) -> torch.Tensor:
    """Every query sees every memory key (no rotary, no mask): the kernel
    with ``causal=False``, whatever ``S`` is against ``M``."""
    b, s, _ = x.shape
    m = memory.shape[1]
    q = split_heads(x @ p["wq"], n_heads, head_dim).transpose(1, 2)
    k = split_heads(memory @ p["wk"], n_kv, head_dim).transpose(1, 2)
    v = split_heads(memory @ p["wv"], n_kv, head_dim).transpose(1, 2)
    out = chunked_attention(q, k, v, causal=False)
    out = out.transpose(1, 2).reshape(b, s, n_heads * head_dim)
    return out @ heads_whole(p["wo"], n_heads)
