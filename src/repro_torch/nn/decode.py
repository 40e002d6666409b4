"""Single-token decode (serve) path for the dense family.

Cache layout, stacked on the layer axis as in the reference:

  dense : k/v caches [L, B, Hkv, S_cache, hd], S_cache = min(max_len, window)

``decode_step`` writes each layer's new K/V into the cache in place and
returns the same dict (the reference returns an updated copy).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.nn import layers, transformer
from repro_torch.nn.transformer import LM, ArchConfig


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed K/V caches on ``device`` (``cuda`` unless the caller says)."""
    transformer.require_ported(cfg)
    s_cache = min(max_len, cfg.window) if cfg.window else max_len
    shape = (cfg.n_layers, batch, cfg.n_kv, s_cache, cfg.hd)
    dev = common.device(device)
    return {"k": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.param_dtype, device=dev)}


def decode_step(params: LM, cfg: ArchConfig, cache: dict, inputs: dict,
                idx: int):
    """inputs: {"tokens" [B, 1]}; ``idx`` the host position of the step
    (its rotary position and cache slot, shared by the batch).

    Returns (logits [B, vocab] fp32, cache written in place)."""
    transformer.require_ported(cfg)
    x = layers.embed(inputs["tokens"], params.embed)
    positions = torch.full((x.shape[0], 1), idx, dtype=torch.int32,
                           device=x.device)
    for layer, block in enumerate(params.layers):
        x, _ = transformer.attn_block(
            x, block, cfg, positions,
            cache=(cache["k"][layer], cache["v"][layer], idx))
    h = layers.rms_norm(x, params.final_norm)                 # [B, 1, d]
    logits = (h[:, 0] @ params.embed.T).float()               # [B, V]
    return logits, cache
