"""Single-token decode (serve) paths with per-family caches.

Cache layout, stacked on the layer axes as in the reference:

  dense/moe/audio : k/v caches [L, B, Hkv, S_cache, hd],
                    S_cache = min(max_len, window)
  vlm             : self caches [n_super, ce-1, B, Hkv, max_len, hd]
                    (cross-attention K/V are recomputed from the memory
                    every step, as the reference does)
  hybrid (zamba2) : mamba2 states h [n_sb, per, B, H, ds, hd] fp32 and
                    conv [n_sb, per, B, W-1, d_inner + 2 ds], the tail's
                    h_tail and conv_tail [rest, ...], and one shared-attention
                    K/V history per superblock, attn_k/attn_v [n_sb, B, Hkv,
                    S, hd], ring-cached at 4,096 past a 65,536 ``max_len``
  ssm (xlstm)     : mLSTM states C [n_sb, 7, B, H, hd+1, hd] fp32 and sLSTM
                    states s_c, s_n, s_h, s_m [n_sb, B, H, hd] fp32

``decode_step`` writes every cache leaf in place and returns the same
dict (the reference returns an updated copy).

:func:`cache_specs` gives each leaf's sharding, the reference's: KV caches
on the *sequence* axis (``"kvseq"``: GQA head counts such as 8 do not
divide a model axis of 16, the sequence does), the recurrent states on
their heads, xLSTM's on its head dim (it has 4 heads).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.nn import layers, transformer
from repro_torch.nn import param as pm
from repro_torch.nn.param import NOSHARD, P
from repro_torch.nn.transformer import LM, ArchConfig

#: a hybrid's shared-attention history is ring-cached past this max_len
HYBRID_FULL_CACHE = 65_536
#: ... at this many slots
HYBRID_RING = 4_096


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed caches (sLSTM's stabilizer at -1e30) on ``device`` (``cuda``
    unless the caller says)."""
    fam, dt = cfg.family, cfg.param_dtype
    dev = common.device(device)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(*lead, s):
        return {"k": zeros(*lead, batch, cfg.n_kv, s, cfg.hd),
                "v": zeros(*lead, batch, cfg.n_kv, s, cfg.hd)}

    if fam in ("dense", "moe", "audio"):
        return kv(cfg.n_layers,
                  s=min(max_len, cfg.window) if cfg.window else max_len)
    if fam == "vlm":
        n_super, ce = transformer.vlm_shape(cfg)
        return kv(n_super, ce - 1, s=max_len)
    if fam == "hybrid":
        meta = transformer._mamba_meta(cfg)
        n_sb, per, rest = transformer.hybrid_shape(cfg)
        state = (batch, meta["n_heads"], meta["d_state"], meta["head_dim"])
        conv = (batch, meta["conv_width"] - 1,
                meta["d_inner"] + 2 * meta["d_state"])
        cache = {"h": zeros(n_sb, per, *state, dtype=torch.float32),
                 "conv": zeros(n_sb, per, *conv)}
        if rest:
            cache["h_tail"] = zeros(rest, *state, dtype=torch.float32)
            cache["conv_tail"] = zeros(rest, *conv)
        attn = kv(n_sb, s=max_len if max_len <= HYBRID_FULL_CACHE
                  else HYBRID_RING)
        cache["attn_k"], cache["attn_v"] = attn["k"], attn["v"]
        return cache
    if fam == "ssm":
        m_meta = transformer._mlstm_meta(cfg)
        s_meta = transformer._slstm_meta(cfg)
        n_sb, per = transformer.ssm_shape(cfg)
        hd = m_meta["head_dim"]
        sl = (n_sb, batch, s_meta["n_heads"], s_meta["head_dim"])
        f32 = torch.float32
        return {"C": zeros(n_sb, per - 1, batch, m_meta["n_heads"], hd + 1, hd,
                           dtype=f32),
                "s_c": zeros(*sl, dtype=f32), "s_n": zeros(*sl, dtype=f32),
                "s_h": zeros(*sl, dtype=f32),
                "s_m": torch.full(sl, -1e30, dtype=f32, device=dev)}
    raise ValueError(f"unknown family {fam!r}")


def cache_specs(cfg: ArchConfig) -> dict[str, P]:
    """Each cache leaf's :class:`param.P` (layer axes lead, unsharded)."""
    fam = cfg.family

    def kv(layer_axes):
        return pm.stacked(P("batch", None, "kvseq", None), layer_axes)

    if fam in ("dense", "moe", "audio"):
        return {"k": kv(1), "v": kv(1)}
    if fam == "vlm":
        return {"k": kv(2), "v": kv(2)}
    if fam == "hybrid":
        state, conv = P("batch", "model", None, None), P("batch", None, "model")
        specs = {"h": pm.stacked(state, 2), "conv": pm.stacked(conv, 2)}
        if transformer.hybrid_shape(cfg)[2]:
            specs["h_tail"] = pm.stacked(state)
            specs["conv_tail"] = pm.stacked(conv)
        specs["attn_k"], specs["attn_v"] = kv(1), kv(1)
        return specs
    if fam == "ssm":
        s = pm.stacked(P("batch", None, "model"))
        return {"C": pm.stacked(P("batch", None, None, "model"), 2),
                "s_c": s, "s_n": s, "s_h": s, "s_m": s}
    raise ValueError(f"unknown family {fam!r}")


def decode_step(params: LM, cfg: ArchConfig, cache: dict, inputs: dict,
                idx: int, *, shard=NOSHARD):
    """inputs: {"tokens" [B, 1]} or {"embeddings" [B, 1, d]} (audio), and
    for vlm "memory" [B, M, d]; ``idx`` the host position of the step (its
    rotary position and cache slot, shared by the batch).

    Returns (logits [B, vocab] fp32, cache written in place)."""
    fam = cfg.family
    x = transformer.embed_inputs(params, cfg, inputs)
    positions = torch.full((x.shape[0], 1), idx, dtype=torch.int32,
                           device=x.device)

    def attn(x, block, k, v):
        return transformer.attn_block(x, block, cfg, positions, shard=shard,
                                      cache=(k, v, idx))[0]

    def write(states, new):
        """A recurrent layer's new states over its cache slices."""
        for old, t in zip(states, new):
            pm.assign(old, t)

    if fam in ("dense", "moe", "audio"):
        for i, block in enumerate(params.layers):
            x = attn(x, block, cache["k"][i], cache["v"][i])

    elif fam == "vlm":
        memory = inputs["memory"].to(cfg.param_dtype)
        for sb, (self_p, cross_p) in enumerate(zip(params.self_layers,
                                                   params.cross_layers)):
            for j, lp in enumerate(self_p):
                x = attn(x, lp, cache["k"][sb, j], cache["v"][sb, j])
            x, _ = transformer.attn_block(x, cross_p, cfg, positions,
                                          shard=shard, memory=memory)

    elif fam == "hybrid":
        def mamba(x, lp, h, conv):
            x, new = transformer.mamba_layer(x, lp, cfg, shard=shard,
                                             state=h, conv_state=conv)
            write((h, conv), new)
            return x

        for sb, ps in enumerate(params.mamba_blocks):
            for j, lp in enumerate(ps):
                x = mamba(x, lp, cache["h"][sb, j], cache["conv"][sb, j])
            # the shared (weight-tied) block, with this superblock's history
            x = attn(x, params.shared_attn, cache["attn_k"][sb],
                     cache["attn_v"][sb])
        for t, lp in enumerate(getattr(params, "mamba_tail", ())):
            x = mamba(x, lp, cache["h_tail"][t], cache["conv_tail"][t])

    elif fam == "ssm":
        for sb, (mp, sp) in enumerate(zip(params.mlstm_blocks,
                                          params.slstm_blocks)):
            for j, lp in enumerate(mp):
                C = cache["C"][sb, j]
                x, new = transformer.mlstm_layer(x, lp, cfg, shard=shard,
                                                 state=C)
                write((C,), (new,))
            st = tuple(cache[k][sb] for k in ("s_c", "s_n", "s_h", "s_m"))
            x, new = transformer.slstm_layer(x, sp, cfg, shard=shard,
                                             state=st)
            write(st, new)

    else:
        raise ValueError(f"unknown family {fam!r}")

    h = layers.rms_norm(x, params.final_norm)                 # [B, 1, d]
    logits = (h[:, 0] @ params.unembedding().T).float()       # [B, V]
    return logits, cache
