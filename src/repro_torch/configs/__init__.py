"""Architecture registry + input-shape suite + reduced smoke configs.

The reference's ten architecture files, as data.  Only the dense family
runs in this port so far (``nn.transformer.init_params`` and
``nn.decode.init_cache`` raise ``NotImplementedError`` for the others).
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.nn.transformer import ArchConfig

_MODULES = {
    "minitron-4b": "minitron_4b",
    "command-r-35b": "command_r_35b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "minitron-8b": "minitron_8b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "musicgen-large": "musicgen_large",
    "zamba2-1.2b": "zamba2_1_2b",
    "xlstm-1.3b": "xlstm_1_3b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
}

ARCH_NAMES = tuple(_MODULES)

# shape id -> (kind, seq_len, global_batch)
SHAPES = {
    "train_4k": ("train", 4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k": ("decode", 32_768, 128),
    "long_500k": ("decode", 524_288, 1),
}

# archs with a sub-quadratic sequence path (run long_500k); all others skip
SUBQUADRATIC = ("h2o-danube-1.8b", "zamba2-1.2b", "xlstm-1.3b")


def get(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def cells(include_skipped: bool = False):
    """All (arch, shape) cells.  long_500k only for sub-quadratic archs
    unless include_skipped."""
    out = []
    for a in ARCH_NAMES:
        for s in SHAPES:
            if s == "long_500k" and a not in SUBQUADRATIC and not include_skipped:
                continue
            out.append((a, s))
    return out


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests (shape contract only)."""
    fam = cfg.family
    n_layers = {"dense": 2, "moe": 2, "audio": 2, "vlm": 5,
                "hybrid": 8, "ssm": 8}[fam]
    kw = dict(
        name=cfg.name + "-smoke", family=fam, n_layers=n_layers,
        d_model=64, n_heads=4, n_kv=2 if cfg.n_kv < cfg.n_heads else 4,
        d_ff=0 if cfg.d_ff == 0 else 128, vocab=256,
        moe_experts=8 if cfg.moe_experts else 0,
        moe_top_k=2 if cfg.moe_top_k else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        window=16 if cfg.window else None,
        cross_every=cfg.cross_every, n_memory=16 if cfg.n_memory else 0,
        ffn_gated=cfg.ffn_gated, fsdp=False, seq_shard=False,
        param_dtype=torch.float32, head_dim=16,
        attn_chunk=16, loss_chunk=16, ssm_chunk=8,
    )
    kw.update(overrides)
    return ArchConfig(**kw)


def parse_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
