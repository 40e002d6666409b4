"""Shape and spec trees for every (arch x shape) dry-run cell.

Nothing here allocates: parameter and cache shapes come from the real init
functions run on ``meta`` tensors (``param.META``, the counterpart of the
reference's ``jax.eval_shape``), and batch inputs are ``meta`` tensors.
A shape tree maps the port's leaf names to ``meta`` tensors (shape and
dtype); its spec tree maps the same names to :class:`param.P`.
"""
from __future__ import annotations

import torch

from repro_torch import configs
from repro_torch.nn import decode as decode_mod
from repro_torch.nn import param as pm
from repro_torch.nn import transformer
from repro_torch.nn.param import P
from repro_torch.nn.transformer import ArchConfig


def param_shapes_and_specs(cfg: ArchConfig):
    shapes = dict(transformer.init_params(cfg, pm.META).named_parameters())
    return shapes, transformer.param_specs(cfg)


def cache_shapes_and_specs(cfg: ArchConfig, batch: int, max_len: int):
    return (decode_mod.init_cache(cfg, batch, max_len, device="meta"),
            decode_mod.cache_specs(cfg))


def batch_specs(cfg: ArchConfig, kind: str, seq: int, gb: int):
    """(shape tree, spec tree) for the step inputs."""
    def meta(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32, dt = torch.int32, cfg.param_dtype
    shapes, specs = {}, {}
    s = 1 if kind == "decode" else seq
    if cfg.emb_in():
        shapes["embeddings"] = meta(gb, s, cfg.d_model, dtype=dt)
        specs["embeddings"] = P("batch", None, None)
    else:
        shapes["tokens"] = meta(gb, s, dtype=i32)
        specs["tokens"] = P("batch", None)
    if cfg.family == "vlm":
        shapes["memory"] = meta(gb, cfg.n_memory, cfg.d_model, dtype=dt)
        specs["memory"] = P("batch", None, None)
    if kind == "train":
        shapes["labels"] = meta(gb, seq, dtype=i32)
        specs["labels"] = P("batch", None)
    return shapes, specs


def input_specs(arch: str, shape: str):
    """Everything dryrun needs for one cell (shape trees + spec trees)."""
    cfg = configs.get(arch)
    kind, seq, gb = configs.SHAPES[shape]
    out = dict(cfg=cfg, kind=kind, seq=seq, gb=gb,
               params=param_shapes_and_specs(cfg),
               batch=batch_specs(cfg, kind, seq, gb))
    if kind == "decode":
        out["cache"] = cache_shapes_and_specs(cfg, gb, seq)
    return out
