"""Model assembly: the dense family's pre-norm block and forward pass.

  dense    pre-norm GQA attention + FFN (gated-SiLU or squared-ReLU)

The reference also assembles the moe, audio, hybrid, ssm and vlm
families; they are not ported yet (ROADMAP Queue 1 item 7(c)), and
``init_params`` and ``forward`` raise ``NotImplementedError`` for them.
Layers are an ``nn.ModuleList`` of :class:`AttnBlock`s run in a Python
loop (the reference's ``scan``); weights keep the reference's
``[d_in, d_out]`` layout.  ``forward`` and ``loss_fn`` take an
:class:`LM`; ``LM.from_tree`` makes one over a parameter tree
(``dict(lm.named_parameters())``, the tree the trainer and optimizers
carry: :mod:`repro_torch.utils.tree`).  Training under grad mode
rematerialises each block in the backward (``torch.utils.checkpoint``,
the reference's ``jax.checkpoint`` with ``nothing_saveable``).  No mesh:
the reference's ``shard`` callback and sharding specs stay out.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import attention, layers
from repro_torch.nn import param as pm

PORTED_FAMILIES = ("dense",)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | audio | hybrid | ssm | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    # family extras
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_groups: int = 0         # group-local dispatch (0 -> single group)
    moe_model_shards: int = 1   # model-axis size (gathered-experts groups)
    ssm_state: int = 0
    window: int | None = None   # sliding-window attention
    cross_every: int = 0        # vlm: one cross-attn layer per this many
    n_memory: int = 0           # vlm/audio: #frontend embeddings
    ffn_gated: bool = True
    fsdp: bool = False
    seq_shard: bool = False     # sequence-parallel residual stream
    param_dtype: Any = torch.bfloat16
    head_dim: int = 0
    attn_chunk: int = 1024      # kv chunk for chunked attention
    loss_chunk: int = 256       # sequence chunk for the xent loss
    ssm_chunk: int = 256
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue 1 item 7(c)); the port runs {PORTED_FAMILIES}")


class AttnBlock(nn.Module):
    """One pre-norm block's parameters: ``attn`` (wq, wk, wv, wo), ``ffn``
    (w_up, w_down[, w_gate]), ``norm1``, ``norm2``."""

    def __init__(self, attn: nn.ParameterDict, ffn: nn.ParameterDict,
                 norm1: nn.Parameter, norm2: nn.Parameter):
        super().__init__()
        self.attn, self.ffn = attn, ffn
        self.norm1, self.norm2 = norm1, norm2


class LM(nn.Module):
    """The model's parameters: tied ``embed`` [V, d], ``final_norm`` [d],
    and ``layers``."""

    def __init__(self, embed: nn.Parameter, final_norm: nn.Parameter,
                 blocks: list[AttnBlock]):
        super().__init__()
        self.embed, self.final_norm = embed, final_norm
        self.layers = nn.ModuleList(blocks)

    @classmethod
    def from_tree(cls, tree: dict) -> "LM":
        """The LM over a parameter tree keyed by ``named_parameters()``'s
        names: each parameter shares its tensor's storage and is a new leaf
        that requires grad."""
        def group(prefix: str) -> nn.ParameterDict:
            return nn.ParameterDict({k[len(prefix):]: v
                                     for k, v in tree.items()
                                     if k.startswith(prefix)})

        n = 1 + max((int(k.split(".")[1]) for k in tree
                     if k.startswith("layers.")), default=-1)
        return cls(nn.Parameter(tree["embed"]),
                   nn.Parameter(tree["final_norm"]),
                   [AttnBlock(group(f"layers.{i}.attn."),
                              group(f"layers.{i}.ffn."),
                              nn.Parameter(tree[f"layers.{i}.norm1"]),
                              nn.Parameter(tree[f"layers.{i}.norm2"]))
                    for i in range(n)])


# ---------------------------------------------------------------------------
# Dense block
# ---------------------------------------------------------------------------


def init_attn_block(cfg: ArchConfig, gen: torch.Generator) -> AttnBlock:
    dev = gen.device
    return AttnBlock(
        attention.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                 cfg.hd, cfg.param_dtype),
        layers.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype,
                        gated=cfg.ffn_gated),
        pm.make_norm(cfg.d_model, cfg.param_dtype, dev),
        pm.make_norm(cfg.d_model, cfg.param_dtype, dev))


def attn_block(x: torch.Tensor, p: AttnBlock, cfg: ArchConfig,
               positions: torch.Tensor, *, cache=None):
    """Pre-norm block.  Returns (x, new_cache)."""
    h = layers.rms_norm(x, p.norm1)
    a, new_cache = attention.self_attention(
        h, p.attn, n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
        positions=positions, causal=True, window=cfg.window, cache=cache)
    x = x + a
    h = layers.rms_norm(x, p.norm2)
    x = x + layers.ffn(h, p.ffn, gated=cfg.ffn_gated)
    return x, new_cache


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: torch.Generator) -> LM:
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    require_ported(cfg)
    blocks = [init_attn_block(cfg, gen) for _ in range(cfg.n_layers)]
    embed = layers.init_embed(gen, cfg.vocab, cfg.d_model, cfg.param_dtype)
    return LM(embed, pm.make_norm(cfg.d_model, cfg.param_dtype, gen.device),
              blocks)


# ---------------------------------------------------------------------------
# Forward (training / prefill): returns final hidden states [B, S, d]
# ---------------------------------------------------------------------------


def forward(params: LM, cfg: ArchConfig, inputs: dict, *, mode: str = "train"):
    """inputs: {"tokens": [B, S] int tensor on the parameters' device}.

    mode="train"   -> returns final hidden states [B, S, d]; under grad
                      mode each block is checkpointed (its activations
                      recomputed in the backward, flash_attn included)
    mode="prefill" -> returns (hidden, cache) where cache matches
                      decode.init_cache's structure: {"k", "v"}
                      [L, B, Hkv, S, hd] post-rotary.
    """
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode is 'train' or 'prefill', got {mode!r}")
    require_ported(cfg)
    prefill = mode == "prefill"
    x = layers.embed(inputs["tokens"], params.embed)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)

    def body(x, block):
        return attn_block(x, block, cfg, positions)[0]

    remat = not prefill and torch.is_grad_enabled()
    ks, vs = [], []
    for block in params.layers:
        if remat:
            x = checkpoint(body, x, block, use_reentrant=False)
            continue
        x, (k, v) = attn_block(x, block, cfg, positions)
        if prefill:
            ks.append(k)
            vs.append(v)
    h = layers.rms_norm(x, params.final_norm)
    if prefill:
        return h, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return h


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def loss_fn(params: LM, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy (tied embeddings; chunked logits).
    batch: {"tokens", "labels"} [B, S] int tensors."""
    h = forward(params, cfg, batch)
    return layers.chunked_softmax_xent(h, params.embed, batch["labels"],
                                       chunk=cfg.loss_chunk)
