"""Model assembly: per-family blocks and forward passes.

Families (the reference's ARCHITECTURES block):
  dense    pre-norm GQA attention + FFN (gated-SiLU or squared-ReLU)
  moe      attention + top-k expert FFN
  audio    dense backbone over precomputed frame embeddings (stub frontend)
  hybrid   Mamba2 backbone + periodically-applied *shared* attention block
  ssm      xLSTM: superblocks of (7 mLSTM + 1 sLSTM)
  vlm      dense decoder + cross-attention to patch embeddings every 5 layers

Layers are ``nn.ModuleList``s of blocks run in Python loops (the
reference's ``scan`` over stacked layers; its two-level scans are nested
lists: ``self_layers[super][j]``, ``mamba_blocks[super][j]``,
``mlstm_blocks[super][j]``); weights keep the reference's ``[d_in,
d_out]`` layout.  ``forward`` and ``loss_fn`` take an :class:`LM`;
``LM.from_tree`` makes one over a parameter tree
(``dict(lm.named_parameters())``, the tree the trainer and optimizers
carry: :mod:`repro_torch.utils.tree`).  Training under grad mode
rematerialises each scanned body in the backward, as the reference's
``ckpt`` does (``torch.utils.checkpoint``, its ``jax.checkpoint`` with
``nothing_saveable``): a block for dense, moe and audio, a superblock for
vlm, hybrid and ssm; hybrid's tail layers are not rematerialised, as in
the reference.  Attention, self and cross, runs on the ``flash_attn``
kernel.

:func:`param_specs` gives each parameter's sharding (:class:`param.P`,
the reference's specs under the port's names, layer axes dropped), and
``forward``, ``loss_fn`` and ``decode.decode_step`` thread the reference's
``shard`` callback: the residual stream is placed on ``P("batch", "seq",
None)`` after the embedding and after every block, as the reference's
``with_sharding_constraint``s place it, and gathered whole on the
sequence around a block's products and before the loss (:data:`ROWS`).
Without a mesh it is :data:`NOSHARD` and nothing moves.  On a mesh
(``trainer.make_shard_fn``) the parameters and activations are DTensors;
the recurrent mixers' scans and chunk loops have no DTensor rule, so each
runs on every rank's local tensors (:mod:`repro_torch.nn.local`), placed
as the reference places them: Mamba2 on the rank's share of the heads
(``ssm.mamba2_on_mesh``), mLSTM on its slice of the key dim
(``xlstm.mlstm_on_mesh``), both with ``w_in``/``w_out`` (``w_up``,
``w_qkv``/``w_down``) column- and row-parallel over ``"model"`` and their
output partial sums reduced into the residual's placement; the sLSTM,
whose loop would need a collective a step that way, on the rank's batch
rows (``xlstm.slstm_on_mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import attention, layers, moe, ssm, xlstm
from repro_torch.nn import param as pm
from repro_torch.nn.param import NOSHARD, P

#: the residual stream's spec [B, S, d]
RESIDUAL = P("batch", "seq", None)
#: a projection's input and output: the sequence whole (with
#: ``seq_shard`` the all-gather and all-reduce XLA's SPMD inserts around a
#: block's products; DTensor cannot flatten a batch- and sequence-sharded
#: operand or gradient into a matmul)
ROWS = P("batch", None, None)

PORTED_FAMILIES = ("dense", "moe", "audio", "hybrid", "ssm", "vlm")

#: the layer stacks an LM may hold, in the order its parameters are listed
STACKS = ("layers", "self_layers", "cross_layers", "mamba_blocks",
          "mamba_tail", "shared_attn", "mlstm_blocks", "slstm_blocks")


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

    def emb_in(self) -> bool:
        """True if the input is precomputed embeddings (stub frontend)."""
        return self.family == "audio"


class AttnBlock(nn.Module):
    """One pre-norm block's parameters: ``attn`` (wq, wk, wv, wo), then
    ``ffn`` (w_up, w_down[, w_gate]) or ``moe`` (router, w_up, w_gate,
    w_down), ``norm1``, ``norm2``."""

    def __init__(self, attn: nn.ParameterDict, norm1: nn.Parameter,
                 norm2: nn.Parameter, *, ffn: nn.ParameterDict | None = None,
                 moe: nn.ParameterDict | None = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("a block has an ffn or a moe, not both")
        self.attn = attn
        if ffn is not None:
            self.ffn = ffn
        else:
            self.moe = moe
        self.norm1, self.norm2 = norm1, norm2


class MixerBlock(nn.Module):
    """One recurrent layer's parameters: its mixer under ``kind``
    (``"mamba"`` for Mamba2, ``"mix"`` for mLSTM and sLSTM) and ``norm``."""

    def __init__(self, kind: str, mixer: nn.ParameterDict,
                 norm: nn.Parameter):
        super().__init__()
        setattr(self, kind, mixer)
        self.norm = norm


class LM(nn.Module):
    """The model's parameters: ``embed`` [V, d] (tied unembedding) or, for
    audio, ``head`` [d, V]; ``final_norm`` [d]; and the family's stacks
    (``STACKS``): ``layers`` (dense, moe, audio), ``self_layers`` and
    ``cross_layers`` (vlm), ``mamba_blocks``, ``mamba_tail`` and one
    weight-tied ``shared_attn`` (hybrid), ``mlstm_blocks`` and
    ``slstm_blocks`` (ssm)."""

    def __init__(self, final_norm: nn.Parameter, *,
                 embed: nn.Parameter | None = None,
                 head: nn.Parameter | None = None, **stacks: nn.Module):
        super().__init__()
        if (embed is None) == (head is None):
            raise ValueError("an LM has an embed or a head, not both")
        unknown = sorted(set(stacks) - set(STACKS))
        if unknown:
            raise ValueError(f"unknown stacks {unknown}")
        if embed is not None:
            self.embed = embed
        else:
            self.head = head
        self.final_norm = final_norm
        for name in STACKS:
            if name in stacks:
                setattr(self, name, stacks[name])

    def unembedding(self) -> torch.Tensor:
        """The [V, d] matrix logits are taken against: the tied embedding,
        or the audio head transposed."""
        return self.head.T if hasattr(self, "head") else self.embed

    @classmethod
    def from_tree(cls, tree: dict) -> "LM":
        """The LM over a parameter tree keyed by ``named_parameters()``'s
        names: each parameter shares its tensor's storage and is a new leaf
        that requires grad.  The structure follows the names: numbered
        children make a ``ModuleList``, a child with ``attn`` an
        :class:`AttnBlock`, else a :class:`MixerBlock`."""
        def group(prefix: str) -> nn.ParameterDict:
            return nn.ParameterDict({k[len(prefix):]: nn.Parameter(v)
                                     for k, v in tree.items()
                                     if k.startswith(prefix)})

        def node(prefix: str) -> nn.Module:
            heads = dict.fromkeys(k[len(prefix):].split(".")[0]
                                  for k in tree if k.startswith(prefix))
            if all(h.isdigit() for h in heads):
                return nn.ModuleList(node(f"{prefix}{i}.")
                                     for i in range(len(heads)))
            if "attn" in heads:
                return AttnBlock(
                    group(f"{prefix}attn."),
                    nn.Parameter(tree[f"{prefix}norm1"]),
                    nn.Parameter(tree[f"{prefix}norm2"]),
                    **{k: group(f"{prefix}{k}.") for k in ("ffn", "moe")
                       if k in heads})
            (kind,) = set(heads) - {"norm"}
            return MixerBlock(kind, group(f"{prefix}{kind}."),
                              nn.Parameter(tree[f"{prefix}norm"]))

        leaves = {k: nn.Parameter(tree[k])
                  for k in ("embed", "head", "final_norm") if k in tree}
        tops = dict.fromkeys(k.split(".")[0] for k in tree)
        return cls(**leaves, **{k: node(f"{k}.") for k in tops
                                if k not in leaves})


# ---------------------------------------------------------------------------
# Attention blocks (dense, moe, audio, vlm, hybrid's shared block)
# ---------------------------------------------------------------------------


def init_attn_block(cfg: ArchConfig, gen: torch.Generator, *,
                    with_moe: bool = False) -> AttnBlock:
    dev = gen.device
    attn = attention.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                    cfg.hd, cfg.param_dtype)
    if with_moe:
        mlp = {"moe": moe.init_moe(gen, cfg.d_model, cfg.d_ff,
                                   cfg.moe_experts, cfg.param_dtype)}
    else:
        mlp = {"ffn": layers.init_ffn(gen, cfg.d_model, cfg.d_ff,
                                      cfg.param_dtype, gated=cfg.ffn_gated)}
    return AttnBlock(attn, pm.make_norm(cfg.d_model, cfg.param_dtype, dev),
                     pm.make_norm(cfg.d_model, cfg.param_dtype, dev), **mlp)


def attn_block(x: torch.Tensor, p: AttnBlock, cfg: ArchConfig,
               positions: torch.Tensor, *, shard=NOSHARD, cache=None,
               memory: torch.Tensor | None = None):
    """Pre-norm block: self-attention, or cross-attention to ``memory``
    (vlm), then the FFN or the MoE.  Returns (x, new_cache)."""
    h = shard(layers.rms_norm(x, p.norm1), ROWS)
    if memory is not None:
        a = attention.cross_attention(h, memory, p.attn, n_heads=cfg.n_heads,
                                      n_kv=cfg.n_kv, head_dim=cfg.hd)
        new_cache = cache
    else:
        a, new_cache = attention.self_attention(
            h, p.attn, n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
            positions=positions, causal=True, window=cfg.window, cache=cache)
    x = shard(x + shard(a, ROWS), RESIDUAL)
    h = shard(layers.rms_norm(x, p.norm2), ROWS)
    if hasattr(p, "moe"):
        b, s, d = h.shape
        out, _ = moe.moe_ffn(h.reshape(b * s, d), p.moe, top_k=cfg.moe_top_k,
                             groups=cfg.moe_groups or 1,
                             model_shards=cfg.moe_model_shards, shard=shard)
        # tokens back on the batch axes alone before they unflatten
        f = shard(out, P("batch", None)).reshape(b, s, d)
    else:
        f = layers.ffn(h, p.ffn, gated=cfg.ffn_gated)
    return shard(x + shard(f, ROWS), RESIDUAL), new_cache


# ---------------------------------------------------------------------------
# Recurrent layers (hybrid, ssm)
# ---------------------------------------------------------------------------


def _mamba_meta(cfg: ArchConfig) -> dict:
    d_inner = 2 * cfg.d_model
    return dict(d_inner=d_inner, n_heads=d_inner // 64, head_dim=64,
                d_state=cfg.ssm_state, conv_width=4)


def _mlstm_meta(cfg: ArchConfig) -> dict:
    d_inner = 2 * cfg.d_model
    return dict(d_inner=d_inner, n_heads=cfg.n_heads,
                head_dim=d_inner // cfg.n_heads)


def _slstm_meta(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, head_dim=cfg.d_model // cfg.n_heads)


def hybrid_shape(cfg: ArchConfig) -> tuple[int, int, int]:
    """zamba2's layout: (superblocks, mamba layers a superblock, tail)."""
    n_sb, per = cfg.n_layers // 6, 6
    return n_sb, per, cfg.n_layers - n_sb * per


def ssm_shape(cfg: ArchConfig) -> tuple[int, int]:
    """xLSTM's layout: (superblocks, layers a superblock: 7 mLSTM and 1
    sLSTM)."""
    return cfg.n_layers // 8, 8


def vlm_shape(cfg: ArchConfig) -> tuple[int, int]:
    """(superblocks, layers a superblock: ce - 1 self + 1 cross)."""
    return cfg.n_layers // cfg.cross_every, cfg.cross_every


def _mixer(kind: str, params: nn.ParameterDict, cfg: ArchConfig,
           dev) -> MixerBlock:
    return MixerBlock(kind, params,
                      pm.make_norm(cfg.d_model, cfg.param_dtype, dev))


def mamba_layer(x: torch.Tensor, lp: MixerBlock, cfg: ArchConfig, *,
                shard=NOSHARD, state=None, conv_state=None):
    """x + Mamba2(norm(x)).  Returns (x, (state, conv_state))."""
    h = layers.rms_norm(x, lp.norm)
    mixer = ssm.mamba2_on_mesh if isinstance(h, DTensor) else ssm.mamba2
    y, st = mixer(h, lp.mamba, _mamba_meta(cfg), chunk=cfg.ssm_chunk,
                  state=state, conv_state=conv_state)
    return shard(x + shard(y, RESIDUAL), RESIDUAL), st


def mlstm_layer(x: torch.Tensor, lp: MixerBlock, cfg: ArchConfig, *,
                shard=NOSHARD, state=None):
    """x + mLSTM(norm(x)).  Returns (x, C)."""
    h = layers.rms_norm(x, lp.norm)
    mixer = xlstm.mlstm_on_mesh if isinstance(h, DTensor) else xlstm.mlstm
    y, C = mixer(h, lp.mix, _mlstm_meta(cfg), chunk=cfg.ssm_chunk,
                 state=state)
    return shard(x + shard(y, RESIDUAL), RESIDUAL), C


def slstm_layer(x: torch.Tensor, lp: MixerBlock, cfg: ArchConfig, *,
                shard=NOSHARD, state=None):
    """x + sLSTM(norm(x)).  Returns (x, (c, n, h, m))."""
    h = layers.rms_norm(x, lp.norm)
    mixer = xlstm.slstm_on_mesh if isinstance(h, DTensor) else xlstm.slstm
    y, st = mixer(h, lp.mix, _slstm_meta(cfg), state=state or None)
    return shard(x + shard(y, RESIDUAL), RESIDUAL), st


# ---------------------------------------------------------------------------
# Parameter init (all families)
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: torch.Generator) -> LM:
    """Random parameters drawn from ``gen``, on ``gen``'s device: the
    reference's tree and dtypes (the MoE router, Mamba2's dt_bias, a_log
    and d_skip, mLSTM's gates and sLSTM's bias fp32 whatever
    ``param_dtype`` is), not its random bits."""
    dev, dt, d = gen.device, cfg.param_dtype, cfg.d_model
    fam = cfg.family
    ml = nn.ModuleList
    if fam in ("dense", "audio", "moe"):
        stacks = {"layers": ml(init_attn_block(cfg, gen, with_moe=fam == "moe")
                               for _ in range(cfg.n_layers))}
    elif fam == "vlm":
        n_super, ce = vlm_shape(cfg)
        stacks = {"self_layers": ml(ml(init_attn_block(cfg, gen)
                                       for _ in range(ce - 1))
                                    for _ in range(n_super)),
                  "cross_layers": ml(init_attn_block(cfg, gen)
                                     for _ in range(n_super))}
    elif fam == "hybrid":  # zamba2: mamba backbone + one shared attn block
        n_sb, per, rest = hybrid_shape(cfg)

        def mamba():
            return _mixer("mamba", ssm.init_mamba2(gen, d, cfg.ssm_state,
                                                   dt)[0], cfg, dev)

        stacks = {"mamba_blocks": ml(ml(mamba() for _ in range(per))
                                     for _ in range(n_sb))}
        if rest:
            stacks["mamba_tail"] = ml(mamba() for _ in range(rest))
        stacks["shared_attn"] = init_attn_block(cfg, gen)
    elif fam == "ssm":  # xLSTM: superblocks of (7 mLSTM + 1 sLSTM)
        n_sb, per = ssm_shape(cfg)
        m_blocks, s_blocks = [], []
        for _ in range(n_sb):
            m_blocks.append(ml(
                _mixer("mix", xlstm.init_mlstm(gen, d, cfg.n_heads, dt)[0],
                       cfg, dev) for _ in range(per - 1)))
            s_blocks.append(_mixer("mix", xlstm.init_slstm(
                gen, d, cfg.n_heads, dt)[0], cfg, dev))
        stacks = {"mlstm_blocks": ml(m_blocks), "slstm_blocks": ml(s_blocks)}
    else:
        raise ValueError(f"unknown family {fam!r}")
    if cfg.emb_in():  # stub frontend: an output head over the codec vocab
        io = {"head": pm.frozen(pm.normal(gen, (d, cfg.vocab), d ** -0.5, dt))}
    else:
        io = {"embed": layers.init_embed(gen, cfg.vocab, d, dt)}
    return LM(pm.make_norm(d, dt, dev), **io, **stacks)


def param_specs(cfg: ArchConfig) -> dict[str, P]:
    """Each parameter's :class:`param.P`, keyed as ``named_parameters()``:
    the reference's spec with its stacked layer axes dropped."""
    groups = {"attn": attention.attention_specs(cfg.fsdp),
              "ffn": layers.ffn_specs(cfg.ffn_gated, cfg.fsdp),
              "moe": moe.moe_specs(cfg.fsdp), "mamba": ssm.MAMBA2_SPECS,
              "mlstm_blocks": xlstm.MLSTM_SPECS,
              "slstm_blocks": xlstm.SLSTM_SPECS}
    top = {"embed": layers.EMBED_SPEC, "head": P(None, "model"),
           "final_norm": pm.NORM_SPEC}
    specs = {}
    for name, _ in init_params(cfg, pm.META).named_parameters():
        parts = name.split(".")
        if name in top:
            specs[name] = top[name]
        elif parts[-1].startswith("norm"):
            specs[name] = pm.NORM_SPEC
        else:
            group = parts[0] if parts[-2] == "mix" else parts[-2]
            specs[name] = groups[group][parts[-1]]
    return specs


# ---------------------------------------------------------------------------
# Forward (training / prefill): returns final hidden states [B, S, d]
# ---------------------------------------------------------------------------


def embed_inputs(params: LM, cfg: ArchConfig, inputs: dict) -> torch.Tensor:
    """The residual stream's input: audio's precomputed embeddings in the
    model's dtype, else the tokens' embeddings."""
    if cfg.emb_in():
        return inputs["embeddings"].to(cfg.param_dtype)
    return layers.embed(inputs["tokens"], params.embed)


def forward(params: LM, cfg: ArchConfig, inputs: dict, *, shard=NOSHARD,
            mode: str = "train"):
    """inputs: {"tokens" [B, S] | "embeddings" [B, S, d], and for vlm
    "memory" [B, M, d]}, on the parameters' device.

    mode="train"   -> returns final hidden states [B, S, d]; under grad
                      mode each scanned body is checkpointed (its
                      activations recomputed in the backward, flash_attn
                      included)
    mode="prefill" -> returns (hidden, cache) where cache matches
                      decode.init_cache's structure, ready for decode_step
                      (K/V post-rotary, the recurrent states after the
                      last token).
    """
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode is 'train' or 'prefill', got {mode!r}")
    prefill = mode == "prefill"
    x = embed_inputs(params, cfg, inputs)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    x = shard(x, RESIDUAL)
    remat = not prefill and torch.is_grad_enabled()

    def scanned(body, x, *args):
        """One scanned body: checkpointed under remat, where its cache
        material is dropped."""
        if remat:
            return checkpoint(lambda *a: body(*a)[0], x, *args,
                              use_reentrant=False), None
        return body(x, *args)

    fam = cfg.family
    outs = []
    if fam in ("dense", "moe", "audio"):
        def body(x, block):
            return attn_block(x, block, cfg, positions, shard=shard)

        for block in params.layers:
            x, kv = scanned(body, x, block)
            outs.append(kv)

        def cache():
            return {key: torch.stack([kv[i] for kv in outs])
                    for i, key in enumerate("kv")}

    elif fam == "vlm":
        memory = inputs["memory"].to(cfg.param_dtype)

        def body(x, self_p, cross_p):
            kvs = []
            for lp in self_p:
                x, kv = attn_block(x, lp, cfg, positions, shard=shard)
                kvs.append(kv)
            x, _ = attn_block(x, cross_p, cfg, positions, shard=shard,
                              memory=memory)
            return x, kvs

        for self_p, cross_p in zip(params.self_layers, params.cross_layers):
            x, kvs = scanned(body, x, self_p, cross_p)
            outs.append(kvs)

        def cache():
            return {key: torch.stack([torch.stack([kv[i] for kv in kvs])
                                      for kvs in outs])
                    for i, key in enumerate("kv")}

    elif fam == "hybrid":
        def body(x, ps):
            sts = []
            for lp in ps:
                x, st = mamba_layer(x, lp, cfg, shard=shard)
                sts.append(st)
            x, kv = attn_block(x, params.shared_attn, cfg, positions,
                               shard=shard)
            return x, (sts, kv)

        for ps in params.mamba_blocks:
            x, out = scanned(body, x, ps)
            outs.append(out)
        tail = []
        for lp in getattr(params, "mamba_tail", ()):
            x, st = mamba_layer(x, lp, cfg, shard=shard)
            tail.append(st)

        def cache():
            dt = cfg.param_dtype
            c = {"h": torch.stack([torch.stack([h for h, _ in sts])
                                   for sts, _ in outs]),
                 "conv": torch.stack([torch.stack([cv for _, cv in sts])
                                      for sts, _ in outs]).to(dt),
                 "attn_k": torch.stack([kv[0] for _, kv in outs]),
                 "attn_v": torch.stack([kv[1] for _, kv in outs])}
            if tail:
                c["h_tail"] = torch.stack([h for h, _ in tail])
                c["conv_tail"] = torch.stack([cv for _, cv in tail]).to(dt)
            return c

    elif fam == "ssm":
        def body(x, mp, sp):
            Cs = []
            for lp in mp:
                x, C = mlstm_layer(x, lp, cfg, shard=shard)
                Cs.append(C)
            x, st = slstm_layer(x, sp, cfg, shard=shard)
            return x, (Cs, st)

        for mp, sp in zip(params.mlstm_blocks, params.slstm_blocks):
            x, out = scanned(body, x, mp, sp)
            outs.append(out)

        def cache():
            c = {"C": torch.stack([torch.stack(Cs) for Cs, _ in outs])}
            for i, key in enumerate(("s_c", "s_n", "s_h", "s_m")):
                c[key] = torch.stack([st[i] for _, st in outs])
            return c

    else:
        raise ValueError(f"unknown family {fam!r}")

    h = layers.rms_norm(x, params.final_norm)
    return (h, cache()) if prefill else h


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def loss_fn(params: LM, cfg: ArchConfig, batch: dict, *,
            shard=NOSHARD) -> torch.Tensor:
    """Mean next-token cross-entropy (tied embeddings, or audio's head;
    chunked logits).  batch: the model's inputs and "labels" [B, S]."""
    h = shard(forward(params, cfg, batch, shard=shard), ROWS)
    return layers.chunked_softmax_xent(h, params.unembedding(),
                                       batch["labels"], chunk=cfg.loss_chunk)
