"""Basic layers: RMSNorm, rotary embeddings, FFN variants, embedding."""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
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
    """Summed cross-entropy of one chunk: [B, c, V] fp32 logits inside.
    On logits whose vocab is split over more than one rank each rank reads
    only its own shard (:class:`_VocabShardXent`); elsewhere (no mesh, or
    a vocab axis of one rank, where the mesh's step stays the mesh-less
    step's arithmetic) a ``gather``."""
    logits = (hx @ emb.T).float()
    vocab = logits.ndim - 1   # a non-negative dim, as DTensor's rules want
    if isinstance(logits, DTensor) and any(
            p.is_shard(vocab) and logits.device_mesh.size(i) > 1
            for i, p in enumerate(logits.placements)):
        return torch.sum(_xent_on_vocab_shards(logits, lx, vocab))
    logz = torch.logsumexp(logits, dim=vocab, keepdim=True)
    gold = torch.gather(logits, vocab, lx.long().unsqueeze(vocab))
    return torch.sum(logz - gold)


def _xent_on_vocab_shards(logits: DTensor, lx: torch.Tensor,
                          vocab: int) -> DTensor:
    """Each row's cross-entropy ``[B, c, 1]`` from logits sharded on the
    vocab, replicated over the vocab's ranks.  DTensor's own rules would
    make blocks of the whole vocab: ``torch.gather``'s backward a zeros
    block of the global ``[B, c, V]`` on every rank (its ``new_zeros``
    replicates), ``logsumexp`` an all-gather of the vocab.  Here the
    labels and the vocab ids of the rank's shard make the gold logit's
    mask, and only ``[B, c, 1]`` rows cross the vocab's ranks."""
    mesh, pl = logits.device_mesh, logits.placements
    local = logits.to_local()
    # the rows' placements: the logits' own on the dims before the vocab
    rows = [p if isinstance(p, Shard) and p.dim < vocab else Replicate()
            for p in pl]
    lab = lx.redistribute(mesh, rows).to_local()
    first = _offset(mesh, pl, vocab, logits.shape[vocab])
    ids = torch.arange(first, first + local.shape[vocab], device=lab.device)
    hit = ids == lab.long().unsqueeze(vocab)
    shards = [i for i, p in enumerate(pl) if p.is_shard(vocab)]

    def over_vocab(t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced by ``op`` over the vocab's ranks."""
        part = [Partial(op) if i in shards else p for i, p in enumerate(rows)]
        return DTensor.from_local(t, mesh, part, run_check=False) \
            .redistribute(mesh, rows).to_local()

    row = _VocabShardXent.apply(local, hit, over_vocab)
    return DTensor.from_local(row, mesh, rows, run_check=False)


def _offset(mesh, placements, dim: int, size: int) -> int:
    """Where this rank's shard of a tensor dim of ``size`` starts: each
    mesh dim that shards it, in order, takes ``torch.chunk``'s share of
    what the ones before it left (DTensor's own helper for this reads
    tensors, which a fake world cannot)."""
    first = 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            chunk = -(-size // mesh.size(i))
            rank = mesh.get_local_rank(i)
            first += rank * chunk
            size = max(0, min(chunk, size - rank * chunk))
    return first


class _VocabShardXent(torch.autograd.Function):
    """A vocab-parallel cross-entropy on one rank's shard ``[B, c, V_r]``
    of the logits: the row max and the sums of ``exp`` and of the gold
    logit (its mask ``hit`` has one entry a row on one rank, so that sum
    is exact) are reduced over the vocab's ranks by ``over_vocab``; the
    gradient ``softmax - hit`` is the shard's own."""

    @staticmethod
    def forward(ctx, local, hit, over_vocab):
        m = over_vocab(local.amax(-1, keepdim=True), "max")
        z = over_vocab(torch.exp(local - m).sum(-1, keepdim=True), "sum")
        gold = over_vocab((local * hit).sum(-1, keepdim=True), "sum")
        ctx.save_for_backward(local, hit, m, z)
        return m + torch.log(z) - gold

    @staticmethod
    def backward(ctx, g):
        local, hit, m, z = ctx.saved_tensors
        return g * (torch.exp(local - m) / z - hit.float()), None, None


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
