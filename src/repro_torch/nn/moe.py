"""Mixture-of-Experts FFN: top-k routing, sort-based capacity dispatch.

Dispatch avoids the O(T*E*C) one-hot tensor: tokens are sorted by expert
id (a stable sort, as the reference's ``jnp.argsort``) and scattered into
a fixed ``[E*C + 1, d]`` buffer (C = capacity per expert, the last row
the bucket that over-capacity tokens land in), the expert products run
as batched matmuls ``[g, E, C, d] x [E, d, ff]``, and results are
combined back with the routing weights.

Tokens are split into ``groups`` that each route and drop against their
own capacity, as the reference's group-local dispatch does; its choice
between gathered and all-to-all expert parallelism only sets how many
groups there are.  There is no mesh here, so the configs' one group and
one model shard give one group.  The router runs in fp32 whatever the
experts' dtype.  The auxiliary load-balancing loss is returned beside
the output.

The grouped products are plain batched matmuls: the reference computes
them with ``einsum`` outside any Pallas kernel, so ``torch.matmul`` is
their port.  A decode step pushes its few tokens through the full
``[E, C, d]`` buffer, so it reads every expert's weights (the
reference's capacity semantics).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn import param as pm


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype) -> nn.ParameterDict:
    return pm.frozen_dict(
        router=pm.normal(gen, (d_model, n_experts), d_model ** -0.5,
                         torch.float32),
        w_up=pm.normal(gen, (n_experts, d_model, d_ff), d_model ** -0.5,
                       dtype),
        w_gate=pm.normal(gen, (n_experts, d_model, d_ff), d_model ** -0.5,
                         dtype),
        w_down=pm.normal(gen, (n_experts, d_ff, d_model), d_ff ** -0.5, dtype))


def _capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(cf * tokens * top_k / n_experts)
    return max(8, -(-c // 8) * 8)


def _route_group(x: torch.Tensor, router: torch.Tensor, *, top_k: int,
                 capacity: int, n_experts: int):
    """Group-local routing decisions (index math, no data movement).

    Returns (sel = (perm_token, dest, weight, keep), aux)."""
    t = x.shape[0]
    probs = torch.softmax(x.float() @ router, dim=-1)        # [Tg, E]
    weights, ids = torch.topk(probs, top_k, dim=-1)          # [Tg, k]
    weights = weights / weights.sum(dim=-1, keepdim=True)

    # aux load-balance loss: E * sum_e (frac_tokens_e * mean_prob_e)
    me = probs.mean(dim=0)
    ce = F.one_hot(ids[:, 0], n_experts).float().mean(dim=0)
    aux = n_experts * torch.sum(me * ce)

    flat_ids = ids.reshape(-1)                               # [Tg*k]
    flat_w = weights.reshape(-1)
    token_of = torch.arange(t, device=x.device).repeat_interleave(top_k)

    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    counts = torch.bincount(sorted_ids, minlength=n_experts)
    start = torch.cumsum(counts, 0) - counts                 # [E]
    pos_in_expert = (torch.arange(t * top_k, device=x.device)
                     - start[sorted_ids])
    keep = pos_in_expert < capacity
    dest = torch.where(keep, sorted_ids * capacity + pos_in_expert,
                       n_experts * capacity)                 # drop bucket
    return (token_of[order], dest, flat_w[order], keep), aux


def _dispatch_group(x: torch.Tensor, token_ord: torch.Tensor,
                    dest: torch.Tensor, *, rows: int) -> torch.Tensor:
    """Gather tokens in expert order and scatter them into the dispatch
    buffer.  Kept tokens' rows are unique (position in expert); every
    dropped token lands in the last row, which nothing reads."""
    buf = torch.zeros(rows, x.shape[1], dtype=x.dtype, device=x.device)
    return buf.index_copy(0, dest, x[token_ord])


def _combine_group(down_flat: torch.Tensor, sel, t: int) -> torch.Tensor:
    """down_flat [E*C+1, d] (with the drop row); scatter back to tokens."""
    token_ord, dest, w_ord, keep = sel
    out_sorted = down_flat[dest] * (w_ord * keep)[:, None].to(down_flat.dtype)
    out = torch.zeros(t, down_flat.shape[1], dtype=down_flat.dtype,
                      device=down_flat.device)
    return out.index_add(0, token_ord, out_sorted)


def moe_ffn(x: torch.Tensor, p: nn.ParameterDict, *, top_k: int,
            capacity_factor: float = 1.25, groups: int = 1,
            model_shards: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T, d] flattened tokens.  Returns (out [T, d], aux_loss scalar)."""
    t, d = x.shape
    n_experts = p["router"].shape[1]
    d_ff = p["w_up"].shape[-1]
    e_bytes = 3 * n_experts * d * d_ff * p["w_up"].element_size()
    t_bytes = t * top_k * d * x.element_size() * capacity_factor
    gathered = e_bytes <= (1 << 30) and t_bytes > 4 * e_bytes

    g = max(1, groups * (model_shards if gathered else 1))
    while t % g:
        g -= 1
    tg = t // g
    capacity = _capacity(tg, top_k, n_experts, capacity_factor)
    rows = n_experts * capacity + 1

    sels, auxs, bufs = [], [], []
    for xl in x.view(g, tg, d):
        sel, aux = _route_group(xl, p["router"], top_k=top_k,
                                capacity=capacity, n_experts=n_experts)
        sels.append(sel)
        auxs.append(aux)
        bufs.append(_dispatch_group(xl, sel[0], sel[1], rows=rows))
    he = torch.stack(bufs)[:, :n_experts * capacity].view(
        g, n_experts, capacity, d)

    up = torch.matmul(he, p["w_up"])                          # [g, E, C, f]
    gate = F.silu(torch.matmul(he, p["w_gate"]))
    down = torch.matmul(up * gate, p["w_down"])               # [g, E, C, d]

    down_flat = torch.cat(
        [down.reshape(g, n_experts * capacity, d),
         torch.zeros(g, 1, d, dtype=down.dtype, device=down.device)],
        dim=1)                                                # drop row
    out = torch.stack([_combine_group(df, s, tg)
                       for df, s in zip(down_flat, sels)])
    return out.reshape(t, d), torch.stack(auxs).mean()
