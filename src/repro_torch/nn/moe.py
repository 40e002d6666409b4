"""Mixture-of-Experts FFN: top-k routing, sort-based capacity dispatch.

Dispatch avoids the O(T*E*C) one-hot tensor: tokens are sorted by expert
id (a stable sort, as the reference's ``jnp.argsort``) and scattered into
a fixed ``[E*C + 1, d]`` buffer (C = capacity per expert, the last row
the bucket that over-capacity tokens land in), the expert products run
as batched matmuls ``[g, E, C, d] x [E, d, ff]``, and results are
combined back with the routing weights.

Tokens are split into ``groups`` that each route and drop against their
own capacity, as the reference's group-local dispatch does.  Without a
mesh the configs' one group and one model shard give one group.  On a
mesh (``shard`` from ``trainer.make_shard_fn``) the reference's sites
place the groups over the batch axes, and in the gathered strategy over
``"model"`` too; each rank routes, dispatches and combines the groups it
holds on plain local tensors (the index math has no DTensor rule;
:class:`~repro_torch.nn.local.Local` gathers the router, whose gradient
sums over the groups' ranks), and the expert products run on DTensors.
Gathered: against all-gathered experts, by design (olmoe's fit a rank).
All-to-all: the dispatch buffer moves to the expert shards and back, and
the experts are placed on their ``E / model`` shards, gathered on the
FSDP dim only, a layer at a time (their gradients reduce-scatter back
onto it), as XLA's FSDP does; left to DTensor's own choice the products
would move every group's buffer onto each rank's FSDP slice of ``d``
instead, with partial outputs for every group.  The router runs in fp32
whatever the experts' dtype.  The auxiliary load-balancing loss is
returned beside the output.

The grouped products are ``einsum``s, as the reference's, outside any
Pallas kernel.  A decode step pushes its few tokens through the full
``[E, C, d]`` buffer, so it reads every expert's weights (the
reference's capacity semantics).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.nn import param as pm
from repro_torch.nn.local import Local
from repro_torch.nn.param import NOSHARD, P


def moe_specs(fsdp: bool = False) -> dict:
    """Experts over ``"model"`` (expert parallelism); the router
    replicated."""
    fa = pm.fsdp_axes(fsdp)
    return {"router": pm.P(None, None), "w_up": pm.P("model", fa, None),
            "w_gate": pm.P("model", fa, None), "w_down": pm.P("model", None, fa)}


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

    Returns (sel = (perm_token, dest, weight, keep, order), aux): ``order``
    is the sort's permutation of the ``t * top_k`` (token, slot) pairs,
    which the combine inverts."""
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
    # each expert's first slot in the sorted order (the reference's
    # cumsum(counts) - counts; a search keeps the shape static)
    start = torch.searchsorted(sorted_ids, torch.arange(
        n_experts, device=x.device, dtype=sorted_ids.dtype))  # [E]
    pos_in_expert = (torch.arange(t * top_k, device=x.device)
                     - start[sorted_ids])
    keep = pos_in_expert < capacity
    dest = torch.where(keep, sorted_ids * capacity + pos_in_expert,
                       n_experts * capacity)                 # drop bucket
    return (token_of[order], dest, flat_w[order], keep, order), aux


def _dispatch_group(x: torch.Tensor, token_ord: torch.Tensor,
                    dest: torch.Tensor, *, rows: int) -> torch.Tensor:
    """Gather tokens in expert order and scatter them into the dispatch
    buffer.  Kept tokens' rows are unique (position in expert); every
    dropped token lands in the last row, which nothing reads."""
    buf = torch.zeros(rows, x.shape[1], dtype=x.dtype, device=x.device)
    return buf.index_copy(0, dest, x[token_ord])


def _combine_group(down_flat: torch.Tensor, sel, t: int) -> torch.Tensor:
    """down_flat [E*C+1, d] (with the drop row) back to tokens: each
    token's ``top_k`` rows gathered token-major (the inverse of the sort's
    ``order``: token ``i``'s slots at ``i * top_k ...``), weighted, and
    summed over the slot dim (a reduction in a fixed order, whose backward
    is a broadcast).  No atomics: the reference's scatter-add, ``index_add``
    on CUDA, sums in whatever order its atomics land.  So the same bits
    every call, and no more memory than the scatter-add."""
    _, dest, w_ord, keep, order = sel
    inv = torch.argsort(order)
    rows = down_flat[dest[inv]].view(t, -1, down_flat.shape[1])
    # weighted as [t, top_k, d]: the gradient flows back into the gather
    # as a view (weighting the flat rows made the view's backward copy the
    # broadcast gradient, a [t * top_k, d] block)
    w = (w_ord * keep)[inv].view(t, -1, 1).to(down_flat.dtype)
    return (rows * w).sum(1)


def _local_groups(fn, xg, *args):
    """``fn(xg, *args)`` on the groups this rank holds: plain tensors in
    and out, every output ``[g, ...]`` back on ``xg``'s placements.  ``args``
    are replicated (or plain) tensors, or lists of plain local tensors."""
    if not isinstance(xg, DTensor):
        return fn(xg, *args)
    loc = Local(xg)
    out = fn(xg.to_local(), *(loc.whole(a) if isinstance(a, DTensor)
                              else a for a in args))

    def wrap(t):
        if isinstance(t, torch.Tensor):
            return DTensor.from_local(t, xg.device_mesh, xg.placements,
                                      run_check=False)
        return t
    return tuple(wrap(t) for t in out) if isinstance(out, tuple) else wrap(out)


def moe_ffn(x: torch.Tensor, p: nn.ParameterDict, *, top_k: int,
            capacity_factor: float = 1.25, groups: int = 1,
            model_shards: int = 1, shard=NOSHARD
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T, d] flattened tokens.  Returns (out [T, d], aux_loss scalar).

    The reference's two strategies: ``gathered`` (dispatched activations
    outweigh the expert weights, which fit 1 GiB: one group a device, the
    experts all-gathered) or all-to-all (one group a batch shard, the
    dispatch buffer sent to the expert shards and back)."""
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
    group_spec = ("batch", "model") if gathered else "batch"

    xg = shard(x.reshape(g, tg, d), P(group_spec, None, None))

    def dispatch(xs, router):
        sels, auxs, bufs = [], [], []
        for xl in xs:
            sel, aux = _route_group(xl, router, top_k=top_k,
                                    capacity=capacity, n_experts=n_experts)
            sels.append(sel)
            auxs.append(aux)
            bufs.append(_dispatch_group(xl, sel[0], sel[1], rows=rows))
        he = torch.stack(bufs)[:, :n_experts * capacity].reshape(
            len(bufs), n_experts, capacity, d)
        return he, torch.stack(auxs), sels

    he, aux, sels = _local_groups(dispatch, xg, p["router"])

    if gathered:
        he = shard(he, P(group_spec, None, None, None))
        w_up = shard(p["w_up"], P(None, None, None))
        w_gate = shard(p["w_gate"], P(None, None, None))
        w_down = shard(p["w_down"], P(None, None, None))
    else:
        he = shard(he, P(group_spec, "model", None, None))
        # each rank's E / model experts, gathered on the FSDP dim alone
        w_up, w_gate, w_down = (shard(p[k], P("model", None, None))
                                for k in ("w_up", "w_gate", "w_down"))

    up = torch.einsum("gecd,edf->gecf", he, w_up)
    gate = F.silu(torch.einsum("gecd,edf->gecf", he, w_gate))
    down = torch.einsum("gecf,efd->gecd", up * gate, w_down)
    # return path: outputs live with their token-owner shards for the combine
    down = shard(down, P(group_spec, None, None, None))

    def combine(dn, sels):
        flat = torch.cat([dn.reshape(dn.shape[0], n_experts * capacity, d),
                          dn.new_zeros(dn.shape[0], 1, d)], dim=1)  # drop row
        return torch.stack([_combine_group(df, s, tg)
                            for df, s in zip(flat, sels)])

    out = _local_groups(combine, _placed_like(down, xg), sels)
    out = shard(out, P(group_spec, None, None))
    return out.reshape(t, d), aux.mean()


def _placed_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` on ``like``'s placements (the group axis where the routing
    put it), where ``like`` is a DTensor."""
    if not isinstance(like, DTensor):
        return t
    return t.redistribute(like.device_mesh, like.placements)
