"""Mamba2 (SSD) mixer: chunked-parallel training form + recurrent decode.

State-space recurrence per head (A scalar per head, shared B/C projections):

    h_t = exp(A * dt_t) * h_{t-1} + (dt_t * B_t) (x)otimes x_t
    y_t = C_t . h_t + D * x_t

Training and prefill use the SSD chunked decomposition (Dao & Gu 2024):
within a chunk of length Q the recurrence is a masked [Q, Q] product;
across chunks a loop carries the state [B, H, d_state, d_head] in fp32.
Decode runs one step of the recurrence from a given state.

The intra-chunk decay ``exp(L_t - L_s)`` is taken only where ``s <= t``:
the reference exponentiates every pair and masks after, which gives the
same values, but above the diagonal the exponent grows with the chunk
(past fp32's range at the full configs' 256) and its gradient would be
``0 * inf``.

On a mesh (:func:`mamba2_on_mesh`) each model rank runs this same mixer
on its batch rows and its ``n_heads / model`` heads, the sequence whole:
the heads' ``z``, ``x`` and ``dt`` columns of ``w_in`` and their conv
channels, with ``B`` and ``C`` (shared by every head) whole on each rank.
``w_in`` and ``conv`` store their fused columns split evenly, which does
not line up with the heads, so both are gathered (a layer at a time) and
the rank's columns taken from them; ``w_out``'s stored rows are the
heads' own, and its partial sums reduce into the residual's placement.
The decode state stays on its heads (``decode.cache_specs``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Shard

from repro_torch.nn import param as pm
from repro_torch.nn.local import Local


#: Mamba2's sharding (the reference's): the fused projection's columns
#: and the conv's channels over ``"model"``
MAMBA2_SPECS = {"w_in": pm.P(None, "model"), "conv": pm.P(None, "model"),
                "dt_bias": pm.P(None), "a_log": pm.P(None),
                "d_skip": pm.P(None), "w_out": pm.P("model", None)}


def init_mamba2(gen: torch.Generator, d_model: int, d_state: int, dtype, *,
                expand: int = 2, head_dim: int = 64, conv_width: int = 4):
    """Returns (params, meta)."""
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    dev = gen.device
    params = pm.frozen_dict(
        # fused input projection: [z, x, B, C, dt]
        w_in=pm.normal(gen, (d_model, 2 * d_inner + 2 * d_state + n_heads),
                       d_model ** -0.5, dtype),
        conv=pm.normal(gen, (conv_width, d_inner + 2 * d_state), 0.5, dtype),
        dt_bias=torch.zeros(n_heads, dtype=torch.float32, device=dev),
        a_log=torch.zeros(n_heads, dtype=torch.float32, device=dev),
        d_skip=torch.ones(n_heads, dtype=torch.float32, device=dev),
        w_out=pm.normal(gen, (d_inner, d_model), d_inner ** -0.5, dtype))
    meta = dict(d_inner=d_inner, n_heads=n_heads, head_dim=head_dim,
                d_state=d_state, conv_width=conv_width)
    return params, meta


def _split_proj(xp: torch.Tensor, d_inner: int, d_state: int):
    z = xp[..., :d_inner]
    xbc = xp[..., d_inner: 2 * d_inner + 2 * d_state]
    dt = xp[..., 2 * d_inner + 2 * d_state:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor, *, state=None):
    """Depthwise causal conv1d.  xbc [B,S,C]; conv_w [W,C].

    With ``state`` ([B, W-1, C], decode path) returns (y, new_state)."""
    w = conv_w.shape[0]
    if state is not None:
        buf = torch.cat([state, xbc], dim=1)              # [B, W-1+S, C]
        new_state = buf[:, -(w - 1):, :]
    else:
        buf = F.pad(xbc, (0, 0, w - 1, 0))
        new_state = None
    s = xbc.shape[1]
    ys = buf[:, 0:s, :] * conv_w[0]
    for i in range(1, w):
        ys = ys + buf[:, i: i + s, :] * conv_w[i]
    return F.silu(ys), new_state


def _chunk(s: int, chunk: int) -> int:
    """The largest divisor of ``s`` not above ``chunk``."""
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    return chunk


def mamba2(x: torch.Tensor, p: nn.ParameterDict, meta: dict, *,
           chunk: int = 256, state: torch.Tensor | None = None,
           conv_state: torch.Tensor | None = None):
    """x [B, S, d_model].  Returns (y [B, S, d_model], (state, conv_state)):
    decoding (``state`` given, S = 1) the stepped state and conv history,
    else the state after the last token and the last W-1 pre-conv inputs
    (prefill cache material)."""
    b, s, _ = x.shape
    di, nh, hd, ds = (meta["d_inner"], meta["n_heads"], meta["head_dim"],
                      meta["d_state"])
    z, xbc, dt = _split_proj(x @ p["w_in"], di, ds)
    decode = state is not None
    xbc_raw = xbc
    xbc, new_conv = _causal_conv(xbc, p["conv"],
                                 state=conv_state if decode else None)
    xs = xbc[..., :di].reshape(b, s, nh, hd)
    Bm = xbc[..., di: di + ds]                            # [B,S,ds]
    Cm = xbc[..., di + ds:]                               # [B,S,ds]
    dt = F.softplus(dt.float() + p["dt_bias"])            # [B,S,H]
    a = -torch.exp(p["a_log"])                            # [H] (negative)
    log_decay = a * dt                                    # [B,S,H]

    if decode:  # s == 1: one recurrence step
        dec = torch.exp(log_decay)[:, 0, :, None, None]   # [B,H,1,1]
        dbx = torch.einsum("bh,bn,bhp->bhnp", dt[:, 0], Bm[:, 0].float(),
                           xs[:, 0].float())
        new_state = dec * state + dbx
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), new_state)
        y = y + p["d_skip"][None, :, None] * xs[:, 0].float()
        y = y.reshape(b, 1, di).to(x.dtype)
        out = (y * F.silu(z)) @ p["w_out"]
        return out, (new_state, new_conv)

    # ---- chunked SSD ----
    q = _chunk(s, chunk)
    tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    h = torch.zeros(b, nh, ds, hd, dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, q):
        xq = xs[:, c0:c0 + q].float()                     # [B,Q,H,P]
        Bq = Bm[:, c0:c0 + q].float()
        Cq = Cm[:, c0:c0 + q].float()
        dtq = dt[:, c0:c0 + q]                            # [B,Q,H]
        Lq = torch.cumsum(log_decay[:, c0:c0 + q], dim=1)  # [B,Q,H]
        # intra-chunk: scores[t,s] = C_t.B_s * exp(L_t - L_s) * dt_s, s<=t
        cb = torch.einsum("btn,bsn->bts", Cq, Bq)         # [B,Q,Q]
        ldiff = Lq[:, :, None, :] - Lq[:, None, :, :]     # [B,Q,Q,H]
        m = torch.exp(ldiff.masked_fill(~tri[None, :, :, None],
                                        float("-inf")))
        scores = cb[..., None] * m * dtq[:, None, :, :]   # [B,t,s,H]
        y = torch.einsum("btsh,bshp->bthp", scores, xq)
        # inter-chunk: y += C_t . (exp(L_t) h_in)
        y = y + torch.einsum("btn,bhnp,bth->bthp", Cq, h, torch.exp(Lq))
        # state: h_out = exp(L_Q) h_in + sum_s exp(L_Q - L_s) dt_s B_s x_s
        last = Lq[:, -1:, :]                              # [B,1,H]
        w_s = torch.exp(last - Lq) * dtq                  # [B,Q,H]
        h = (torch.exp(last[:, 0, :])[:, :, None, None] * h
             + torch.einsum("bsh,bsn,bshp->bhnp", w_s, Bq, xq))
        y = y + p["d_skip"][None, None, :, None] * xq
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1).reshape(b, s, di)
    # final recurrent state + conv history -> decoding can continue from here
    conv_tail = xbc_raw[:, -(p["conv"].shape[0] - 1):, :]
    return (y * F.silu(z)) @ p["w_out"], (h, conv_tail)


def mamba2_on_mesh(x, p: nn.ParameterDict, meta: dict, *, chunk: int = 256,
                   state=None, conv_state=None):
    """:func:`mamba2` with ``x`` a DTensor: each rank runs it on its rows
    and its share of the heads (all of them where the model axis does not
    divide ``n_heads``).  Returns ``y`` partial over the heads' ranks and
    the states as DTensors: ``state`` on its heads, ``conv_state`` on the
    rows, whole."""
    loc = Local(x, meta["n_heads"])
    di, nh, ds = meta["d_inner"], meta["n_heads"], meta["d_state"]
    h0, h1 = loc.part_range(nh)
    c0, c1 = loc.part_range(di)
    dev = x.device
    chans = torch.cat([torch.arange(c0, c1, device=dev),
                       torch.arange(di, di + 2 * ds, device=dev)])
    cols = torch.cat([torch.arange(c0, c1, device=dev), di + chans,
                      torch.arange(2 * di + 2 * ds + h0, 2 * di + 2 * ds + h1,
                                   device=dev)])
    w = {"w_in": loc.whole(p["w_in"])[:, cols],
         "conv": loc.whole(p["conv"])[:, chans],
         **{k: loc.whole(p[k])[h0:h1] for k in ("dt_bias", "a_log",
                                                "d_skip")},
         "w_out": loc.chunk(p["w_out"], 0)}
    mine = dict(meta, d_inner=c1 - c0, n_heads=h1 - h0)
    decode = state is not None
    y, (h, conv) = mamba2(
        loc.rows(x), w, mine, chunk=chunk,
        state=loc.rows(state, Shard(1)) if decode else None,
        conv_state=loc.rows(conv_state)[..., chans] if decode else None)
    # the conv history: the heads' x channels over the ranks, B and C whole
    conv = torch.cat([loc.out(conv[..., :c1 - c0], on_split=Shard(2)),
                      loc.out(conv[..., c1 - c0:])], dim=2)
    return loc.out(y, summed=True), (loc.out(h, on_split=Shard(1)), conv)


def init_decode_state(b: int, meta: dict, dtype=torch.float32, device=None):
    h = torch.zeros(b, meta["n_heads"], meta["d_state"], meta["head_dim"],
                    dtype=torch.float32, device=device)
    conv = torch.zeros(b, meta["conv_width"] - 1,
                       meta["d_inner"] + 2 * meta["d_state"], dtype=dtype,
                       device=device)
    return h, conv
