"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) + sLSTM (scalar
memory, sequential loop over time with exponential gating).

mLSTM is linear attention with per-step scalar forget/input gates:

    C_t = f_t C_{t-1} + i_t v_t k_t^T        (matrix state  [dv, dk])
    n_t = f_t n_{t-1} + i_t k_t              (normalizer    [dk])
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)

Training and prefill use the same chunked decomposition as SSD (ssm.py):
intra-chunk masked [Q, Q] products + the carried state.  The normalizer
rides along as an extra value column, so the state is ``[hd + 1, hd]``
per head, fp32.  Gates: f = sigmoid(f~), i = exp(min(i~, 8)), the
reference's bounded gates.  The chunk products take their operands in the
activations' dtype and sum in fp32, with the result kept in fp32 (the
reference's ``preferred_element_type``): the operands are upcast exactly,
then multiplied in fp32.  As in ssm.py the intra-chunk decay is
exponentiated only where ``s <= t``.

sLSTM keeps per-head recurrent weights and exponential gating with the
running-max stabilizer (initial ``m = -1e30``), a Python loop over time:
the reference scans it with ``lax.scan`` and no kernel.  The bounds are
``torch.maximum``/``minimum`` against a scalar, not ``clamp``: at a tie
they split the gradient as JAX does.

On a mesh each rank runs the mLSTM on its slice of every head's key dim
over ``"model"``, not on a share of the heads: xlstm-1.3b's 4 heads do not
divide a model axis of 16, its key dim does, and the decode state is
stored on that dim (:func:`mlstm_on_mesh`).  The sLSTM runs whole on each
rank's batch rows (:func:`slstm_on_mesh`: a split of its recurrence would
cost a collective a time step).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Shard

from repro_torch.nn import param as pm
from repro_torch.nn.local import Local
from repro_torch.nn.ssm import _chunk


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A scalar for ``torch.maximum``/``minimum``: unlike ``clamp``, they
    split the gradient at a tie, as ``jnp.maximum`` does (sLSTM's
    normalizer is exactly 1 after its first step)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


#: mLSTM's sharding (the reference's): w_qkv column-parallel, w_down
#: row-parallel
MLSTM_SPECS = {"w_up": pm.P(None, "model"), "w_qkv": pm.P(None, "model"),
               "w_gates": pm.P("model", None), "gate_bias": pm.P(None),
               "w_down": pm.P("model", None)}


def init_mlstm(gen: torch.Generator, d_model: int, n_heads: int, dtype, *,
               proj_factor: int = 2):
    """Returns (params, meta)."""
    d_inner = proj_factor * d_model
    hd = d_inner // n_heads
    dev = gen.device
    params = pm.frozen_dict(
        w_up=pm.normal(gen, (d_model, 2 * d_inner), d_model ** -0.5, dtype),
        w_qkv=pm.normal(gen, (d_inner, 3 * d_inner), d_inner ** -0.5, dtype),
        w_gates=pm.normal(gen, (d_inner, 2 * n_heads), d_inner ** -0.5,
                          torch.float32),
        gate_bias=torch.cat([torch.zeros(n_heads, device=dev),     # i~
                             3.0 * torch.ones(n_heads, device=dev)]),  # f~
        w_down=pm.normal(gen, (d_inner, d_model), d_inner ** -0.5, dtype))
    meta = dict(d_inner=d_inner, n_heads=n_heads, head_dim=hd)
    return params, meta


def mlstm(x: torch.Tensor, p: nn.ParameterDict, meta: dict, *,
          chunk: int = 256, state: torch.Tensor | None = None):
    """x [B,S,d]; ``state`` (decode, S = 1): C [B,H,hd+1,hd].  Returns
    (y [B,S,d], C after the last token)."""
    di = meta["d_inner"]
    up = x @ p["w_up"]
    xi, z = up[..., :di], up[..., di:]
    qkv = xi @ p["w_qkv"]
    # fp32 gate weights: bf16 activations meet them in fp32, as JAX promotes
    wide = torch.promote_types(xi.dtype, p["w_gates"].dtype)
    gates = xi.to(wide) @ p["w_gates"].to(wide) + p["gate_bias"]
    y, C = _mlstm_core(qkv, gates, meta, chunk=chunk, state=state)
    return (y * F.silu(z)) @ p["w_down"], C


def mlstm_on_mesh(x, p: nn.ParameterDict, meta: dict, *, chunk: int = 256,
                  state=None):
    """:func:`mlstm` with ``x`` a DTensor: each rank runs it on its rows
    and its slice of every head's key dim ``n`` (the whole key dim where
    the model axis does not divide it).

    The key dim and not the heads: xlstm-1.3b's 4 heads do not divide a
    model axis of 16, its head dim of 1,024 does, and the decode state
    ``C [B, H, hd+1, hd]`` is stored on that dim (``decode.cache_specs``,
    the reference's), so the state never moves between ticks.  Then ``q``
    and ``k`` hold the rank's key columns, ``v`` (with the normalizer's
    ones column) stays whole, ``q . k`` and ``C q`` are partial sums, and
    a chunk's ``h = scores v + (C q) exp(L)`` is summed over the ranks
    once (linear in both); the state's update ``v k^T`` is local.  Past
    that sum the arithmetic is :func:`mlstm`'s.  The gates
    (``w_gates`` row-parallel) and ``w_down`` (row-parallel, on the rank's
    channels of ``y``) are partial products summed over the ranks."""
    loc = Local(x, meta["head_dim"])
    nh, hd, di = meta["n_heads"], meta["head_dim"], meta["d_inner"]
    k0, k1 = loc.part_range(hd)
    c0, c1 = loc.part_range(di)
    dev = x.device
    keys = (torch.arange(nh, device=dev)[:, None] * hd
            + torch.arange(k0, k1, device=dev)).reshape(-1)
    values = torch.arange(2 * di, 3 * di, device=dev)
    up = loc.rows(x) @ loc.whole(p["w_up"])[:, torch.cat([
        torch.arange(di, device=dev), torch.arange(di + c0, di + c1,
                                                   device=dev)])]
    xi, z = up[..., :di], up[..., di:]
    qkv = xi @ loc.whole(p["w_qkv"])[:, torch.cat([keys, di + keys, values])]
    w_gates = loc.chunk(p["w_gates"], 0)
    wide = torch.promote_types(xi.dtype, w_gates.dtype)
    gates = (loc.reduce(xi[..., c0:c1].to(wide) @ w_gates.to(wide))
             + loc.whole(p["gate_bias"]))
    y, C = _mlstm_core(qkv, gates, meta, chunk=chunk,
                       state=loc.rows(state, Shard(3)), reduce=loc.reduce)
    out = (y[..., c0:c1] * F.silu(z)) @ loc.chunk(p["w_down"], 0)
    return loc.out(out, summed=True), loc.out(C, on_split=Shard(3))


def _mlstm_core(qkv: torch.Tensor, gates: torch.Tensor, meta: dict, *,
                chunk: int, state: torch.Tensor | None, reduce=None):
    """The recurrence from the projections: ``qkv`` [B, S, H*n (q), H*n
    (k), d_inner (v)] with ``n`` the key columns held (``head_dim``
    unless the key dim is split), ``gates`` [B, S, 2H].  ``reduce`` sums
    a partial ``h`` over the key dim's ranks.  Returns (y [B, S, d_inner],
    C [B, H, hd+1, n])."""
    b, s, _ = qkv.shape
    nh, hd, di = meta["n_heads"], meta["head_dim"], meta["d_inner"]
    hk = (qkv.shape[-1] - di) // (2 * nh)
    q = qkv[..., :nh * hk].reshape(b, s, nh, hk)
    k = qkv[..., nh * hk: 2 * nh * hk].reshape(b, s, nh, hk) * (hd ** -0.5)
    v = qkv[..., 2 * nh * hk:].reshape(b, s, nh, hd)
    i_g = torch.exp(torch.minimum(gates[..., :nh].float(), _const(8.0, gates)))
    log_f = F.logsigmoid(gates[..., nh:].float())          # [B,S,H]

    # the normalizer rides in the state as a ones column of v
    v_aug = torch.cat([v, torch.ones(b, s, nh, 1, dtype=v.dtype,
                                     device=v.device)], dim=-1)

    if state is not None:  # decode: one recurrence step
        dec = torch.exp(log_f)[:, 0, :, None, None]
        upd = torch.einsum("bh,bhp,bhn->bhpn", i_g[:, 0], v_aug[:, 0].float(),
                           k[:, 0].float())
        C = dec * state + upd
        hq = torch.einsum("bhpn,bhn->bhp", C, q[:, 0].float())
        if reduce is not None:
            hq = reduce(hq)
        y, n_dot = hq[..., :hd], hq[..., hd]
        y = y / torch.maximum(n_dot.abs(), _const(1.0, n_dot))[..., None]
        return y.reshape(b, 1, di).to(qkv.dtype), C

    qn = _chunk(s, chunk)
    tri = torch.ones(qn, qn, dtype=torch.bool, device=qkv.device).tril()

    def rc(t):  # [B, Q, H, *] -> [B, H, Q, *]
        return t.transpose(1, 2)

    C = torch.zeros(b, nh, hd + 1, hk, dtype=torch.float32, device=qkv.device)
    ys = []
    for c0 in range(0, s, qn):
        sl = slice(c0, c0 + qn)
        qq, kk, vv = (rc(t[:, sl]) for t in (q, k, v_aug))  # [B,H,Q,*]
        ii, lf = rc(i_g[:, sl]), rc(log_f[:, sl])             # [B,H,Q]
        Lq = torch.cumsum(lf, dim=2)                           # [B,H,Q] fp32
        qk = torch.matmul(qq.float(), kk.float().transpose(-1, -2))
        ldiff = Lq[..., :, None] - Lq[..., None, :]            # [B,H,t,s]
        m = torch.exp(ldiff.masked_fill(~tri, float("-inf")))
        scores = qk * m * ii[:, :, None, :]                    # i_s weight
        h = torch.matmul(scores.to(vv.dtype).float(), vv.float())
        h = h + torch.matmul(qq.float(), C.to(qq.dtype).float()
                             .transpose(-1, -2)) * torch.exp(Lq)[..., None]
        if reduce is not None:
            h = reduce(h)
        last = Lq[..., -1:]
        w_s = torch.exp(last - Lq) * ii                        # [B,H,Q]
        C = (torch.exp(last[..., 0])[:, :, None, None] * C
             + torch.matmul((vv * w_s[..., None].to(vv.dtype)).float()
                            .transpose(-1, -2), kk.float()))
        y, n_dot = h[..., :hd], h[..., hd]
        y = y / torch.maximum(n_dot.abs(), _const(1.0, n_dot))[..., None]
        ys.append(y.to(qkv.dtype))                             # [B,H,Q,P]
    return torch.cat(ys, dim=2).transpose(1, 2).reshape(b, s, di), C


def init_mlstm_state(b: int, meta: dict, device=None) -> torch.Tensor:
    return torch.zeros(b, meta["n_heads"], meta["head_dim"] + 1,
                       meta["head_dim"], dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


#: sLSTM's sharding (the reference's)
SLSTM_SPECS = {"w_x": pm.P(None, "model"), "r_h": pm.P(None, None, "model"),
               "bias": pm.P(None), "w_out": pm.P("model", None)}


def init_slstm(gen: torch.Generator, d_model: int, n_heads: int, dtype):
    """Returns (params, meta)."""
    hd = d_model // n_heads
    params = pm.frozen_dict(
        w_x=pm.normal(gen, (d_model, 4 * d_model), d_model ** -0.5, dtype),
        r_h=pm.normal(gen, (n_heads, hd, 4 * hd), hd ** -0.5, dtype),
        bias=torch.zeros(4 * d_model, dtype=torch.float32, device=gen.device),
        w_out=pm.normal(gen, (d_model, d_model), d_model ** -0.5, dtype))
    return params, dict(n_heads=n_heads, head_dim=hd)


def slstm(x: torch.Tensor, p: nn.ParameterDict, meta: dict, *, state=None):
    """x [B,S,d].  state: (c, n, h, m) each [B,H,hd] fp32.  Returns
    (y [B,S,d], state after the last token)."""
    b, s, d = x.shape
    nh, hd = meta["n_heads"], meta["head_dim"]
    xz = x @ p["w_x"] + p["bias"].to(x.dtype)              # [B,S,4d]
    xz = xz.reshape(b, s, 4, nh, hd)

    if state is None:
        zeros = torch.zeros(b, nh, hd, dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros, torch.full_like(zeros, -1e30))
    c, n, h, m = state
    hs = []
    for t in range(s):
        rec = torch.einsum("bhi,hij->bhj", h.to(x.dtype), p["r_h"])
        rec = rec.reshape(b, nh, 4, hd).transpose(1, 2)    # [B,4,H,hd]
        pre = (xz[:, t] + rec).float()                     # [B,4,H,hd]
        z_t = torch.tanh(pre[:, 0])
        i_t, f_t = pre[:, 1], pre[:, 2]
        o_t = torch.sigmoid(pre[:, 3])
        m_new = torch.maximum(f_t + m, i_t)                # stabilizer
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(f_t + m - m_new)
        c = f_p * c + i_p * z_t
        n = f_p * n + i_p
        h = o_t * c / torch.maximum(n, _const(1.0, n))
        m = m_new
        hs.append(h.to(x.dtype))
    y = torch.stack(hs, dim=1).reshape(b, s, d)            # [B,S,d]
    return y @ p["w_out"], (c, n, h, m)


def slstm_on_mesh(x, p: nn.ParameterDict, meta: dict, *, state=None):
    """:func:`slstm` with ``x`` a DTensor: its time loop needs each head's
    whole ``h`` at every step, and the reference's column-parallel
    ``r_h`` would cost a collective a step, so each rank runs the whole
    mixer, its weights gathered, on its batch rows, dealt over
    ``"model"`` too where they divide.  The state comes back on those
    rows."""
    loc = Local(x, rows_over_model=True)
    y, new = slstm(loc.rows(x), {k: loc.whole(w) for k, w in p.items()},
                   meta, state=state and tuple(loc.rows(t) for t in state))
    return loc.out(y), tuple(loc.out(t) for t in new)
