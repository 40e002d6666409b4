"""Plain PyTorch versions of blocked (flash) attention and its gradient."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import common

#: query rows per pass: bounds the [B, Hq, rows, Sk] fp32 score block
QUERY_CHUNK = 512
LOG2E = math.log2(math.e)


def attention_ref(
    q: torch.Tensor,  # [B, Hq, Sq, hd]
    k: torch.Tensor,  # [B, Hkv, Sk, hd]
    v: torch.Tensor,  # [B, Hkv, Sk, hd]
    *,
    causal: bool = True,
    window: int | None = None,
    with_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked softmax attention in fp32, returned in ``q``'s dtype.

    Query head ``h`` reads kv head ``h // (Hq // Hkv)`` (the reference's
    ``jnp.repeat``, here ``repeat_interleave``).  Queries end-align with
    keys: query ``i`` sits at position ``i + Sk - Sq`` and sees key ``j``
    iff ``j <= i + Sk - Sq`` (causal) and ``i + Sk - Sq - j < window``.
    A row that sees no key gives 0, as the kernel's ``l == 0`` guard does.

    ``with_lse``: also each row's log-sum-exp ``[B, Hq, Sq]`` fp32 in base
    2, ``log2 sum_j 2^(s_j log2 e)`` of the scaled scores ``s`` (what the
    backward kernels take from the forward; +inf for a row that sees no
    key), and the output's rounding residual ``out_lo``: for bf16 the fp32
    output less ``out``, rounded to bf16, for fp32 an empty
    ``[B, Hq, Sq, 0]``."""
    common.plain_fp32(q)
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    sq, sk, hd = q.shape[2], k.shape[2], q.shape[3]
    scale = hd ** -0.5
    kj = torch.arange(sk, device=q.device)
    out, lse = [], []
    for lo in range(0, sq, QUERY_CHUNK):
        qc = q[:, :, lo:lo + QUERY_CHUNK].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * scale
        qi = torch.arange(lo, lo + qc.shape[2], device=q.device)[:, None] \
            + (sk - sq)
        mask = torch.ones(qc.shape[2], sk, dtype=torch.bool, device=q.device)
        if causal:
            mask &= qi >= kj
        if window is not None:
            mask &= qi - kj < window
        s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        out.append(o / torch.where(l == 0, 1.0, l))
        if with_lse:
            lse.append(torch.where(l == 0, torch.inf, m + torch.log(l))[..., 0]
                       * LOG2E)
    full = torch.cat(out, dim=2)
    out = full.to(q.dtype)
    if not with_lse:
        return out
    lo = ((full - out.float()).to(q.dtype) if q.dtype == torch.bfloat16
          else q.new_empty(*q.shape[:3], 0))
    return out, torch.cat(lse, dim=2), lo


def attention_bwd_ref(
    q: torch.Tensor,   # [B, Hq, Sq, hd]
    k: torch.Tensor,   # [B, Hkv, Sk, hd]
    v: torch.Tensor,   # [B, Hkv, Sk, hd]
    do: torch.Tensor,  # [B, Hq, Sq, hd]: the gradient of the output
    *,
    causal: bool = True,
    window: int | None = None,
    chunk: int = QUERY_CHUNK,
    lse: torch.Tensor | None = None,   # [B, Hq, Sq] fp32, base 2
    dsum: torch.Tensor | None = None,  # [B, Hq, Sq] fp32: rowsum(dO o O)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`attention_ref`'s output against ``do``,
    in the operands' dtype, recomputed ``chunk`` query rows at a time.

    Each chunk reads only the keys its rows can see: under a window from
    ``window - 1`` keys before its first row, under ``causal`` up to its
    last row (at most ``window + chunk`` keys, as the reference's
    ``chunked_attention`` slices them), so no ``[B, H, Sq, Sk]`` block is
    ever made.  The ``rep`` query heads of a kv head are stacked as rows
    of one product, so the products over them sum GQA's repeated heads
    back onto their kv head.  Products run in the operands' dtype
    (``torch.matmul``, fp32 accumulation, the result rounded to that
    dtype: bf16 on the tensor cores), the softmax and its gradient (the
    softmax VJP ``P * (dP - sum(P * dP))``) in fp32, and ``dk``/``dv`` sum
    the chunks in fp32: the precision of the reference's differentiated
    path.  Every row sees at least one key (the wrapper's ``Sq <= Sk`` and
    ``window >= 1`` under a mask, every key without one: cross-attention
    takes ``Sq > Sk``), so no softmax row is empty.

    Given the forward's statistics, it computes as the ``"wgmma"`` and
    ``"simt_tiled"`` kernels do: ``lse`` (:func:`attention_ref`'s, base 2)
    gives ``P = 2^(s log2 e - lse)`` in place of the softmax, and ``dsum``
    ``D = rowsum(dO o O)`` (O the fp32 output: for bf16 ``out + out_lo``)
    in place of ``rowsum(P o dP)`` in the softmax's VJP ``P o (dP - D)``."""
    with common.fp32_products(q):
        b, hq, sq, hd = q.shape
        hkv, sk = k.shape[1], k.shape[2]
        rep = hq // hkv
        scale = hd ** -0.5
        offs = sk - sq
        qg = q.reshape(b, hkv, rep, sq, hd)
        dog = do.reshape(b, hkv, rep, sq, hd)
        stats = [None if t is None else t.reshape(b, hkv, rep, sq)
                 for t in (lse, dsum)]
        dq = torch.empty(b, hkv, rep, sq, hd, dtype=q.dtype, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for lo in range(0, sq, chunk):
            hi = min(lo + chunk, sq)
            rows = rep * (hi - lo)
            start = 0 if window is None else max(0, offs + lo - window + 1)
            end = offs + hi if causal else sk
            ks, vs = k[:, :, start:end], v[:, :, start:end]
            qc = qg[:, :, :, lo:hi].reshape(b, hkv, rows, hd)
            doc = dog[:, :, :, lo:hi].reshape(b, hkv, rows, hd)
            qi = torch.arange(lo + offs, hi + offs,
                              device=q.device).repeat(rep)[:, None]
            kj = torch.arange(start, end, device=q.device)
            hidden = torch.zeros(rows, end - start, dtype=torch.bool,
                                 device=q.device)
            if causal:
                hidden |= qi < kj
            if window is not None:
                hidden |= qi - kj >= window
            lse_c, d_c = (None if t is None else
                          t[..., lo:hi].reshape(b, hkv, rows, 1)
                          for t in stats)
            s = torch.matmul(qc, ks.transpose(-1, -2)).float().mul_(scale)
            s = s.masked_fill_(hidden, float("-inf"))
            if lse_c is None:
                p = torch.softmax(s, dim=-1)
            else:
                p = torch.exp2(s.mul_(LOG2E).sub_(lse_c))
            del s
            dp = torch.matmul(doc, vs.transpose(-1, -2)).float()
            if d_c is None:
                ds = torch._softmax_backward_data(dp, p, -1, torch.float32)
            else:
                ds = dp.sub_(d_c).mul_(p)
            del dp
            dv[:, :, start:end] += torch.matmul(
                p.to(v.dtype).transpose(-1, -2), doc)
            del p
            ds = ds.mul_(scale).to(q.dtype)
            dq[:, :, :, lo:hi] = torch.matmul(ds, ks).view(b, hkv, rep,
                                                           hi - lo, hd)
            dk[:, :, start:end] += torch.matmul(ds.transpose(-1, -2), qc)
        return dq.view(q.shape), dk.to(k.dtype), dv.to(v.dtype)
