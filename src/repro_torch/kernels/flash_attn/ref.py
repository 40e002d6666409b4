"""Plain PyTorch version of blocked (flash) attention."""
from __future__ import annotations

import torch

from repro_torch.kernels import common

#: query rows per pass: bounds the [B, Hq, rows, Sk] fp32 score block
QUERY_CHUNK = 512


def attention_ref(
    q: torch.Tensor,  # [B, Hq, Sq, hd]
    k: torch.Tensor,  # [B, Hkv, Sk, hd]
    v: torch.Tensor,  # [B, Hkv, Sk, hd]
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Masked softmax attention in fp32, returned in ``q``'s dtype.

    Query head ``h`` reads kv head ``h // (Hq // Hkv)`` (the reference's
    ``jnp.repeat``, here ``repeat_interleave``).  Queries end-align with
    keys: query ``i`` sits at position ``i + Sk - Sq`` and sees key ``j``
    iff ``j <= i + Sk - Sq`` (causal) and ``i + Sk - Sq - j < window``.
    A row that sees no key gives 0, as the kernel's ``l == 0`` guard does.
    """
    common.plain_fp32(q)
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    sq, sk, hd = q.shape[2], k.shape[2], q.shape[3]
    scale = hd ** -0.5
    kj = torch.arange(sk, device=q.device)
    out = []
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
        p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        out.append(o / torch.where(l == 0, 1.0, l))
    return torch.cat(out, dim=2).to(q.dtype)
