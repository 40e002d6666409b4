"""Public wrapper for blocked (flash) attention, GQA-aware.

``cuda`` runs ``csrc/flash_attn.cu``: one launch per call, a block per
(batch, kv head, tile of query rows), the kv head's query heads sharing
every staged K/V tile, key tiles no row of the block can see never loaded.
It takes any ``1 <= Sq <= Sk`` (decode calls it at ``Sq = 1`` over a
cache prefix), bf16 or fp32, head dims that are multiples of 8 up to 128.
:func:`variant` picks the kernel from the dtype and the rows a kv head's
block serves (``Sq * Hq / Hkv``) alone:

* ``"mma"`` (``flash_attn_mma_kernel``): bf16 with at least 16 rows, which
  is prefill and any chunk of queries.  QK^T and P.V on the tensor cores
  (``mma.sync`` m16n8k16, fp32 accumulators), P kept fp32-grade as a bf16
  hi + lo pair, as the Pallas kernel keeps P in fp32;
* ``"simt"`` (``flash_attn_kernel``, the first port, fp32 on the CUDA
  cores) for the rest: fp32 operands, whose 1e-5 tolerance bf16 products
  cannot meet, and decode (``Sq = 1``: 4 rows at danube's rep would leave
  12 of an MMA's 16 idle; at serving sizes decode is launch-bound, about
  0.013 ms of device time a call on an H100, and a split over keys for it
  is later work).

``torch-reference`` runs ref.py.  The flavor follows the tensors' device;
there are no block-size arguments (the tiles are constants of the kernels).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.flash_attn import ref as R

#: head dims the kernel takes: multiples of HEAD_DIM_MULTIPLE up to MAX_HEAD_DIM
MAX_HEAD_DIM = 128
HEAD_DIM_MULTIPLE = 8
DTYPES = (torch.float32, torch.bfloat16)

#: rows an MMA block's warp fills (the m of mma.sync's m16n8k16)
MMA_MIN_ROWS = 16
#: the C entry point's code for each variant
VARIANTS = ("simt", "mma")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def variant(dtype: torch.dtype, sq: int, rep: int) -> str:
    """The kernel that runs a call: ``"mma"`` for bf16 operands when a kv
    head's block has at least MMA_MIN_ROWS rows (``sq * rep``), else
    ``"simt"``."""
    if dtype == torch.bfloat16 and sq * rep >= MMA_MIN_ROWS:
        return "mma"
    return "simt"


def _kv_operand(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``t`` [B, Hkv, Sk, hd] as the kernel reads it, with its head stride:
    rows of hd contiguous and heads evenly spaced (a prefix ``[..., :n, :]``
    of a contiguous cache qualifies as it is), 16-byte aligned; anything
    else is copied contiguous first."""
    b, h, _, hd = t.shape
    s = t.stride()
    es = t.element_size()
    if not (s[3] == 1 and s[2] == hd and s[0] == h * s[1]
            and t.data_ptr() % 16 == 0 and (s[1] * es) % 16 == 0):
        t = t.contiguous()
        s = t.stride()
    return t, s[1]


@common.register_kernel("flash_attn", common.CUDA)
def _flash_attn_cuda(q, k, v, *, causal, window):
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if b * hkv > 65_535:
        raise ValueError(f"flash_attn: B * Hkv = {b * hkv} exceeds the "
                         f"kernel's grid limit of 65,535")
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    k, k_stride = _kv_operand(k)
    v, v_stride = _kv_operand(v)
    if k_stride != v_stride:
        k, v = k.contiguous(), v.contiguous()
        k_stride = k.stride(1)
    out = torch.empty_like(q)
    fn = _build.function("flash_attn", "flash_attn", _P, _P, _P, _P, _I, _I,
                         _I, _I, _I, _I, _L, _I, _I, _F, _I, _I, _P)
    kind = VARIANTS.index(variant(q.dtype, sq, hq // hkv))
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, hq, hkv, sq, sk, hd, k_stride, int(causal),
                  window or 0, hd ** -0.5, int(q.dtype == torch.bfloat16),
                  kind, common.stream(q))
    _build.check("flash_attn", code)
    common.count_launch("flash_attn")
    return out


@common.register_kernel("flash_attn", common.TORCH_REFERENCE)
def _flash_attn_reference(q, k, v, *, causal, window):
    return R.attention_ref(q, k, v, causal=causal, window=window)


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Sq, hd]
    k: torch.Tensor,  # [B, Hkv, Sk, hd]
    v: torch.Tensor,  # [B, Hkv, Sk, hd]
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Attention of every query over the keys it sees; returns
    ``[B, Hq, Sq, hd]`` in ``q``'s dtype (fp32 inside).

    Queries end-align with keys (query ``i`` at position ``i + Sk - Sq``);
    ``causal`` hides later keys, ``window`` keys ``window`` or more
    positions back.  Query head ``h`` reads kv head ``h // (Hq // Hkv)``.
    Forward only: the backward comes with the training path, so an input
    that requires grad under grad mode raises.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"flash_attn shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}; want [B, Hq, Sq, hd] and [B, Hkv, Sk, hd]")
    hq, sq, hd = q.shape[1:]
    hkv, sk = k.shape[1], k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attn: Hq={hq} is not a multiple of Hkv={hkv}")
    if not 1 <= sq <= sk:
        raise ValueError(f"flash_attn: needs 1 <= Sq <= Sk, got Sq={sq}, "
                         f"Sk={sk}")
    if hd % HEAD_DIM_MULTIPLE or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attn: head dim {hd} is not a multiple of "
                         f"{HEAD_DIM_MULTIPLE} up to {MAX_HEAD_DIM}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in DTYPES:
        raise ValueError(f"flash_attn: q, k, v must share one dtype of "
                         f"{DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attn: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attn: window must be >= 1, got {window}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attn has no backward yet (it comes with "
                           "the training path): call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")
    return common.dispatch("flash_attn", q.device, q, k, v, causal=causal,
                           window=window)
