"""Public wrapper for blocked (flash) attention, GQA-aware.

``cuda`` runs ``csrc/flash_attn.cu``: one launch per call, the kv head's
query heads sharing every K/V row a block reads, keys no row of a block can
see never loaded.  It takes any ``1 <= Sq <= Sk`` (decode calls it at
``Sq = 1`` over a cache prefix, read in place), bf16 or fp32, head dims
that are multiples of 8 up to 128.  :func:`variant` picks the kernel from
the dtype and the rows a kv head serves (``Sq * Hq / Hkv``) alone:

* ``"mma"`` (``flash_attn_mma_kernel``): bf16 with at least 16 rows, which
  is prefill and any chunk of queries.  QK^T and P.V on the tensor cores
  (``mma.sync`` m16n8k16, fp32 accumulators), P kept fp32-grade as a bf16
  hi + lo pair, as the Pallas kernel keeps P in fp32;
* ``"decode"`` (``flash_attn_decode_kernel``): bf16 with fewer than 16 rows,
  which is decode.  The keys are split into chunks (:func:`decode_plan`) so
  that up to two blocks run on each SM of an H100 however few (batch, kv
  head) pairs there are; each chunk's softmax state goes to scratch, and
  the last block of a kv head merges the chunks in order.  fp32 on the CUDA
  cores;
* ``"simt"`` (``flash_attn_kernel``, the first port, fp32 on the CUDA
  cores) for fp32 operands, whose 1e-5 tolerance bf16 products cannot meet.

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
#: the C entry point's code for each variant (``"decode"`` has its own)
VARIANTS = ("simt", "mma", "decode")

#: blocks a decode call aims for: two on each of an H100's 132 SMs
DECODE_TARGET_BLOCKS = 2 * 132
#: keys a decode block's four warps take in one round (32 each); a chunk
#: is a multiple of it
DECODE_CHUNK_MULTIPLE = 128
#: rows a decode block serves; more rows go to further row groups
DECODE_MAX_ROWS = 8

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _I, _I, _F, _I, _I, _P)
_DECODE_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _I, _I,
                _F, _I, _I, _P)


def variant(dtype: torch.dtype, sq: int, rep: int) -> str:
    """The kernel that runs a call: for bf16 operands ``"mma"`` when a kv
    head has at least MMA_MIN_ROWS rows (``sq * rep``), else ``"decode"``;
    ``"simt"`` for fp32."""
    if dtype != torch.bfloat16:
        return "simt"
    return "mma" if sq * rep >= MMA_MIN_ROWS else "decode"


def decode_rows(rows: int) -> tuple[int, int]:
    """A decode call's rows (``Sq * rep``, under 16) as ``(rm, groups)``:
    the rows a block serves, a power of two up to DECODE_MAX_ROWS, and the
    row groups of that many (the kernel's template parameter and the
    grid's third axis)."""
    rm = 1
    while rm < min(rows, DECODE_MAX_ROWS):
        rm *= 2
    return rm, -(-rows // rm)


def decode_plan(b: int, hkv: int, sk: int, groups: int = 1
                ) -> tuple[int, int]:
    """How a decode call splits its keys: ``(splits, chunk)``.

    ``splits`` blocks per (batch, kv head, row group): DECODE_TARGET_BLOCKS
    in all where there are fewer pairs than that, but no more than the
    chunks of DECODE_CHUNK_MULTIPLE keys the cache fills, so the grid stops
    growing with the cache once it holds ``splits`` such chunks (1,024 keys
    at B=4 on danube's 8 kv heads) and a short cache launches no empty
    blocks; ``chunk`` keys each, a multiple of DECODE_CHUNK_MULTIPLE, so
    that chunk ``i`` holds keys ``[i * chunk, (i + 1) * chunk)`` and every
    key lies in exactly one.  A chunk past the last key holds none, and its
    block returns at once."""
    splits = max(1, min(DECODE_TARGET_BLOCKS // (b * hkv * groups),
                        -(-sk // DECODE_CHUNK_MULTIPLE)))
    return splits, common.padded(-(-sk // splits), DECODE_CHUNK_MULTIPLE)


def _kv_operand(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``t`` [B, Hkv, Sk, hd] as the kernel reads it, with its head stride:
    rows of hd contiguous and heads evenly spaced (a prefix ``[..., :n, :]``
    of a contiguous cache qualifies as it is), 16-byte aligned; anything
    else is copied contiguous first."""
    b, h, _, hd = t.shape
    s = t.stride()
    if not (s[3] == 1 and s[2] == hd and s[0] == h * s[1]
            and t.data_ptr() % 16 == 0 and (s[1] * t.element_size()) % 16 == 0):
        t = t.contiguous()
        s = t.stride()
    return t, s[1]


class _Workspace:
    """A decode call's scratch on one stream: fp32 partial states, and the
    ticket counters the kernel leaves at zero, kept from call to call (the
    counters are zeroed once, when made) and grown on demand.  Calls on one
    stream run in order, so they can share it."""

    def __init__(self):
        self.part = self.tickets = None

    def get(self, dev, floats: int, tickets: int):
        if self.part is None or self.part.numel() < floats:
            self.part = torch.empty(floats, dtype=torch.float32, device=dev)
        if self.tickets is None or self.tickets.numel() < tickets:
            self.tickets = torch.zeros(tickets, dtype=torch.int32, device=dev)
        return self.part, self.tickets


#: by (device index, stream handle): the default stream is 0 on every card
_WORKSPACES: dict[tuple[int, int], _Workspace] = {}


@common.register_kernel("flash_attn", common.CUDA)
def _flash_attn_cuda(q, k, v, *, causal, window):
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if b * hkv > 65_535:
        raise ValueError(f"flash_attn: B * Hkv = {b * hkv} exceeds the "
                         f"kernel's grid limit of 65,535")
    if not q.is_contiguous() or q.data_ptr() % 16:
        q = q.contiguous()
        if q.data_ptr() % 16:
            q = q.clone()
    k, k_stride = _kv_operand(k)
    v, v_stride = _kv_operand(v)
    if k_stride != v_stride:
        k, v = k.contiguous(), v.contiguous()
        k_stride = k.stride(1)
    out = torch.empty_like(q)
    kind = variant(q.dtype, sq, hq // hkv)
    stream = common.stream(q)
    with common.on_device(q):
        if kind == "decode":
            code = _decode(q, k, v, out, b, hq, hkv, sq, sk, hd, k_stride,
                           causal, window, stream)
        else:
            code = _build.function("flash_attn", "flash_attn", *_ARGS)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                hq, hkv, sq, sk, hd, k_stride, int(causal), window or 0,
                hd ** -0.5, int(q.dtype == torch.bfloat16),
                VARIANTS.index(kind), stream)
    _build.check("flash_attn", code)
    common.count_launch("flash_attn")
    return out


def _decode(q, k, v, out, b, hq, hkv, sq, sk, hd, k_stride, causal, window,
            stream) -> int:
    """Launch the decode kernel with its split plan and scratch."""
    rm, groups = decode_rows(sq * (hq // hkv))
    splits, chunk = decode_plan(b, hkv, sk, groups)
    part = tickets = 0
    if splits > 1:
        key = (q.device.index, stream)
        ws = _WORKSPACES.get(key)
        if ws is None:
            ws = _WORKSPACES[key] = _Workspace()
        heads = b * hkv * groups
        p, t = ws.get(q.device, heads * splits * rm * (hd + 2) + 4, heads)
        part, tickets = p.data_ptr(), t.data_ptr()
    return _build.function("flash_attn", "flash_attn_decode", *_DECODE_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part,
        tickets, b, hq, hkv, sq, sk, hd, k_stride, int(causal), window or 0,
        hd ** -0.5, splits, chunk, stream)


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
