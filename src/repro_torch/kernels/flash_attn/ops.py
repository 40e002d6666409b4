"""Public wrapper for blocked (flash) attention, GQA-aware.

``cuda`` runs ``csrc/flash_attn.cu``: one launch per call, the kv head's
query heads sharing every K/V row a block reads, keys no row of a block can
see never loaded.  It takes any ``1 <= Sq <= Sk`` (decode calls it at
``Sq = 1`` over a cache prefix, read in place), and any ``Sq`` past ``Sk``
for a call with no mask (cross-attention: ``causal=False``, no window,
where every query sees every key), bf16 or fp32, head dims
that are multiples of 8 up to 128.  :func:`variant` picks the kernel from
the dtype, the queries, the rows a kv head serves (``Sq * Hq / Hkv``) and
the head dim alone:

* ``"wgmma"`` (``flash_attn_wgmma_kernel``): bf16 at the head dims of
  WGMMA_HEAD_DIMS with at least WGMMA_MIN_QUERIES queries, which is
  prefill, training and the cross call.  Hopper's warpgroup products
  (``wgmma``) fed by TMA: a block is one query head's 128 queries
  (WGMMA_TILES), a producer warpgroup loads K/V tiles into a 3-stage
  mbarrier ring and two consumer warpgroups of 64 rows take turns at the
  tensor cores; S = QK^T from shared memory, P split into bf16 hi + lo
  register operands of P.V, so P stays fp32-grade as in ``"mma"``;
* ``"mma"`` (``flash_attn_mma_kernel``): bf16 with at least 16 rows that
  ``"wgmma"`` does not take (other head dims, shorter query chunks).  QK^T
  and P.V on the tensor cores (``mma.sync`` m16n8k16, fp32 accumulators),
  P kept fp32-grade as a bf16 hi + lo pair, as the Pallas kernel keeps P
  in fp32;
* ``"decode"`` (``flash_attn_decode_kernel``): bf16 with fewer than 16 rows,
  which is decode.  The keys are split into chunks (:func:`decode_plan`) so
  that up to two blocks run on each SM of an H100 however few (batch, kv
  head) pairs there are; each chunk's softmax state goes to scratch, and
  the last block of a kv head merges the chunks in order.  fp32 on the CUDA
  cores;
* ``"simt_tiled"`` (``flash_attn_tiled_kernel``): fp32 operands, whose
  1e-5 tolerance bf16 products cannot meet, with at least TILED_MIN_QUERIES
  queries.  Register-tiled on the CUDA cores, the fp32 backward's dQ pass
  with two products: a block is one query head's 64 queries
  (FWD_TILED_TILES), 64-key K/V tiles double-buffered by ``cp.async``,
  4 x 4 micro-tiles of S a thread, P through shared memory into O += P.V;
* ``"simt"`` (``flash_attn_kernel``, the first port, fp32 on the CUDA
  cores): fp32 with fewer queries (decode, short chunks).

``torch-reference`` runs ref.py.  The flavor follows the tensors' device.
Prefill's tiles are constants of the kernels; decode's key splits are a
launch argument the tuner may set (``splits``).

Plain tensors with no grad to track (serving, prefill, decode) go
straight to the family's dispatch, behind the tuner's consult.  The rest
go through the operator ``torch.ops.repro_torch.flash_attn``
(``torch.library.custom_op``), so that the tensors the kernel sees are
plain ones:

* inputs that require grad (under grad mode): the operator, asked for it
  (``with_lse``), returns the output, each row's log-sum-exp
  (``[B, Hq, Sq]`` fp32, base 2) and, for bf16, the output's rounding
  residual (``out + out_lo`` is the fp32 output to 16 bits; fp32 gives an
  empty ``[B, Hq, Sq, 0]``), all written by the forward kernel (the bf16
  decode variant writes no statistics, so such a call runs ``"mma"``;
  ``"wgmma"`` and ``"mma"`` write the same ones), and
  saves q, k, v and the three.  Its gradient is
  ``torch.ops.repro_torch.flash_attn_bwd``, which dispatches the family
  ``"flash_attn_bwd"`` on the device: ``cuda`` runs
  ``csrc/flash_attn_bwd.cu`` (a dQ pass, then a dK/dV pass, no atomics;
  :func:`bwd_variant` picks the kernels from the dtype and head dim),
  ``torch-reference`` ``ref.attention_bwd_ref``, plain PyTorch that
  recomputes the scores a query chunk at a time.  The TPU kernel has no
  backward; the reference differentiates its XLA ``chunked_attention``,
  one chunk at a time.  Such a call consults no tuner;
* fake tensors (``FakeTensorMode``, the dry run): the operators' fake
  implementations give the output's shape, and ``FlopCounterMode`` counts
  4 (forward) and 10 (backward) operations a head dim of every visible
  (query, key) pair, as ``roofline.visible_pairs`` counts them;
* ``DTensor`` operands (a device mesh): DTensor's sharding rule runs each
  operator on the local shards: batch sharded, or heads sharded where
  every split of the mesh keeps a kv head's query heads on one rank, else
  replicated.  Inputs sharded on the sequence (``seq_shard``, decode caches
  on ``"kvseq"``) are redistributed to one of those before the call.

A DTensor or a fake tensor that reached the ctypes call would hand the
kernel a pointer to nothing: ``_flash_attn_cuda`` raises instead.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, common, tune
from repro_torch.kernels.flash_attn import ref as R
from repro_torch.roofline.kernels import visible_pairs

#: operands the ctypes call cannot take: their data is elsewhere or nowhere
_NOT_PLAIN = (DTensor, FakeTensor)

#: head dims the kernel takes: multiples of HEAD_DIM_MULTIPLE up to MAX_HEAD_DIM
MAX_HEAD_DIM = 128
HEAD_DIM_MULTIPLE = 8
DTYPES = (torch.float32, torch.bfloat16)

#: rows an MMA block's warp fills (the m of mma.sync's m16n8k16)
MMA_MIN_ROWS = 16
#: the C entry point's code for each variant (``"decode"`` has its own)
VARIANTS = ("simt", "mma", "decode", "wgmma", "simt_tiled")

#: blocks a decode call aims for: two on each of an H100's 132 SMs
DECODE_TARGET_BLOCKS = 2 * 132
#: keys a decode block's four warps take in one round (32 each); a chunk
#: is a multiple of it
DECODE_CHUNK_MULTIPLE = 128
#: rows a decode block serves; more rows go to further row groups
DECODE_MAX_ROWS = 8

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _I, _I, _F, _I,
         _I, _P)
_DECODE_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _I, _I,
                _F, _I, _I, _P)
_BWD_ARGS = (_P,) * 12 + (_I,) * 8 + (_F, _I, _P)

#: the backward's C entry point's code for each variant
BWD_VARIANTS = ("mma", "wgmma", "simt_tiled")
#: bf16 head dims the ``"wgmma"`` kernels take; ``"mma"`` keeps the rest
WGMMA_HEAD_DIMS = (64, 80, 96, 112, 128)
#: the fewest queries a forward call runs ``"wgmma"`` at: its block is one
#: query head's 128 queries, so a shorter chunk leaves most of it idle where
#: ``"mma"`` packs the kv head's query heads into its rows.  The Sq from
#: which on ``"wgmma"`` was no slower than ``"mma"`` at every longer chunk
#: of a same-call sweep at hd 80, rep 4 over 900 keys on an H100
#: (``chip_smoke.py --attn-fwd``)
WGMMA_MIN_QUERIES = 128
#: the forward ``"wgmma"`` kernel's tiles (csrc/flash_attn.cu): queries a
#: block serves (one query head's), keys it stages at a time
WGMMA_TILES = {"q_rows": 128, "k_tile": 64}
#: the fewest queries an fp32 call runs ``"simt_tiled"`` at: its block is
#: one query head's 64 queries, so a decode call leaves all but one of its
#: rows idle where ``"simt"`` packs the kv head's query heads into its
#: rows.  The Sq from which on ``"simt_tiled"`` was no slower than
#: ``"simt"`` at every longer chunk of a same-call sweep at hd 80, rep 4
#: over 1,024 keys on an H100 (``chip_smoke.py --attn-fwd``: Sq 1, 16,
#: 64, 128, 256, 1,024; ``"simt"`` won at Sq 1 only)
TILED_MIN_QUERIES = 16
#: the forward ``"simt_tiled"`` kernel's tiles (csrc/flash_attn.cu): queries
#: a block serves (one query head's), keys it stages at a time
FWD_TILED_TILES = {"q_rows": 64, "k_tile": 64}
#: the backward's tiles (csrc/flash_attn_bwd.cu), by variant: query rows a
#: dQ block serves, keys it stages at a time, keys a dK/dV block owns,
#: queries a dK/dV block stages at a time
BWD_TILES = {"mma": {"q_rows": 64, "k_tile": 64, "keys": 64, "q_tile": 32},
             "wgmma": {"q_rows": 128, "k_tile": 64, "keys": 128,
                       "q_tile": 64},
             "simt_tiled": {"q_rows": 64, "k_tile": 64, "keys": 64,
                            "q_tile": 64}}


def variant(dtype: torch.dtype, sq: int, rep: int, hd: int) -> str:
    """The kernel that runs a call of ``sq`` queries, ``rep`` query heads a
    kv head and head dim ``hd``: for bf16 operands ``"wgmma"`` at the head
    dims of WGMMA_HEAD_DIMS with at least WGMMA_MIN_QUERIES queries, else
    ``"mma"`` when a kv head has at least MMA_MIN_ROWS rows (``sq * rep``),
    else ``"decode"``; for fp32 ``"simt_tiled"`` with at least
    TILED_MIN_QUERIES queries, else ``"simt"``."""
    if dtype != torch.bfloat16:
        return "simt_tiled" if sq >= TILED_MIN_QUERIES else "simt"
    if hd in WGMMA_HEAD_DIMS and sq >= WGMMA_MIN_QUERIES:
        return "wgmma"
    return "mma" if sq * rep >= MMA_MIN_ROWS else "decode"


def call_variant(dtype: torch.dtype, sq: int, rep: int, hd: int,
                 lse: bool) -> str:
    """The kernel a call runs: :func:`variant`'s pick, except that a call
    asked for the statistics (``lse``: the training path's forward) never
    runs ``"decode"``, which writes none, but ``"mma"``, which takes any
    rows."""
    kind = variant(dtype, sq, rep, hd)
    return "mma" if lse and kind == "decode" else kind


def fwd_tiled_smem(hd: int) -> int:
    """Bytes of shared memory a ``"simt_tiled"`` forward block takes at head
    dim ``hd`` (csrc/flash_attn.cu:tiled_smem): Q's tile and two stages of K
    and V, rows of ``hd + 4`` floats, and the P tile, rows of 68."""
    rows = FWD_TILED_TILES["q_rows"]
    return 4 * (5 * rows * (hd + 4) + rows * (FWD_TILED_TILES["k_tile"] + 4))


def bwd_variant(dtype: torch.dtype, hd: int) -> str:
    """The backward's kernels for operands of ``dtype`` and head dim ``hd``:
    for bf16 ``"wgmma"`` (warpgroup products fed by TMA, Hopper's tensor
    cores at full rate) at the head dims of WGMMA_HEAD_DIMS, ``"mma"``
    (``mma.sync``) at the others; ``"simt_tiled"`` (fp32, register-tiled on
    the CUDA cores) for fp32.  The first design, ``"mma"``, walks its keys
    twice for the softmax statistics; the other two read the forward's."""
    if dtype != torch.bfloat16:
        return "simt_tiled"
    return "wgmma" if hd in WGMMA_HEAD_DIMS else "mma"


def bwd_k_range(q_tile: int, sq: int, sk: int, causal: bool,
                window: int | None, rows: int = 64) -> tuple[int, int]:
    """The keys ``[begin, end)`` a dQ block (and a ``"wgmma"`` forward
    block) walks: every key some query of its tile of ``rows`` rows
    (queries ``[q_tile * rows, ...)``) can see, queries end-aligned on the
    keys (the forward's range)."""
    off = sk - sq
    i_hi = min((q_tile + 1) * rows, sq) - 1
    end = min(sk, i_hi + off + 1) if causal else sk
    begin = max(0, q_tile * rows + off - window + 1) if window else 0
    return begin, end


def bwd_q_range(k_tile: int, sq: int, sk: int, causal: bool,
                window: int | None, keys: int = 64,
                q_tile: int = 32) -> tuple[int, int]:
    """The query tiles ``[first, stop)`` (of ``q_tile`` queries) a dK/dV
    block walks for each query head of its kv head: every tile with a
    query that can see one of its keys ``[k_tile * keys, ...)``."""
    off = sk - sq
    j_lo, j_hi = k_tile * keys, min((k_tile + 1) * keys, sk) - 1
    i_lo = max(0, j_lo - off) if causal else 0
    i_hi = min(sq - 1, j_hi + window - 1 - off) if window else sq - 1
    first = i_lo // q_tile
    return first, (i_hi // q_tile + 1 if i_hi >= i_lo else first)


def decode_rows(rows: int) -> tuple[int, int]:
    """A decode call's rows (``Sq * rep``, under 16) as ``(rm, groups)``:
    the rows a block serves, a power of two up to DECODE_MAX_ROWS, and the
    row groups of that many (the kernel's template parameter and the
    grid's third axis)."""
    rm = 1
    while rm < min(rows, DECODE_MAX_ROWS):
        rm *= 2
    return rm, -(-rows // rm)


def decode_plan(b: int, hkv: int, sk: int, groups: int = 1,
                splits: int | None = None) -> tuple[int, int]:
    """How a decode call splits its keys: ``(splits, chunk)``.

    ``splits`` blocks per (batch, kv head, row group), where the caller
    does not set them: DECODE_TARGET_BLOCKS
    in all where there are fewer pairs than that, but no more than the
    chunks of DECODE_CHUNK_MULTIPLE keys the cache fills, so the grid stops
    growing with the cache once it holds ``splits`` such chunks (1,024 keys
    at B=4 on danube's 8 kv heads) and a short cache launches no empty
    blocks; ``chunk`` keys each, a multiple of DECODE_CHUNK_MULTIPLE, so
    that chunk ``i`` holds keys ``[i * chunk, (i + 1) * chunk)`` and every
    key lies in exactly one.  A chunk past the last key holds none, and its
    block returns at once."""
    if splits is None:
        splits = max(1, min(DECODE_TARGET_BLOCKS // (b * hkv * groups),
                            -(-sk // DECODE_CHUNK_MULTIPLE)))
    return splits, common.padded(-(-sk // splits), DECODE_CHUNK_MULTIPLE)


def _kv_operand(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``t`` [B, Hkv, Sk, hd] as the kernel reads it, with its head stride:
    rows of hd contiguous and heads evenly spaced, no closer than a head's
    rows (a prefix ``[..., :n, :]`` of a contiguous cache qualifies as it
    is; TMA's tensor maps take no overlapping heads), 16-byte aligned;
    anything else is copied contiguous first."""
    _, h, sk, hd = t.shape
    s = t.stride()
    if not (s[3] == 1 and s[2] == hd and s[0] == h * s[1]
            and s[1] >= sk * hd
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
def _flash_attn_cuda(q, k, v, *, causal, window, splits=None, lse=False):
    if any(isinstance(t, _NOT_PLAIN) for t in (q, k, v)):
        raise TypeError("flash_attn: the CUDA kernel takes plain tensors; a "
                        "DTensor or fake tensor reaches it only through "
                        "torch.ops.repro_torch.flash_attn")
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if b * hkv > 65_535:
        raise ValueError(f"flash_attn: B * Hkv = {b * hkv} exceeds the "
                         f"kernel's grid limit of 65,535")
    q = _aligned(q)
    k, k_stride = _kv_operand(k)
    v, v_stride = _kv_operand(v)
    if k_stride != v_stride:
        k, v = k.contiguous(), v.contiguous()
        k_stride = k.stride(1)
    out = torch.empty_like(q)
    kind = call_variant(q.dtype, sq, hq // hkv, hd, lse)
    stats = lo = None
    if lse:
        stats = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
        lo = (torch.empty_like(out) if q.dtype == torch.bfloat16
              else _no_out_lo(q))
    stream = common.stream(q)
    with common.on_device(q):
        if kind == "decode":
            code = _decode(q, k, v, out, b, hq, hkv, sq, sk, hd, k_stride,
                           causal, window, splits, stream)
        else:
            code = _build.function("flash_attn", "flash_attn", *_ARGS)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if stats is None else stats.data_ptr(),
                lo.data_ptr() if lo is not None and lo.numel() else None, b,
                hq, hkv, sq, sk, hd, k_stride, int(causal), window or 0,
                hd ** -0.5,
                int(q.dtype == torch.bfloat16), VARIANTS.index(kind), stream)
    _build.check("flash_attn", code)
    common.count_launch("flash_attn")
    common.count_launch(f"flash_attn_{kind}")
    return out if stats is None else (out, stats, lo)


def _decode(q, k, v, out, b, hq, hkv, sq, sk, hd, k_stride, causal, window,
            splits, stream) -> int:
    """Launch the decode kernel with its split plan and scratch."""
    rm, groups = decode_rows(sq * (hq // hkv))
    if splits is not None and not 1 <= splits <= DECODE_TARGET_BLOCKS:
        raise ValueError(f"flash_attn: decode splits must lie in [1, "
                         f"{DECODE_TARGET_BLOCKS}], got {splits}")
    splits, chunk = decode_plan(b, hkv, sk, groups, splits)
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
def _flash_attn_reference(q, k, v, *, causal, window, splits=None, lse=False):
    del splits  # the kernel's tiling
    return R.attention_ref(q, k, v, causal=causal, window=window,
                           with_lse=lse)


@common.register_kernel("flash_attn_bwd", common.CUDA)
def _flash_attn_bwd_cuda(q, k, v, do, out, lse, out_lo, *, causal, window):
    if any(isinstance(t, _NOT_PLAIN) for t in (q, k, v, do, out, lse, out_lo)):
        raise TypeError("flash_attn_bwd: the CUDA kernel takes plain tensors; "
                        "a DTensor or fake tensor reaches it only through "
                        "torch.ops.repro_torch.flash_attn_bwd")
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if b * hq > 65_535:
        raise ValueError(f"flash_attn_bwd: B * Hq = {b * hq} exceeds the "
                         f"kernel's grid limit of 65,535")
    kind = bwd_variant(q.dtype, hd)
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or out.shape != q.shape or out.dtype != q.dtype \
            or (kind == "wgmma" and (out_lo.shape != q.shape
                                     or out_lo.dtype != q.dtype)):
        raise ValueError(f"flash_attn_bwd: out {tuple(out.shape)} "
                         f"{out.dtype}, lse {tuple(lse.shape)} {lse.dtype} "
                         f"and out_lo {tuple(out_lo.shape)} {out_lo.dtype} "
                         f"are not the forward's for q {tuple(q.shape)}")
    q, k, v, do, out, lse = (_aligned(t) for t in (q, k, v, do, out, lse))
    lo = _aligned(out_lo) if kind == "wgmma" else None
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    # the first design makes its own statistics (never over the forward's)
    stats = lse if kind in ("wgmma", "simt_tiled") else torch.empty_like(dsum)
    # "simt_tiled" sums a kv head's query heads from per-head partials
    part = (torch.empty(2, b, hq, sk, hd, dtype=torch.float32,
                        device=q.device)
            if kind == "simt_tiled" and hq > hkv else None)
    with common.on_device(q):
        code = _build.function("flash_attn_bwd", "flash_attn_bwd", *_BWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lo is None else lo.data_ptr(), do.data_ptr(),
            stats.data_ptr(), dsum.data_ptr(),
            None if part is None else part.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, sk, hd,
            int(causal), window or 0, hd ** -0.5, BWD_VARIANTS.index(kind),
            common.stream(q))
    _build.check("flash_attn_bwd", code)
    common.count_launch("flash_attn_bwd")
    return dq, dk, dv


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the backward reads it."""
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
    return t


@common.register_kernel("flash_attn_bwd", common.TORCH_REFERENCE)
def _flash_attn_bwd_reference(q, k, v, do, out, lse, out_lo, *, causal,
                              window):
    del out, lse, out_lo  # the plain backward recomputes the softmax
    return R.attention_bwd_ref(q, k, v, do, causal=causal, window=window)


@torch.library.custom_op("repro_torch::flash_attn", mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int | None, splits: int | None,
                  backend: str | None, with_lse: bool
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out, lse, out_lo)``: the family's dispatch on plain tensors (the
    kernel on ``cuda``, ``ref.attention_ref`` on the CPU; ``backend``: the
    flavor the tuner's pick was made for, else the device's) with each
    row's log-sum-exp and the bf16 output's rounding residual for the
    backward, or, without ``with_lse`` (a call with no gradient to take:
    decode, no-grad mesh calls), empty ``[B, Hq, 0]`` and
    ``[B, Hq, Sq, 0]`` in their place and the kernel the plain dispatch
    runs."""
    if with_lse:
        return common.dispatch("flash_attn", q.device, q, k, v,
                               causal=causal, window=window, splits=splits,
                               backend=backend, lse=True)
    out = common.dispatch("flash_attn", q.device, q, k, v, causal=causal,
                          window=window, splits=splits, backend=backend)
    return out, _no_lse(q), _no_out_lo(q)


def _no_lse(q: torch.Tensor) -> torch.Tensor:
    return q.new_empty(q.shape[0], q.shape[1], 0, dtype=torch.float32)


def _no_out_lo(q: torch.Tensor) -> torch.Tensor:
    return q.new_empty(*q.shape[:3], 0)


@_attention_op.register_fake
def _(q, k, v, causal, window, splits, backend, with_lse):
    # contiguous, as the kernel's outputs
    if not with_lse:
        return q.new_empty(q.shape), _no_lse(q), _no_out_lo(q)
    return (q.new_empty(q.shape), q.new_empty(q.shape[:3],
                                              dtype=torch.float32),
            q.new_empty(q.shape) if q.dtype == torch.bfloat16
            else _no_out_lo(q))


@torch.library.custom_op("repro_torch::flash_attn_bwd", mutates_args=())
def _attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                      out_lo: torch.Tensor, causal: bool, window: int | None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: the family ``"flash_attn_bwd"``'s dispatch on
    plain tensors (the kernel on ``cuda``, ``ref.attention_bwd_ref`` on
    the CPU), given the forward's output, log-sum-exp and rounding
    residual."""
    return common.dispatch("flash_attn_bwd", q.device, q, k, v, do, out, lse,
                           out_lo, causal=causal, window=window)


@_attention_bwd_op.register_fake
def _(q, k, v, do, out, lse, out_lo, causal, window):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, _, _, _ = inputs
    out, lse, out_lo = output
    ctx.mark_non_differentiable(lse, out_lo)
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(q, k, v, out, lse, out_lo)
    ctx.causal, ctx.window = causal, window


def _backward(ctx, do, _, __):
    q, k, v, out, lse, out_lo = ctx.saved_tensors
    dq, dk, dv = _attention_bwd_op(q, k, v, do, out, lse, out_lo, ctx.causal,
                                   ctx.window)
    return dq, dk, dv, None, None, None, None, None


_attention_op.register_autograd(_backward, setup_context=_setup_context)


def _pairs(q_shape, k_shape, causal, window) -> int:
    """Visible (query, key) pairs of a call, over its batch and heads."""
    b, hq, sq, _ = q_shape
    return b * hq * visible_pairs(sq, k_shape[2], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attn)
def _attention_flops(q_shape, k_shape, v_shape, causal, window, splits,
                     backend, *args, **kwargs) -> int:
    """QK^T and P.V: 2 products of 2 operations a head dim and pair."""
    return 4 * q_shape[3] * _pairs(q_shape, k_shape, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attn_bwd)
def _attention_bwd_flops(q_shape, k_shape, v_shape, do_shape, o_shape,
                         lse_shape, lo_shape, causal, window, *args,
                         **kwargs) -> int:
    """QK^T again, dO.V^T, P^T.dO, dS.K and dS^T.Q: 5 products."""
    return 10 * q_shape[3] * _pairs(q_shape, k_shape, causal, window)


def _shardings(k, tensors: int, scalars: int, outputs: int):
    """Placements, one mesh dim at a time, for an operator over ``tensors``
    attention operands ``[B, H, S, ...]`` then ``scalars`` other arguments:
    all replicated; batch sharded; heads sharded where ``Hkv`` divides by
    the whole mesh, so that any split of the heads keeps a kv head's query
    heads (a GQA group) on one rank."""
    def rule(p):
        return [p] * outputs, [p] * tensors + [None] * scalars

    out = [rule(Replicate()), rule(Shard(0))]
    if k.tensor_meta.shape[1] % math.prod(k.mesh.shape) == 0:
        out.append(rule(Shard(1)))
    return out


@register_sharding(torch.ops.repro_torch.flash_attn.default)
def _attention_sharding(q, k, v, causal, window, splits, backend, with_lse):
    return _shardings(k, tensors=3, scalars=5, outputs=3)


@register_sharding(torch.ops.repro_torch.flash_attn_bwd.default)
def _attention_bwd_sharding(q, k, v, do, out, lse, out_lo, causal, window):
    return _shardings(k, tensors=7, scalars=2, outputs=3)


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Sq, hd]
    k: torch.Tensor,  # [B, Hkv, Sk, hd]
    v: torch.Tensor,  # [B, Hkv, Sk, hd]
    *,
    causal: bool = True,
    window: int | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """Attention of every query over the keys it sees; returns
    ``[B, Hq, Sq, hd]`` in ``q``'s dtype (fp32 inside).

    Queries end-align with keys (query ``i`` at position ``i + Sk - Sq``);
    ``causal`` hides later keys, ``window`` keys ``window`` or more
    positions back.  Query head ``h`` reads kv head ``h // (Hq // Hkv)``.
    Differentiable (the backward kernel on ``cuda``, the plain
    ``ref.attention_bwd_ref`` on the CPU): where
    an input requires grad under grad mode the call goes through the
    operator and consults no tuner, as DTensor and fake operands do (their
    sharding rule and fake implementation: module docstring).  Plain
    tensors with no grad call the dispatch directly.

    ``splits`` sets the blocks a decode call splits each kv head's keys
    over; None runs the tuner's cached pick for this call
    (:mod:`repro_torch.kernels.tune`), else :func:`decode_plan`'s.  The
    tensor-core and fp32 kernels have no splits to set.
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
    if sq < 1 or sk < 1 or (sq > sk and (causal or window is not None)):
        raise ValueError(f"flash_attn: needs 1 <= Sq <= Sk (any Sq >= 1 "
                         f"when causal=False without a window), got Sq={sq}, "
                         f"Sk={sk}, causal={causal}, window={window}")
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
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if grad or any(isinstance(t, _NOT_PLAIN) for t in (q, k, v)):
        return _attention_op(q, k, v, causal, window, splits, None, grad)[0]
    backend = None
    if splits is None:
        splits, backend = _tuned_splits(q, k, v, causal, window)
    return common.dispatch("flash_attn", q.device, q, k, v, causal=causal,
                           window=window, splits=splits, backend=backend)


def _tuned_splits(q, k, v, causal, window) -> tuple[int | None, str]:
    """The tuner's cached pick of ``splits`` for this call (None: the
    plan's), and the flavor it was picked for."""
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    backend = common.resolve_backend("flash_attn", q.device)
    key = (q.dtype, b, hq, hkv, sq, sk, hd)
    cfg = tune.known("flash_attn", backend, key)
    if cfg is None:
        cfg = tune.consult(
            "flash_attn", backend,
            lambda: {"dtype": common.dtype_name(q), "batch": b,
                     "heads_q": hq, "heads_kv": hkv, "seq_q": sq,
                     "seq_k": sk, "head_dim": hd},
            lambda **c: common.dispatch("flash_attn", q.device, q, k, v,
                                        causal=causal, window=window,
                                        backend=backend, **c), key=key)
    return cfg.get("splits"), backend
