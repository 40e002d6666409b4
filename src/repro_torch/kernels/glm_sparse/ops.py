"""Public wrapper for the ELL sparse GLM gradient.

``cuda`` runs ``csrc/glm_sparse.cu``.  :func:`variant` picks the kernel
from ``(d, K, R)`` alone:

* ``"smem"`` (``ell_grad_smem_kernel`` and ``ell_grad_reduce_kernel``) where
  at least :data:`SMEM_MIN_WARPS` warps' copies of the gradient fit a
  block's shared memory (d up to 29,024): persistent blocks, each warp
  adding its rows into its own copy, the block's copies added in warp
  order into one partial row, and a second launch that sums the partials
  in a fixed order, so every call gives the same bits (:func:`smem_plan`
  sizes the grid and the lanes a row);
* ``"hot"`` (``ell_grad_hot_kernel`` and ``ell_grad_hot_sum_kernel``) for
  every wider model with rows of up to :data:`HOT_MAX_K` entries (rcv1,
  news): one pass over the data, a warp a row holding its values and
  nonzero indices in registers from the margin to the scatter, the
  gradient in global memory (L2) under ``RED.ADD.F32`` except its
  :data:`HOT` most frequent features (:func:`hot_features`), which each
  block adds into shared memory and a second launch sums in a fixed order
  (:func:`hot_plan` sizes the grid);
* ``"atomic"`` (``ell_grad_kernel``, the first port) for what the hot
  kernel does not take (longer rows): a warp per row reading it twice,
  scattering with global atomics into a zeroed gradient.

``torch-reference`` runs ref.py.  Replicas are the grid's second axis.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common, tune
from repro_torch.kernels.glm_sparse import ref as R

#: warps of a smem block at most (one copy of the gradient each)
SMEM_MAX_WARPS = 8
#: fewest warps' copies a smem block may hold; a wider model goes "hot"
SMEM_MIN_WARPS = 2
#: persistent smem blocks a SM at most (the kernel's register budget)
SMEM_BLOCKS_PER_SM = 4
#: lanes a row may have in the smem kernel (its template G)
SMEM_LANES = (4, 8, 16, 32)
#: threads a SM holds (Hopper)
_SM_THREADS = 2048
#: shared memory a SM holds, and what each block reserves of it (Hopper)
_SM_SMEM, _BLOCK_RESERVED = 233_472, 1024

_P, _I = ctypes.c_void_p, ctypes.c_int


def smem_bytes(d: int, warps: int) -> int:
    """Shared memory of a smem block: a copy of the gradient and a 32-float
    scratch a warp."""
    return 4 * warps * (common.padded(d, 4) + 32)


def smem_warps(d: int) -> int:
    """Warps of a smem block at width ``d``: as many copies as fit, at most
    SMEM_MAX_WARPS."""
    return min(SMEM_MAX_WARPS, common.MAX_SMEM_BYTES // smem_bytes(d, 1))


def smem_lanes(k: int) -> int:
    """Lanes of a row in the smem kernel: the G of SMEM_LANES that leaves
    the fewest padded slots in a row's passes (G * ceil(K / G)), the wider
    on a tie (w8a's K = 69: 8 lanes, 72 slots, measured faster than 4 lanes
    with the same slots and than 16 or 32: tools/grad_plan_sweep.py)."""
    return min(SMEM_LANES, key=lambda g: (g * -(-k // g), -g))


@functools.lru_cache(maxsize=256)
def smem_plan(d: int, k: int, n_rep: int, n: int, sms: int,
              lanes: int | None = None) -> tuple[int, int, int, int]:
    """The smem kernel's ``(G, warps, per_block, blocks)`` for R = ``n_rep``
    replicas of ``n`` rows of K entries on ``sms`` SMs: G lanes a row
    (``lanes``, else :func:`smem_lanes`), ``warps`` warps a block, and a
    replica's rows in ``blocks`` blocks of ``per_block`` consecutive rows;
    up to SMEM_BLOCKS_PER_SM blocks a SM (fewer where shared memory or
    threads run out) over all replicas, and no block with less than one
    step of its warps' rows."""
    lanes, warps = lanes or smem_lanes(k), smem_warps(d)
    per_sm = min(SMEM_BLOCKS_PER_SM, _SM_THREADS // (32 * warps),
                 _SM_SMEM // (smem_bytes(d, warps) + _BLOCK_RESERVED))
    rows_a_step = warps * (32 // lanes)
    blocks = max(1, min(per_sm * sms // n_rep, -(-n // rows_a_step)))
    per_block = -(-n // blocks)
    return lanes, warps, per_block, -(-n // per_block)


#: warps of a hot-kernel block (a warp a row; one block a SM)
HOT_WARPS = 32
#: row entries a lane of the hot kernel holds in registers at most (its
#: template E: 4, 8 or 16)
HOT_ENTRIES = (4, 8, 16)
#: chunks of 32 x 8 entries past the registers a lane marks, a bit each
HOT_MARKED_CHUNKS = 64
#: longest row the hot kernel takes (16,896 entries)
HOT_MAX_K = 32 * (HOT_ENTRIES[-1] + 8 * HOT_MARKED_CHUNKS)
#: features the hot kernel adds in each block's shared memory: the most
#: frequent of the operand's indices (``tools/wide_sweep.py`` times 1 to
#: 57,344: 4,096 was as fast as any at rcv1's and news's shapes, and
#: zeroes and writes back the least)
HOT = 4_096


def variant(d: int, k: int, n_rep: int) -> str:
    """The kernel that runs ``(d, K, R)``: ``"smem"`` where SMEM_MIN_WARPS
    copies of the gradient fit a block, else ``"hot"`` for rows of up to
    HOT_MAX_K entries, else ``"atomic"``.  Each takes any replica count."""
    del n_rep  # every variant takes any replica count
    if smem_warps(d) >= SMEM_MIN_WARPS:
        return "smem"
    return "hot" if k <= HOT_MAX_K else "atomic"


def hot_entries(k: int) -> int:
    """Row entries a lane of the hot kernel holds in registers: the
    smallest of HOT_ENTRIES that covers a row in one warp, else the largest
    (the rest read in chunks)."""
    return next((e for e in HOT_ENTRIES if 32 * e >= k), HOT_ENTRIES[-1])


def hot_plan(d: int, k: int, n_rep: int, n: int,
             sms: int) -> tuple[int, int, int]:
    """The hot kernel's ``(hot, blocks, per_block)`` for R = ``n_rep``
    replicas of ``n`` rows of K entries on ``sms`` SMs: ``hot`` features
    (HOT, at most d) in each block's shared memory; a replica's rows in
    ``blocks`` blocks of ``per_block`` consecutive rows, one block a SM (a
    block of 32 warps takes the register file), a replica taking its share
    of the SMs, no more blocks than give each warp a row.  ``(0, 0, 0)``
    past HOT_MAX_K."""
    if k > HOT_MAX_K:
        return 0, 0, 0
    blocks = max(1, min(max(1, sms // n_rep), -(-n // HOT_WARPS)))
    per_block = -(-n // blocks)
    return min(HOT, d), -(-n // per_block), per_block


#: hot_features' results by operand: (storage pointer, shape, version
#: counter, d, hot) -> (hot_list, slot); the last few operands
_HOT_MEMO: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
_HOT_KEEP = 8


def hot_features(indices: torch.Tensor, d: int,
                 hot: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``hot`` most frequent features of an ELL operand's indices (the
    padding's index 0 counted too) as ``(hot_list [hot], slot [d])``,
    ``slot[j]`` j's place in the list or -1, int32 on the operand's device.
    Counted once an operand: kept by its storage, shape and version counter
    (which any in-place write bumps), for the last few operands.  Any such
    pair gives the same gradient (it only says which adds stay in shared
    memory), so a stale one could cost time, never a result."""
    key = (indices.data_ptr(), tuple(indices.shape), indices._version, d, hot)
    if key in _HOT_MEMO:
        return _HOT_MEMO[key]
    counts = torch.bincount(indices.reshape(-1).long(), minlength=d)
    hot_list = torch.topk(counts, hot, sorted=False).indices
    slot = torch.full((d,), -1, dtype=torch.int32, device=indices.device)
    slot[hot_list] = torch.arange(hot, dtype=torch.int32,
                                  device=indices.device)
    if len(_HOT_MEMO) >= _HOT_KEEP:
        del _HOT_MEMO[next(iter(_HOT_MEMO))]
    _HOT_MEMO[key] = (hot_list.to(torch.int32), slot)
    return _HOT_MEMO[key]


@common.register_kernel("glm_sparse", common.CUDA)
def _glm_sparse_cuda(task, W, values, indices, y, *, lanes=None):
    n_rep, n, k = values.shape
    d = W.shape[1]
    values, y, W = (common.cuda_operand(t) for t in (values, y, W))
    indices = common.cuda_operand(indices, torch.int32)
    ptrs = (values.data_ptr(), indices.data_ptr(), y.data_ptr(), W.data_ptr())
    with common.on_device(values):
        if variant(d, k, n_rep) == "smem":
            if lanes is not None and lanes not in SMEM_LANES:
                raise ValueError(f"glm_sparse: lanes must be one of "
                                 f"{SMEM_LANES}, got {lanes}")
            plan = smem_plan(d, k, n_rep, n,
                             common.sm_count(values.device), lanes)
            # one allocation: the gradient, then the blocks' partial rows
            buf = torch.empty(n_rep * (1 + plan[3]) * d, dtype=torch.float32,
                              device=values.device)
            G, partial = buf[:n_rep * d].view(n_rep, d), buf[n_rep * d:]
            fn = _build.function("glm_sparse", "ell_glm_grad_smem", _P, _P,
                                 _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _P)
            code = fn(*ptrs, partial.data_ptr(), G.data_ptr(), n_rep, n, k,
                      d, common.task_code(task), *plan,
                      common.stream(values))
        elif variant(d, k, n_rep) == "hot":
            plan = hot_plan(d, k, n_rep, n, common.sm_count(values.device))
            hot, blocks = plan[0], plan[1]
            G = torch.zeros((n_rep, d), dtype=torch.float32,
                            device=values.device)
            hot_list, slot = hot_features(indices, d, hot)
            hot_out = torch.empty(n_rep * blocks * hot, dtype=torch.float32,
                                  device=values.device)
            fn = _build.function("glm_sparse", "ell_glm_grad_hot", _P, _P,
                                 _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _P)
            code = fn(*ptrs, G.data_ptr(), slot.data_ptr(),
                      hot_list.data_ptr(), hot_out.data_ptr(), hot, n_rep, n,
                      k, d, common.task_code(task), *plan[1:],
                      common.stream(values))
        else:
            G = torch.zeros((n_rep, d), dtype=torch.float32,
                            device=values.device)
            fn = _build.function("glm_sparse", "ell_glm_grad", _P, _P, _P,
                                 _P, _P, _I, _I, _I, _I, _I, _P)
            code = fn(*ptrs, G.data_ptr(), n_rep, n, k, d,
                      common.task_code(task), common.stream(values))
    _build.check("glm_sparse", code)
    common.count_launch("glm_sparse")
    return G


@common.register_kernel("glm_sparse", common.TORCH_REFERENCE)
def _glm_sparse_reference(task, W, values, indices, y, *, lanes=None):
    del lanes  # the kernel's tiling
    return R.ell_glm_grad_ref(task, W, values, indices, y)


def ell_glm_grad(
    task: str,
    w: torch.Tensor,        # [d]     or [R, d]
    values: torch.Tensor,   # [N, K]  or [R, N, K]
    indices: torch.Tensor,  # [N, K]  or [R, N, K]  int32
    y: torch.Tensor,        # [N]     or [R, N]
    *,
    lanes: int | None = None,
    backend: str | None = None,
) -> torch.Tensor:
    """ELL sparse sum gradient; returns fp32 in w's shape.

    ``lanes`` sets the lanes a row of the smem kernel (one of
    SMEM_LANES); None runs the tuner's cached pick for this call
    (:mod:`repro_torch.kernels.tune`), else the plan's.  The hot and
    atomic kernels have no lanes to set."""
    single = w.dim() == 1
    args = (w[None], values[None], indices[None], y[None]) if single \
        else (w, values, indices, y)
    W, v, i, yr = args
    n_rep, n, _ = v.shape
    if W.shape[0] != n_rep or i.shape != v.shape or yr.shape != (n_rep, n) \
            or n < 1:
        raise ValueError(
            f"glm_sparse shapes: w {tuple(w.shape)}, values "
            f"{tuple(values.shape)}, indices {tuple(indices.shape)}, y "
            f"{tuple(y.shape)}")
    d, k = W.shape[1], v.shape[2]
    common.check_indices("glm_sparse", indices, d)
    if lanes is None:
        backend = common.resolve_backend("glm_sparse", v.device, backend)
        key = (v.dtype, n_rep, n, k, d)
        cfg = tune.known("glm_sparse", backend, key)
        if cfg is None:
            cfg = tune.consult(
                "glm_sparse", backend,
                lambda: {"dtype": common.dtype_name(v), "sparse": True,
                         "n": n, "d": d, "k": k, "replicas": n_rep},
                lambda **c: common.dispatch("glm_sparse", v.device, task,
                                            *args, backend=backend, **c),
                key=key)
        lanes = cfg.get("lanes")
    out = common.dispatch("glm_sparse", v.device, task, *args, lanes=lanes,
                          backend=backend)
    return out[0] if single else out
