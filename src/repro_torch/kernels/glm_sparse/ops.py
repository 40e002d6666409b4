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
* ``"atomic"`` (``ell_grad_kernel``, the first port) for every wider model
  (news): a warp per row, scattering with global atomics into a zeroed
  gradient.

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
#: fewest warps' copies a smem block may hold; a wider model goes "atomic"
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


def variant(d: int, k: int, n_rep: int) -> str:
    """The kernel that runs ``(d, K, R)``: ``"smem"`` where SMEM_MIN_WARPS
    copies of the gradient fit a block, else ``"atomic"``.  Rows of any K
    and any replica count run either."""
    del k, n_rep  # both variants take any row length and replica count
    return "smem" if smem_warps(d) >= SMEM_MIN_WARPS else "atomic"


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
    (:mod:`repro_torch.kernels.tune`), else the plan's.  The atomic kernel
    has no lanes to set."""
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
