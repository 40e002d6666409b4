"""Public wrapper for the fused sparse (ELL) mini-batch SGD epoch.

``cuda`` runs ``csrc/glm_sgd_sparse.cu``: one launch per epoch, one block
per replica, the model in shared memory where it fits (scatter by
shared-memory atomics), else in global memory (global atomics).
:func:`variant` picks the kernel from ``(d, K, micro_batch)`` alone:

* ``"warp"`` (``ell_sgd_warp_kernel``) for rows of up to :data:`WARP_MAX_K`
  entries where a ring of at least two micro-batch stages fits next to the
  model: one warp carries the chain of dependent updates (two split a batch
  of more than one row), holding a batch's values and indices in registers
  from the margin to the scatter, while the block's other warps prefetch
  the batches into the ring;
* ``"smem"`` (``ell_sgd_kernel``, the first port) where ``d + micro_batch``
  floats fit a block's 227 KB of shared memory: the model there;
* ``"stream"`` (``ell_sgd_stream_kernel``) for every wider model (news, d =
  1,355,191) whose rows :func:`stream_plan` can ring: the model stays in the
  output tensor in global memory, copy warps stream the next rows through a
  shared-memory ring (and ask L2 for their model lines), 16 chain warps
  gather a row's model values with one trip to L2, sum the margin over the
  block (every warp the same pull, in a register), and scatter with global
  ``atomicAdd`` from the values in registers;
* ``"global"`` (``ell_sgd_global_kernel``) for what is left (rows past
  :data:`STREAM_MAX_K` entries): the model in global memory, each row read
  from it twice, the batch's pulls through a global scratch.

``torch-reference`` runs ref.py.  All take any ``n`` (a ragged tail is one
final smaller batch) and update in fp32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.glm_sgd_sparse import ref as R

#: micro-batch when the caller does not pin one
DEFAULT_MICRO_BATCH = 8

#: longest ELL row the warp kernel holds (16 entries a lane)
WARP_MAX_K = 512
#: a row's entries a lane of the warp kernel may hold (its template C)
WARP_COLUMNS = (1, 2, 3, 4, 6, 8, 12, 16)
#: most stages the warp kernel's ring holds ahead of the chain
WARP_MAX_STAGES = 16
#: rows a stage aims to hold: the chain waits and releases once a stage
WARP_STAGE_ROWS = 32

#: chain warps of a stream kernel block (4 more warps copy)
STREAM_CHAIN_WARPS = 16
#: longest ELL row the stream kernel holds (16 entries a chain thread)
STREAM_MAX_K = 16 * 32 * STREAM_CHAIN_WARPS
#: most stages the stream kernel's ring holds ahead of the chain
STREAM_MAX_STAGES = 8
#: most rows a fill of its ring holds
STREAM_ROWS = 32

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P)
_GLOBAL_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P)
_STREAM_ARGS = _GLOBAL_ARGS[:-1] + (_I, _I, _P)


def smem_bytes(d: int, micro_batch: int) -> int:
    """Shared memory of one ``"smem"`` block: the model and the batch's
    pulls."""
    return 4 * (d + micro_batch)


def warp_columns(k: int) -> int:
    """A row's entries a lane of the warp kernel holds: ceil(K / 32)
    rounded up to the next of WARP_COLUMNS (the kernel's template C)."""
    return next(c for c in WARP_COLUMNS if 32 * c >= k)


def warp_smem_bytes(d: int, k: int, micro_batch: int, stages: int,
                    group: int) -> int:
    """Shared memory of one ``"warp"`` block (csrc/glm_sgd_sparse.cu lays it
    out the same way): two mbarriers a stage, the pulls of a batch, the
    model, and ``stages`` stages of ``group * micro_batch`` rows: their
    values and their indices as they lie in memory (after up to 3 words of
    alignment) and their labels, each rounded to 16 bytes."""
    rows = group * micro_batch
    stage = 2 * common.padded(rows * k + 3, 4) + common.padded(rows, 4)
    return (16 * stages + 4 * common.padded(micro_batch, 4)
            + 4 * common.padded(d, 4) + 4 * stages * stage)


def warp_plan(d: int, k: int, micro_batch: int) -> tuple[int, int]:
    """The warp kernel's ring as ``(stages, group)`` (``common.ring_plan``:
    stages of about WARP_STAGE_ROWS rows, up to WARP_MAX_STAGES; ``(0, 0)``
    where two single-batch stages do not fit)."""
    return common.ring_plan(
        lambda stages, group: warp_smem_bytes(d, k, micro_batch, stages,
                                              group),
        micro_batch, WARP_MAX_STAGES, WARP_STAGE_ROWS)


def stream_smem_bytes(k: int, stages: int, rows: int) -> int:
    """Shared memory of one ``"stream"`` block (csrc/glm_sgd_sparse.cu lays
    it out the same way): two mbarriers a stage, the chain warps' partials
    of STREAM_ROWS rows, and ``stages`` stages of ``rows`` rows: their
    values and their indices, each row as it lies in memory (after up to 3
    words of alignment), and their labels."""
    row = common.padded(k + 3, 4)
    return (16 * stages + 4 * STREAM_ROWS * STREAM_CHAIN_WARPS
            + 4 * stages * (2 * rows * row + common.padded(rows, 4)))


def stream_plan(k: int, micro_batch: int) -> tuple[int, int]:
    """The stream kernel's ring as ``(stages, rows)``: fills of a whole
    batch (up to STREAM_ROWS rows) where two such stages fit, else of as
    many rows as two stages allow, a batch then streamed twice (its
    margins, then its scatter); as many stages as fit, up to
    STREAM_MAX_STAGES.  ``(0, 0)`` for rows past STREAM_MAX_K entries."""
    if k > STREAM_MAX_K:
        return 0, 0

    def fit(rows):
        for stages in range(STREAM_MAX_STAGES, 1, -1):
            if stream_smem_bytes(k, stages, rows) <= common.MAX_SMEM_BYTES:
                return stages
        return 0

    for rows in range(min(micro_batch, STREAM_ROWS), 0, -1):
        if fit(rows):
            return fit(rows), rows
    return 0, 0


def variant(d: int, k: int, micro_batch: int) -> str:
    """The kernel that runs ``(d, K, micro_batch)``: ``"warp"`` for K up to
    WARP_MAX_K where a two-stage ring fits, else ``"smem"`` where the model
    and the batch's pulls fit a block's shared memory, else ``"stream"``
    where :func:`stream_plan` fits, else ``"global"``."""
    if k <= WARP_MAX_K and warp_plan(d, k, micro_batch)[0]:
        return "warp"
    if smem_bytes(d, micro_batch) <= common.MAX_SMEM_BYTES:
        return "smem"
    if stream_plan(k, micro_batch)[0]:
        return "stream"
    return "global"


@common.register_kernel("glm_sgd_sparse", common.CUDA)
def _ell_sgd_cuda(task, W, values, indices, y, *, step, micro_batch):
    n_rep, n, k = values.shape
    d = W.shape[1]
    kind = variant(d, k, micro_batch)
    values, y = common.cuda_operand(values), common.cuda_operand(y)
    indices = common.cuda_operand(indices, torch.int32)
    out = common.cuda_operand(W).clone()
    tail = n % micro_batch
    scales = (step / micro_batch, step / tail if tail else 0.0)
    ptrs = (values.data_ptr(), indices.data_ptr(), y.data_ptr(),
            out.data_ptr())
    with common.on_device(values):
        if kind in ("stream", "global"):
            pulls = torch.empty((n_rep, micro_batch), dtype=torch.float32,
                                device=values.device)
            args = (*ptrs, pulls.data_ptr(), n_rep, n, k, d, micro_batch,
                    common.task_code(task), *scales)
            if kind == "stream":
                fn = _build.function("glm_sgd_sparse", "ell_sgd_epoch_stream",
                                     *_STREAM_ARGS)
                code = fn(*args, *stream_plan(k, micro_batch),
                          common.stream(values))
            else:
                fn = _build.function("glm_sgd_sparse", "ell_sgd_epoch_global",
                                     *_GLOBAL_ARGS)
                code = fn(*args, common.stream(values))
        else:
            stages, group = warp_plan(d, k, micro_batch) \
                if kind == "warp" else (0, 0)
            fn = _build.function("glm_sgd_sparse", "ell_sgd_epoch", *_ARGS)
            code = fn(*ptrs, n_rep, n, k, d, micro_batch,
                      common.task_code(task), *scales, stages, group,
                      common.stream(values))
    _build.check("glm_sgd_sparse", code)
    common.count_launch("glm_sgd_sparse")
    return out


@common.register_kernel("glm_sgd_sparse", common.TORCH_REFERENCE)
def _ell_sgd_reference(task, W, values, indices, y, *, step, micro_batch):
    return R.ell_sgd_epoch_ref(task, W, values, indices, y, step, micro_batch)


def ell_sgd_epoch(
    task: str,
    w: torch.Tensor,        # [d]     or [R, d]
    values: torch.Tensor,   # [N, K]  or [R, N, K]  zero-padded ELL
    indices: torch.Tensor,  # [N, K]  or [R, N, K]  int32
    y: torch.Tensor,        # [N]     or [R, N]
    *,
    step: float,
    micro_batch: int = DEFAULT_MICRO_BATCH,
    backend: str | None = None,
) -> torch.Tensor:
    """One mini-batch SGD epoch on ELL data; returns the model (fp32)."""
    single = w.dim() == 1
    args = (w[None], values[None], indices[None], y[None]) if single \
        else (w, values, indices, y)
    W, v, i, yr = args
    n_rep, n, _ = v.shape
    if W.shape[0] != n_rep or i.shape != v.shape or yr.shape != (n_rep, n) \
            or n < 1:
        raise ValueError(
            f"glm_sgd_sparse shapes: w {tuple(w.shape)}, values "
            f"{tuple(values.shape)}, indices {tuple(indices.shape)}, y "
            f"{tuple(y.shape)}")
    common.check_indices("glm_sgd_sparse", indices, W.shape[1])
    if micro_batch < 1:
        raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
    out = common.dispatch("glm_sgd_sparse", v.device, task, *args, step=step,
                          micro_batch=micro_batch, backend=backend)
    return out[0] if single else out
