"""Public wrapper for the fused sparse (ELL) mini-batch SGD epoch.

``cuda`` runs ``csrc/glm_sgd_sparse.cu``: one launch per epoch, one block
per replica, the model in shared memory, scatter by shared-memory atomics.
:func:`variant` picks the kernel from ``(d, K, micro_batch)`` alone:

* ``"warp"`` (``ell_sgd_warp_kernel``) for rows of up to :data:`WARP_MAX_K`
  entries where a ring of at least two micro-batch stages fits next to the
  model: one warp carries the chain of dependent updates (two split a batch
  of more than one row), holding a batch's values and indices in registers
  from the margin to the scatter, while the block's other warps prefetch
  the batches into the ring;
* ``"smem"`` (``ell_sgd_kernel``, the first port) for every other shape the
  wrapper takes: ``d + micro_batch`` floats up to 227 KB; a wider model
  raises ``ValueError`` naming the limit.

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

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P)


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


def variant(d: int, k: int, micro_batch: int) -> str:
    """The kernel that runs ``(d, K, micro_batch)``: ``"warp"`` for K up to
    WARP_MAX_K where a two-stage ring fits, else ``"smem"``; raises
    ``ValueError`` where neither fits a block's shared memory."""
    if k <= WARP_MAX_K and warp_plan(d, k, micro_batch)[0]:
        return "warp"
    common.check_smem("glm_sgd_sparse", smem_bytes(d, micro_batch),
                      f"a model of d={d} and micro_batch={micro_batch}")
    return "smem"


@common.register_kernel("glm_sgd_sparse", common.CUDA)
def _ell_sgd_cuda(task, W, values, indices, y, *, step, micro_batch):
    n_rep, n, k = values.shape
    d = W.shape[1]
    stages, group = warp_plan(d, k, micro_batch) \
        if variant(d, k, micro_batch) == "warp" else (0, 0)
    values, y = common.cuda_operand(values), common.cuda_operand(y)
    indices = common.cuda_operand(indices, torch.int32)
    out = common.cuda_operand(W).clone()
    tail = n % micro_batch
    fn = _build.function("glm_sgd_sparse", "ell_sgd_epoch", *_ARGS)
    with common.on_device(values):
        code = fn(values.data_ptr(), indices.data_ptr(), y.data_ptr(),
                  out.data_ptr(), n_rep, n, k, d, micro_batch,
                  common.task_code(task), step / micro_batch,
                  step / tail if tail else 0.0, stages, group,
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
