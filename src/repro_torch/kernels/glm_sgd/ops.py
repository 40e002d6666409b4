"""Public wrapper for the fused dense mini-batch SGD epoch.

``cuda`` runs ``csrc/glm_sgd.cu``: one launch per epoch, one block per
replica.  :func:`variant` picks the kernel from ``(d, micro_batch)`` alone:

* ``"warp"`` (``glm_sgd_warp_kernel``) for the paper's dense widths, d up to
  :data:`WARP_MAX_D` with a ring of at least two micro-batch tiles in shared
  memory: one warp carries the chain of dependent updates with the model in
  its registers, while the block's other warps prefetch the tiles.  The
  chain is the algorithm's, so this kernel shortens each update;
* ``"smem"`` (``glm_sgd_kernel``, the first port) for every other shape the
  wrapper takes: the model in shared memory, ``d + micro_batch`` floats up to
  227 KB; a wider model raises ``ValueError`` naming the limit.

``torch-reference`` runs ref.py.  All take any ``n`` (a ragged tail is one
final smaller batch) and update in fp32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.glm_sgd import ref as R

#: micro-batch when the caller does not pin one
DEFAULT_MICRO_BATCH = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


#: widest model the warp kernel holds in registers (32 values a lane)
WARP_MAX_D = 1024
#: most stages the warp kernel's ring holds ahead of the chain
WARP_MAX_STAGES = 16
#: rows a stage aims to hold: the chain waits and releases once a stage
WARP_STAGE_ROWS = 32


def smem_bytes(d: int, micro_batch: int) -> int:
    """Shared memory of one ``"smem"`` block: the model and the batch's
    pulls."""
    return 4 * (d + micro_batch)


def warp_columns(d: int) -> int:
    """Model values a lane of the warp kernel holds: ceil(d / 32) rounded
    up to a power of two (the kernel's template parameter C)."""
    c = 1
    while 32 * c < d:
        c *= 2
    return c


def warp_smem_bytes(d: int, micro_batch: int, stages: int, group: int) -> int:
    """Shared memory of one ``"warp"`` block (csrc/glm_sgd.cu lays it out
    the same way): two mbarriers a stage, the pulls of a batch, and
    ``stages`` stages of ``group * micro_batch`` rows of X as they lie in
    memory (after up to 3 floats of alignment, with ``32 * C`` floats of
    slack) and their labels, each rounded to 16 bytes."""
    rows = group * micro_batch
    stage = (common.padded(rows * d + 3, 4) + 32 * warp_columns(d)
             + common.padded(rows, 4))
    return 16 * stages + 4 * common.padded(micro_batch, 4) + 4 * stages * stage


def warp_plan(d: int, micro_batch: int) -> tuple[int, int]:
    """The warp kernel's ring as ``(stages, group)`` (``common.ring_plan``:
    stages of about WARP_STAGE_ROWS rows, up to WARP_MAX_STAGES; ``(0, 0)``
    where two single-batch stages do not fit)."""
    return common.ring_plan(
        lambda stages, group: warp_smem_bytes(d, micro_batch, stages, group),
        micro_batch, WARP_MAX_STAGES, WARP_STAGE_ROWS)


def variant(d: int, micro_batch: int) -> str:
    """The kernel that runs ``(d, micro_batch)``: ``"warp"`` up to
    WARP_MAX_D where a two-stage ring fits, else ``"smem"``; raises
    ``ValueError`` where neither fits a block's shared memory."""
    if d <= WARP_MAX_D and warp_plan(d, micro_batch)[0]:
        return "warp"
    common.check_smem("glm_sgd", smem_bytes(d, micro_batch),
                      f"d={d} and micro_batch={micro_batch}")
    return "smem"


@common.register_kernel("glm_sgd", common.CUDA)
def _glm_sgd_cuda(task, W, X, y, *, step, micro_batch):
    n_rep, n, d = X.shape
    stages, group = warp_plan(d, micro_batch) \
        if variant(d, micro_batch) == "warp" else (0, 0)
    X, y = common.cuda_operand(X), common.cuda_operand(y)
    out = common.cuda_operand(W).clone()
    tail = n % micro_batch
    fn = _build.function("glm_sgd", "glm_sgd_epoch", _P, _P, _P, _I, _I, _I,
                         _I, _I, _F, _F, _I, _I, _P)
    with common.on_device(X):
        code = fn(X.data_ptr(), y.data_ptr(), out.data_ptr(), n_rep, n, d,
                  micro_batch, common.task_code(task), step / micro_batch,
                  step / tail if tail else 0.0, stages, group,
                  common.stream(X))
    _build.check("glm_sgd", code)
    common.count_launch("glm_sgd")
    return out


@common.register_kernel("glm_sgd", common.TORCH_REFERENCE)
def _glm_sgd_reference(task, W, X, y, *, step, micro_batch):
    return R.glm_sgd_epoch_ref(task, W, X, y, step, micro_batch)


def glm_sgd_epoch(
    task: str,
    w: torch.Tensor,   # [d]     or [R, d]
    X: torch.Tensor,   # [N, d]  or [R, N, d]
    y: torch.Tensor,   # [N]     or [R, N]
    *,
    step: float,
    micro_batch: int = DEFAULT_MICRO_BATCH,
    backend: str | None = None,
) -> torch.Tensor:
    """One mini-batch SGD epoch; returns the updated model (fp32, w's shape).

    With a replica axis every replica walks its own ``X[r]`` from ``w[r]``.
    """
    single = w.dim() == 1
    W, Xr, yr = (w[None], X[None], y[None]) if single else (w, X, y)
    n_rep, n, d = Xr.shape
    if W.shape != (n_rep, d) or yr.shape != (n_rep, n) or n < 1:
        raise ValueError(f"glm_sgd shapes: w {tuple(w.shape)}, X "
                         f"{tuple(X.shape)}, y {tuple(y.shape)}")
    if micro_batch < 1:
        raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
    out = common.dispatch("glm_sgd", Xr.device, task, W, Xr, yr, step=step,
                          micro_batch=micro_batch, backend=backend)
    return out[0] if single else out
