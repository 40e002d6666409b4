"""Public wrapper for the fused dense mini-batch SGD epoch.

``cuda`` runs ``csrc/glm_sgd.cu``: one launch per epoch, one block per
replica, the model in shared memory.  ``torch-reference`` runs ref.py.
Both take any ``n`` (a ragged tail is one final smaller batch) and update
in fp32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.glm_sgd import ref as R

#: micro-batch when the caller does not pin one
DEFAULT_MICRO_BATCH = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def smem_bytes(d: int, micro_batch: int) -> int:
    """Shared memory of one block: the model and the batch's pulls."""
    return 4 * (d + micro_batch)


@common.register_kernel("glm_sgd", common.CUDA)
def _glm_sgd_cuda(task, W, X, y, *, step, micro_batch):
    n_rep, n, d = X.shape
    common.check_smem("glm_sgd", smem_bytes(d, micro_batch),
                      f"d={d} and micro_batch={micro_batch}")
    X, y = common.cuda_operand(X), common.cuda_operand(y)
    out = common.cuda_operand(W).clone()
    tail = n % micro_batch
    fn = _build.function("glm_sgd", "glm_sgd_epoch", _P, _P, _P, _I, _I, _I,
                         _I, _I, _F, _F, _P)
    with torch.cuda.device(X.device):
        code = fn(X.data_ptr(), y.data_ptr(), out.data_ptr(), n_rep, n, d,
                  micro_batch, common.task_code(task), step / micro_batch,
                  step / tail if tail else 0.0, common.stream(X))
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
