"""Public wrapper for the fused ELL scoring kernel.

``cuda`` runs ``csrc/glm_score.cu``: one launch per batch, a warp (or a
sub-warp for narrow rows) per row gathering the model from global memory,
the task link applied in the same launch.  Rows are independent, so any
``N`` runs unpadded and ``d`` has no limit but device memory (news'
d=1,355,191 runs the kernel).  ``torch-reference`` runs ref.py.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.glm_score import ref as R

_P, _I = ctypes.c_void_p, ctypes.c_int


@common.register_kernel("glm_score", common.CUDA)
def _glm_score_cuda(task, w, values, indices):
    n, k = values.shape
    values, w = common.cuda_operand(values), common.cuda_operand(w)
    indices = common.cuda_operand(indices, torch.int32)
    out = torch.empty(n, dtype=torch.float32, device=values.device)
    fn = _build.function("glm_score", "glm_score", _P, _P, _P, _P, _I, _I,
                         _I, _P)
    with common.on_device(values):
        code = fn(values.data_ptr(), indices.data_ptr(), w.data_ptr(),
                  out.data_ptr(), n, k, common.task_code(task),
                  common.stream(values))
    _build.check("glm_score", code)
    common.count_launch("glm_score")
    return out


@common.register_kernel("glm_score", common.TORCH_REFERENCE)
def _glm_score_reference(task, w, values, indices):
    return R.glm_score_ref(task, w, values, indices)


def glm_score(
    task: str,
    w: torch.Tensor,        # [d]
    values: torch.Tensor,   # [N, K]  zero-padded ELL
    indices: torch.Tensor,  # [N, K]  int32
    *,
    backend: str | None = None,
) -> torch.Tensor:
    """Served scores of a padded-ELL batch; returns ``[N]`` fp32 — LR rows
    sigmoid probabilities, SVM rows raw margins (``core.glm.LINKS``)."""
    if w.dim() != 1 or values.dim() != 2 or indices.shape != values.shape \
            or values.shape[0] < 1:
        raise ValueError(
            f"glm_score shapes: w {tuple(w.shape)}, values "
            f"{tuple(values.shape)}, indices {tuple(indices.shape)}")
    common.task_code(task)
    common.check_indices("glm_score", indices, w.shape[0])
    return common.dispatch("glm_score", values.device, task, w, values,
                           indices, backend=backend)
